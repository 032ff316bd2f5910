"""The benchmark's plain reference: PyTorch and NumPy with no kernel, cache
or batching trick of the program, and nothing imported from it.

- ``nn``: the conv layer every model is built of, its weight spec, an
  int8 round trip (the control's precision) and the operation counter;
- ``yolov7``, ``yolov8``: the detectors at their published widths, on
  weights given as a state dict under the program's key names;
- ``detect``: letterbox (cv2 INTER_LINEAR sampling), the decode, greedy
  class-aware NMS and the rescale to frame pixels; the head calibration;
- ``osnet``, ``crops``: the ReID net and its crops from the frame
  pyramid;
- ``lk``: the device camera-motion estimate (pyramidal Lucas-Kanade);
- ``tracker``: StrongSORT and ByteTrack / BoT-SORT written plainly, a
  stream at a time over a list of tracks, in float64, from the papers
  and the JAX package's ``track/`` as a pattern; its assignments by the
  auction the system defines, written from that definition
  (``assignment``).
"""
