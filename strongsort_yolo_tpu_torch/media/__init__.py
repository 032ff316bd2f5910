"""Host media layer: decode, encode, display, drawing.

Counterpart of ``strongsort_yolo_tpu/media``. Files decode and encode
through the native libav shims (``native_decoder``) or cv2 (``video``),
frames are drawn by cv2 or the native C++ shim (``annotator``, ``native``);
pixels never ride the card for overlays. :func:`media_status` says which
of them this machine has.
"""

from __future__ import annotations


def media_status() -> dict:
    """What this machine offers the app: 'cv2' (its version, or None),
    'shim' (the drawing shim: 'built in X s', 'cached' or the compiler's
    error), 'decoder' and 'encoder' ('loaded' or the loader's error,
    which names the missing library). Builds the drawing shim if it is
    not built yet."""
    from strongsort_yolo_tpu_torch.media import native, native_decoder

    try:
        import cv2

        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    if native.available():
        shim = ("cached" if native.build_seconds is None
                else f"built in {native.build_seconds:.2f} s")
    else:
        shim = f"unavailable: {native.build_error}"
    return {
        "cv2": cv2_version,
        "shim": shim,
        "decoder": native_decoder.decoder_error() or "loaded",
        "encoder": native_decoder.encoder_error() or "loaded",
    }
