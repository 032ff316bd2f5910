"""Training of the port's detectors: the detection loss (TAL assigner,
CIoU + BCE + DFL, the segment and pose terms) and the train step, on one
device or over a mesh of ranks (``parallel/ranks.py``), in float32 or
bfloat16. Counterpart of ``strongsort_yolo_tpu/train``."""
