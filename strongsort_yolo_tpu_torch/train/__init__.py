"""Training of the port's detectors: the detection loss (TAL assigner,
CIoU + BCE + DFL, the segment and pose terms) and the train step on one
device. Counterpart of ``strongsort_yolo_tpu/train``."""
