"""K2: the NMS keep-mask kernel (``csrc/nms_keep.cu``) and its wrapper.

Replaces ``strongsort_yolo_tpu/ops/pallas/nms_kernel.py::pallas_nms_keep``;
the plain PyTorch version is
:func:`strongsort_yolo_tpu_torch.ops.nms._greedy_keep_fixpoint` over
:func:`strongsort_yolo_tpu_torch.ops.boxes.box_iou` (:func:`nms_keep_plain`).
"""

from __future__ import annotations

import torch

from strongsort_yolo_tpu_torch.ops.boxes import box_iou
from strongsort_yolo_tpu_torch.ops.cuda import _build

MAX_K = 512


def nms_keep_plain(
    boxes: torch.Tensor, conf: torch.Tensor, *, iou_thres: float,
    conf_thres: float,
) -> torch.Tensor:
    """The keep mask in plain PyTorch: (S, K, 4), (S, K) -> (S, K) bool."""
    from strongsort_yolo_tpu_torch.ops.nms import _greedy_keep_fixpoint

    iou = box_iou(boxes.float(), boxes.float())
    return _greedy_keep_fixpoint(iou, conf >= conf_thres, iou_thres)


def nms_keep(
    boxes: torch.Tensor, conf: torch.Tensor, *, iou_thres: float,
    conf_thres: float,
) -> torch.Tensor:
    """Greedy NMS keep mask of S frames: boxes (S, K, 4) f32 score-desc
    sorted and class-offset, conf (S, K) f32 (rows with conf < conf_thres
    are invalid) -> (S, K) bool. CPU tensors take the plain version;
    CUDA tensors launch K2 (a cluster of thread blocks per frame, K <=
    512)."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(
            boxes, conf, iou_thres=iou_thres, conf_thres=conf_thres
        )
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep: unsupported device {boxes.device}")
    s, k = conf.shape
    if (boxes.shape != (s, k, 4) or boxes.dtype != torch.float32
            or conf.dtype != torch.float32 or conf.device != boxes.device):
        raise ValueError(
            f"nms_keep wants (S, K, 4) and (S, K) float32 on one device, got "
            f"{tuple(boxes.shape)} {boxes.dtype} and {tuple(conf.shape)} "
            f"{conf.dtype}"
        )
    if k > MAX_K:
        raise ValueError(f"nms_keep: K={k} exceeds {MAX_K}")
    boxes, conf = boxes.contiguous(), conf.contiguous()
    keep = torch.empty((s, k), dtype=torch.bool, device=boxes.device)
    err = _build.lib().ssyt_nms_keep(
        boxes.data_ptr(), conf.data_ptr(), keep.data_ptr(), s, k,
        float(iou_thres), float(conf_thres),
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    nms_keep.launches += 1
    _build.check(err, "nms_keep")
    return keep


nms_keep.launches = 0
