"""Detector config and the tracker names the port knows.

Counterpart of ``strongsort_yolo_tpu/config.py``: ByteTrack, BoT-SORT
(with or without ReID) and StrongSORT. Tracker YAML files load through a
lazy ``yaml`` import, so the package needs PyYAML only for that.
"""

from __future__ import annotations

import dataclasses
import os

from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

TrackerConfig = ByteTrackConfig | StrongSortConfig


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Model + NMS configuration (reference ``model.overrides``: conf 0.3,
    iou 0.4, agnostic_nms False, max_det 1000)."""

    weights: str = "yolov8n"  # model name or .npz checkpoint path
    imgsz: int = 640
    conf: float = 0.3
    iou: float = 0.4
    agnostic_nms: bool = False
    max_det: int = 1000
    classes: tuple[int, ...] | None = None  # optional class filter
    half: bool = True  # bfloat16 compute
    fuse: bool = True  # fold BN into convs
    quant: str | None = None  # "int8": post-training quantization of the
    # fused conv stack (ops/quant.py: per-channel int8 weights, per-tensor
    # int8 activations, int32 sums on the tensor cores, K8); the head
    # output layers stay in the compute dtype


_BUILTIN_TRACKERS = {
    "botsort.yaml": ByteTrackConfig(tracker_type="botsort"),
    "botsort": ByteTrackConfig(tracker_type="botsort"),
    "bytetrack.yaml": ByteTrackConfig(tracker_type="bytetrack", gmc_method="none"),
    "bytetrack": ByteTrackConfig(tracker_type="bytetrack", gmc_method="none"),
    "botsort-reid.yaml": ByteTrackConfig(tracker_type="botsort", with_reid=True),
    "botsort-reid": ByteTrackConfig(tracker_type="botsort", with_reid=True),
    "strongsort.yaml": StrongSortConfig(),
    "strongsort": StrongSortConfig(),
}

_STRONGSORT_YAML_KEYS = {
    "det_thresh", "max_cosine_distance", "lambda_appearance",
    "match_thresh", "max_iou_distance", "max_age", "n_init", "ema_alpha",
    "gmc_method",
}

_TRACKER_YAML_KEYS = {
    "tracker_type", "track_high_thresh", "track_low_thresh",
    "new_track_thresh", "track_buffer", "match_thresh", "fuse_score",
    "gmc_method", "proximity_thresh", "appearance_thresh", "with_reid",
}


def load_tracker_config(name_or_path: str) -> TrackerConfig:
    """Resolve a tracker config by built-in name or YAML file path."""
    if name_or_path in _BUILTIN_TRACKERS:
        return _BUILTIN_TRACKERS[name_or_path]
    if os.path.exists(name_or_path):
        import yaml

        with open(name_or_path) as f:
            raw = yaml.safe_load(f) or {}
        if raw.get("tracker_type") == "strongsort":
            return StrongSortConfig(
                **{k: v for k, v in raw.items() if k in _STRONGSORT_YAML_KEYS}
            )
        return ByteTrackConfig(
            **{k: v for k, v in raw.items() if k in _TRACKER_YAML_KEYS}
        )
    raise ValueError(
        f"unknown tracker {name_or_path!r}; use one of "
        f"{sorted(_BUILTIN_TRACKERS)} or a YAML path"
    )
