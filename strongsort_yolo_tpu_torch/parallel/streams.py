"""S streams stepped together, optionally split over a mesh's dp rows: the
port's copy of ``strongsort_yolo_tpu/parallel/streams.py``.

One weight set per device; the tracker state of each block of streams
is a TrackState with a leading stream axis on its block's device. The
blocks are those of ``Pipeline.track_batch_prepare(mesh=...)``
(``pipeline.ShardedBatchedPipeline``): streams are independent, so no
block reads another's data.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.ops.nms import Detections
from strongsort_yolo_tpu_torch.pipeline import (
    BatchedPipeline, Pipeline, ShardedBatchedPipeline, device_scope,
)
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.state import TrackOutputs, TrackState


class StreamBatch:
    """S synchronized streams at one resolution, stepped together: the
    letterbox, the detector, NMS (``det_cfg.max_det`` rows, in frame
    coordinates) and ByteTrack of every stream. ``params``: a state_dict
    of the port's model of ``model_cfg`` (``models/porting.params_from_jax``
    gives one from a JAX tree). ``mesh``: the streams split over its dp
    rows, else they run on ``device`` (default: the CUDA device)."""

    def __init__(
        self,
        params: dict[str, torch.Tensor],
        model_cfg: Any,
        det_cfg: DetectorConfig,
        tracker_cfg: ByteTrackConfig,
        num_streams: int,
        src_hw: tuple[int, int],
        *,
        track_slots: int = 128,
        mesh=None,
        device: torch.device | str | None = None,
    ):
        if mesh is not None:
            device = mesh.devices[0, 0]
        pipe = Pipeline(det_cfg, tracker_cfg, params=params,
                        model_cfg=model_cfg, track_slots=track_slots,
                        tracker_max_dets=det_cfg.max_det, device=device)
        if pipe.reid is not None or pipe.gmc_method != "none":
            raise ValueError("StreamBatch steps ByteTrack without GMC or ReID")
        self.num_streams = num_streams
        batch = pipe.track_batch_prepare(num_streams, src_hw, mesh=mesh)
        self._batch = batch
        self.blocks: list[BatchedPipeline] = (
            batch.blocks if isinstance(batch, ShardedBatchedPipeline)
            else [batch])

    @property
    def states(self) -> TrackState:
        """The S streams' tracker state (on the first block's device)."""
        return self._batch.states

    @torch.no_grad()
    def step(self, frames: np.ndarray) -> tuple[Detections, TrackOutputs]:
        """frames (S, H, W, 3) uint8 -> (dets, track outputs), both with a
        leading stream axis, on the first block's device."""
        frames = np.asarray(frames)
        if frames.shape[0] != self.num_streams:
            raise ValueError(f"{self.num_streams} streams, got {frames.shape}")
        per = self.num_streams // len(self.blocks)
        outs = []
        for k, b in enumerate(self.blocks):
            p = b.pipeline
            with device_scope(p.device), p._copies.frames(
                    frames[k * per:(k + 1) * per], b.ring) as dev:
                det = p.detect(dev)
                b.states, touts = p.associate(b.states, det)
            outs.append((det, touts))
        first = self.blocks[0].pipeline.device
        dets, touts = zip(*outs)
        return (Detections(*(torch.cat([t.to(first) for t in f])
                             for f in zip(*dets))),
                TrackOutputs(*(torch.cat([t.to(first) for t in f])
                               for f in zip(*touts))))
