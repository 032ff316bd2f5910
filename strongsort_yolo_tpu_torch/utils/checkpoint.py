"""Tracker state checkpoint and resume.

Counterpart of ``strongsort_yolo_tpu/utils/checkpoint.py``, which saves
the state pytree with orbax. Here a checkpoint is a directory (the app's
``{name}_ckpt``) holding ``state.pt``: a ``torch.save`` of a dict of CPU
tensors, the :class:`~strongsort_yolo_tpu_torch.track.state.TrackState`
fields of one stream, each with its leading axis of 1, plus
``last_frame``, the position of the stream (its last frame processed). Written on the card, it resumes
on the CPU and the other way round; written by the sequential loop, it
resumes in the batched one (one row of its states).
"""

from __future__ import annotations

import os

import torch

from strongsort_yolo_tpu_torch.track.state import TrackState

FILE = "state.pt"


def save_state(path: str, track_state: TrackState, frame_id: int) -> None:
    """Save one stream's state (fields of leading size 1) and its frame
    position into the directory ``path``, replacing what was there: the
    file is written beside it and renamed, so a kill mid-save leaves the
    previous checkpoint whole."""
    if track_state.frame_id.shape[0] != 1:
        raise ValueError(
            "save_state takes one stream's state (leading axis of 1), got "
            f"{track_state.frame_id.shape[0]} streams")
    os.makedirs(path, exist_ok=True)
    data = {name: value.detach().cpu()
            for name, value in zip(TrackState._fields, track_state)}
    data["last_frame"] = torch.tensor(int(frame_id), dtype=torch.int64)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(data, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def restore_state(path: str, template: TrackState) -> tuple[TrackState, int]:
    """-> (state, frame_id) saved by :func:`save_state` in ``path``, the
    tensors on ``template``'s device; ``template`` (one stream's state,
    e.g. ``Pipeline.track_state``) gives the shapes and dtypes the
    checkpoint must have (a ``ValueError`` otherwise: another slot count,
    ReID width or tracker)."""
    data = torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=True)
    fields = []
    for name, want in zip(TrackState._fields, template):
        got = data[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint {path}: {name} is {tuple(got.shape)} "
                f"{got.dtype}, the pipeline's is {tuple(want.shape)} "
                f"{want.dtype}")
        fields.append(got.to(want.device))
    return TrackState(*fields), int(data["last_frame"])
