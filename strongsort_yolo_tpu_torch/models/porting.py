"""Weights from the JAX package: its ``.npz`` checkpoints and its
parameter trees.

Counterpart of ``strongsort_yolo_tpu/models/porting.py``
(``load_npz_checkpoint``) and of ``models/osnet.load_osnet_npz``. The JAX
PRNG cannot be replayed in torch, so every comparison with the JAX
package goes through :func:`params_from_jax` or
:func:`osnet_params_from_jax`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from strongsort_yolo_tpu_torch.models.osnet import OsnetConfig, checkpoint_keys
from strongsort_yolo_tpu_torch.models.yolo import YoloConfig, YoloModel


def load_npz_checkpoint(path: str):
    """-> (parameter tree of numpy arrays in the JAX layout, YoloConfig,
    class names or None), from the JAX package's ``.npz`` format."""
    data = np.load(path, allow_pickle=True)
    cfg_rec = list(data["__cfg__"])
    family, scale, task, nc = cfg_rec[:4]
    kpt = (int(cfg_rec[4]), int(cfg_rec[5])) if len(cfg_rec) >= 6 else (17, 3)
    cfg = YoloConfig(
        family=str(family), scale=str(scale), task=str(task), nc=int(nc),
        kpt=kpt,
    )
    names = None
    if "__names__" in data:
        names = {}
        for item in data["__names__"]:
            k, _, v = str(item).partition(":")
            names[int(k)] = v
    tree: dict[str, Any] = {}
    for key in data.files:
        if key.startswith("__"):
            continue
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[key])
    return _listify(tree), cfg, names


def _listify(node):
    """{'0': .., '1': ..} dicts (flattened list paths) back into lists."""
    if isinstance(node, dict):
        conv = {k: _listify(v) for k, v in node.items()}
        if conv and all(k.isdigit() for k in conv):
            return [conv[str(i)] for i in range(len(conv))]
        return conv
    return node


def _flatten(node, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def _state_dict_from_tree(tree, want: set[str], what) -> dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree into a state_dict: keys are the tree
    paths joined with dots, HWIO conv weights become OIHW (a depthwise
    (3, 3, 1, C) becomes (C, 1, 3, 3)). Raises unless the keys are
    exactly ``want``."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd = {}
    for key, arr in flat.items():
        arr = np.array(arr, np.float32)  # a writable copy
        if key.endswith(".w") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if set(sd) != want:
        missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
        raise ValueError(
            f"parameter tree does not match {what}: missing {missing[:5]}, "
            f"unexpected {extra[:5]}"
        )
    return sd


def params_from_jax(tree, cfg: YoloConfig) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves, e.g. after ``jax.device_get``)
    -> the port's YOLO state_dict, BN or fused as the tree is."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    fused = not any(k.endswith("bn_scale") for k in flat)
    return _state_dict_from_tree(
        tree, set(YoloModel(cfg, fused=fused).state_dict()), cfg
    )


def osnet_params_from_jax(tree, cfg: OsnetConfig) -> dict[str, torch.Tensor]:
    """JAX OSNet parameter tree (``init_osnet``, ``load_osnet_npz``) -> the
    port's OSNet checkpoint (RGB convention, BN statistics as stored), which
    ``osnet_from_state_dict`` folds."""
    return _state_dict_from_tree(tree, checkpoint_keys(cfg), cfg)


def load_osnet_npz(path: str):
    """-> (parameter tree of numpy arrays in the JAX layout, OsnetConfig)
    from the JAX package's OSNet ``.npz`` (keys like
    ``b2a/streams/0/0/dw/w`` and ``__variant__``)."""
    data = np.load(path, allow_pickle=False)
    cfg = OsnetConfig(variant=str(data["__variant__"]))
    tree: dict[str, Any] = {}
    for key in data.files:
        if key == "__variant__":
            continue
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[key])
    return _listify(tree), cfg


def model_from_state_dict(sd: dict[str, torch.Tensor], cfg: YoloConfig) -> YoloModel:
    """A model holding ``sd``, fused or not as the keys say."""
    fused = not any(k.endswith("bn_scale") for k in sd)
    model = YoloModel(cfg, fused=fused)
    model.load_state_dict(sd)
    return model
