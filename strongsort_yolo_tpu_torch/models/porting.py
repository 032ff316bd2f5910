"""Weights from the JAX package's formats and from torch ``.pt`` files.

Counterpart of ``strongsort_yolo_tpu/models/porting.py`` and of
``models/osnet.load_osnet_npz``:

- the JAX package's ``.npz`` checkpoints (:func:`load_npz_checkpoint`,
  :func:`load_osnet_npz`);
- ultralytics-format ``.pt`` checkpoints of YOLOv8 / YOLO11 (detect,
  segment, pose), YOLOv5 (classic and ``u``) and the official YOLOv7
  (RepConv in its training or deployed form, IDetect's implicit layers
  folded into the output convs), read without the ultralytics package
  (:func:`load_torch_checkpoint`), and torchreid OSNet ``.pt``/``.pth``
  files (:func:`load_reid_checkpoint`).

Every loader returns the JAX parameter tree with numpy leaves (the
numpy-only key maps are this module's own copies of the JAX package's),
and :func:`params_from_jax` / :func:`osnet_params_from_jax` turn a tree
into the port's state_dict: one key map per family, and a tree that can
be held leaf for leaf against the JAX loader's. The JAX PRNG cannot be
replayed in torch, so every comparison with the JAX package goes through
these two functions.
"""

from __future__ import annotations

import pickle
import types
import warnings
from typing import Any

import numpy as np
import torch
from torch import nn

from strongsort_yolo_tpu_torch.models.osnet import (
    VARIANTS,
    OsnetConfig,
    checkpoint_keys,
)
from strongsort_yolo_tpu_torch.models.yolo import YoloConfig, detector_family
from strongsort_yolo_tpu_torch.models.yolov5 import Yolov5Config
from strongsort_yolo_tpu_torch.models.yolov7 import (
    V7_ANCHORS,
    Yolov7Config,
    Yolov7Model,
)

Params = dict[str, Any]
ModelConfig = YoloConfig | Yolov5Config | Yolov7Config


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
    if node is None:  # a structural marker, e.g. the JAX init_elan's "_taps"
        return
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
    (3, 3, 1, C) becomes (C, 1, 3, 3)), int8 ``wq`` weights too and stay
    int8. Raises unless the keys are exactly ``want``."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd = {}
    for key, arr in flat.items():
        int8 = key.endswith(".wq")
        arr = np.array(arr, np.int8 if int8 else np.float32)  # a writable copy
        if (key.endswith(".w") or int8) and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(arr.copy())  # C order, 0-d kept
    if set(sd) != want:
        missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
        raise ValueError(
            f"parameter tree does not match {what}: missing {missing[:5]}, "
            f"unexpected {extra[:5]}"
        )
    return sd


def _model_for_keys(keys, cfg: ModelConfig) -> nn.Module:
    """The empty model of ``cfg``'s family (YoloConfig: v8/v11,
    Yolov5Config, Yolov7Config) whose state_dict has ``keys``: BN folded
    where no key holds BN statistics, v7's RepConvs deployed where they
    hold one ``fused`` conv, a conv in int8 mode where its keys hold
    ``wq`` (with an ``xscale`` where they hold one)."""
    from strongsort_yolo_tpu_torch.models.common import Conv

    fused = not any(k.endswith("bn_scale") for k in keys)
    cls = detector_family(cfg)[0]
    if cls is Yolov7Model:
        model = cls(cfg, fused=fused,
                    rep_deploy=any(k.startswith("rep3.fused.w") for k in keys))
    else:
        model = cls(cfg, fused=fused)
    for name, m in model.named_modules():
        if isinstance(m, Conv) and f"{name}.wq" in keys:
            m.quantize_int8()
            if f"{name}.xscale" in keys:
                m.xscale = torch.zeros(())
    return model


def params_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves, e.g. after ``jax.device_get``, or
    a loader's tree) of a v8/v11, v5 or v7 model -> the port's state_dict,
    BN or fused as the tree is (v7: its RepConvs in either form)."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return _state_dict_from_tree(
        tree, set(_model_for_keys(flat, cfg).state_dict()), cfg
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


def _flat_jax_arrays(sd: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state_dict -> {JAX tree path joined by '/': float32 numpy array,
    int8 for ``wq``}, conv weights HWIO: the inverse of
    :func:`_state_dict_from_tree`."""
    flat = {}
    for key, value in sd.items():
        int8 = key.endswith(".wq")
        arr = value.detach().cpu()
        arr = (arr if int8 else arr.float()).numpy()
        if (key.endswith(".w") or int8) and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[key.replace(".", "/")] = arr.copy()  # C order, 0-d kept
    return flat


def jax_params(sd: dict[str, torch.Tensor]):
    """The port's state_dict (a detector's or an OSNet checkpoint) -> the
    JAX parameter tree with numpy leaves: the inverse of
    :func:`params_from_jax` and :func:`osnet_params_from_jax`."""
    tree: dict[str, Any] = {}
    for key, arr in _flat_jax_arrays(sd).items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return _listify(tree)


def save_npz_checkpoint(path: str, sd: dict[str, torch.Tensor],
                        cfg: YoloConfig, names: dict | None = None) -> None:
    """A v8/v11 detector's state_dict (detect, segment or pose; BN fused or
    not) in the JAX package's ``.npz`` format, which both packages'
    ``load_npz_checkpoint`` read: each tensor under its tree path, conv
    weights HWIO, ``__cfg__`` = (family, scale, task, nc, keypoints,
    values per keypoint) and ``__names__`` ("id:name") when ``names`` is
    given."""
    flat = _flat_jax_arrays(sd)
    flat["__cfg__"] = np.asarray(
        [cfg.family, cfg.scale, cfg.task, str(cfg.nc),
         str(cfg.kpt[0]), str(cfg.kpt[1])], dtype=object
    )
    if names:
        flat["__names__"] = np.asarray(
            [f"{k}:{v}" for k, v in names.items()], dtype=object
        )
    np.savez(path, **flat)


def save_osnet_npz(path: str, sd: dict[str, torch.Tensor],
                   cfg: OsnetConfig) -> None:
    """An OSNet checkpoint (``OSNet(fused=False).state_dict()``, or
    :func:`checkpoint_keys`) in the JAX package's OSNet ``.npz`` format,
    which both packages' ``load_osnet_npz`` read, with ``__variant__``."""
    if set(sd) != checkpoint_keys(cfg):
        raise ValueError(f"not an OSNet checkpoint of {cfg}")
    flat = _flat_jax_arrays(sd)
    flat["__variant__"] = np.asarray(cfg.variant)
    np.savez(path, **flat)


def model_from_state_dict(sd: dict[str, torch.Tensor],
                          cfg: ModelConfig) -> nn.Module:
    """A model of ``cfg``'s family holding ``sd``, fused or not (and v7's
    RepConvs deployed or not) as the keys say."""
    model = _model_for_keys(sd, cfg)
    model.load_state_dict(sd)
    return model


# ---------------------------------------------------------------------------
# torch .pt checkpoints without the ultralytics package
# ---------------------------------------------------------------------------


class _StubNamespace(dict):
    """Stands in for ultralytics' ``IterableSimpleNamespace`` (the
    checkpoint's training arguments): its attributes become items."""

    def __getattr__(self, k):
        if k.startswith("__"):  # pickle looks up __setstate__ and the like
            raise AttributeError(k)
        return self.get(k)

    def __setattr__(self, k, v):
        self[k] = v

    def __setstate__(self, state):
        self.update(state)


# the globals a checkpoint may name besides ultralytics classes, torch
# layers (nn.Module subclasses in torch.nn.modules), torch dtypes and
# torch._utils' tensor rebuilders: containers, numpy arrays and scalars
# (training metrics), argument records and paths
_SAFE_GLOBALS = frozenset({
    ("collections", "OrderedDict"), ("_codecs", "encode"),
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("torch", "Size"), ("torch", "device"),
    ("torch.nn.parameter", "Parameter"),
    ("torch._tensor", "_rebuild_from_type_v2"),
    ("argparse", "Namespace"),
    ("pathlib", "PosixPath"), ("pathlib", "WindowsPath"),
    ("pathlib", "PurePosixPath"), ("pathlib", "PureWindowsPath"),
    *((b, n) for b in ("builtins", "__builtin__")
      for n in ("set", "frozenset", "slice", "complex", "bytearray", "range")),
})


class _StubUnpickler(pickle.Unpickler):
    """Resolves every class of an ``ultralytics`` module to a bare
    ``nn.Module`` subclass of that name (a namespace for the argument
    records), without importing anything: enough for torch to rebuild the
    module tree and give a ``state_dict`` of plain tensors. The JAX
    package installs stub modules in ``sys.modules`` for the same end;
    this leaves ``sys.modules`` as it is. Any other global must be a torch
    layer, a torch dtype, a tensor rebuilder of ``torch._utils`` or one of
    ``_SAFE_GLOBALS``; the rest raise ``pickle.UnpicklingError``, so a
    file cannot make the load call anything else."""

    def find_class(self, module, name):
        if module == "ultralytics" or module.startswith("ultralytics."):
            if name in ("IterableSimpleNamespace", "SimpleNamespace"):
                return _StubNamespace
            classes = self.__dict__.setdefault("_classes", {})
            if (module, name) not in classes:
                classes[module, name] = type(
                    name, (nn.Module,), {"__module__": "ultralytics_stub"})
            return classes[module, name]
        if (module, name) in _SAFE_GLOBALS or (
                module == "torch._utils" and name.startswith("_rebuild_")):
            return super().find_class(module, name)
        if module == "torch" or module.startswith("torch.nn.modules."):
            obj = super().find_class(module, name)
            if isinstance(obj, torch.dtype) or (
                    isinstance(obj, type) and issubclass(obj, nn.Module)):
                return obj
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}, which a weights file has "
            "no use for")


# the pickle module torch.load is given: pickle's own, with the stub unpickler
_stub_pickle = types.ModuleType("ultralytics_stub_pickle")
_stub_pickle.__dict__.update(
    {k: getattr(pickle, k) for k in dir(pickle) if not k.startswith("__")})
_stub_pickle.Unpickler = _StubUnpickler


def load_torch_checkpoint(path: str):
    """-> (state {key: float32 np.ndarray}, meta {names, yaml, args}) of an
    ultralytics-format ``.pt``, whatever ultralytics classes it pickles."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle)
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(model, "state_dict"):
        sd = model.state_dict()
    elif isinstance(model, dict):
        sd = model
    else:
        raise ValueError(f"unrecognized checkpoint structure in {path}")
    state = {
        k: v.detach().float().cpu().numpy()
        for k, v in sd.items()
        if hasattr(v, "detach")
    }
    meta = {}
    for attr in ("names", "yaml", "args"):
        v = getattr(model, attr, None)
        if v is not None:
            meta[attr] = dict(v) if hasattr(v, "keys") else v
    return state, meta


# ---------------------------------------------------------------------------
# torch layout -> the JAX parameter tree (numpy leaves)
# ---------------------------------------------------------------------------


def _conv(sd, prefix):
    """ultralytics Conv (conv + bn, or conv with bias)."""
    w = sd[f"{prefix}.conv.weight"]
    p = {"w": np.transpose(w, (2, 3, 1, 0))}
    if f"{prefix}.bn.weight" in sd:
        p["bn_scale"] = sd[f"{prefix}.bn.weight"]
        p["bn_bias"] = sd[f"{prefix}.bn.bias"]
        p["bn_mean"] = sd[f"{prefix}.bn.running_mean"]
        p["bn_var"] = sd[f"{prefix}.bn.running_var"]
    elif f"{prefix}.conv.bias" in sd:
        p["b"] = sd[f"{prefix}.conv.bias"]
    return p


def _conv2d(sd, prefix):
    """bare nn.Conv2d with bias (head output layers)."""
    return {
        "w": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0)),
        "b": sd[f"{prefix}.bias"],
    }


def _bottleneck(sd, prefix):
    return {"cv1": _conv(sd, f"{prefix}.cv1"), "cv2": _conv(sd, f"{prefix}.cv2")}


def _count(sd, fmt):
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def _c2f(sd, prefix):
    n = _count(sd, prefix + ".m.{}.cv1.conv.weight")
    return {
        "cv1": _conv(sd, f"{prefix}.cv1"),
        "cv2": _conv(sd, f"{prefix}.cv2"),
        "m": [_bottleneck(sd, f"{prefix}.m.{i}") for i in range(n)],
    }


def _c3(sd, prefix):
    n = _count(sd, prefix + ".m.{}.cv1.conv.weight")
    return {
        "cv1": _conv(sd, f"{prefix}.cv1"),
        "cv2": _conv(sd, f"{prefix}.cv2"),
        "cv3": _conv(sd, f"{prefix}.cv3"),
        "m": [_bottleneck(sd, f"{prefix}.m.{i}") for i in range(n)],
    }


def _c3k2(sd, prefix):
    inner = []
    while True:
        m = f"{prefix}.m.{len(inner)}"
        if f"{m}.cv3.conv.weight" in sd:  # C3k unit
            inner.append({"c3k": _c3(sd, m)})
        elif f"{m}.cv1.conv.weight" in sd:  # plain bottleneck
            inner.append(_bottleneck(sd, m))
        else:
            break
    return {
        "cv1": _conv(sd, f"{prefix}.cv1"),
        "cv2": _conv(sd, f"{prefix}.cv2"),
        "m": inner,
    }


def _sppf(sd, prefix):
    return {"cv1": _conv(sd, f"{prefix}.cv1"), "cv2": _conv(sd, f"{prefix}.cv2")}


def _psa_block(sd, prefix):
    return {
        "attn": {
            "qkv": _conv(sd, f"{prefix}.attn.qkv"),
            "proj": _conv(sd, f"{prefix}.attn.proj"),
            "pe": _conv(sd, f"{prefix}.attn.pe"),
        },
        "ffn1": _conv(sd, f"{prefix}.ffn.0"),
        "ffn2": _conv(sd, f"{prefix}.ffn.1"),
    }


def _c2psa(sd, prefix):
    n = _count(sd, prefix + ".m.{}.attn.qkv.conv.weight")
    return {
        "cv1": _conv(sd, f"{prefix}.cv1"),
        "cv2": _conv(sd, f"{prefix}.cv2"),
        "m": [_psa_block(sd, f"{prefix}.m.{i}") for i in range(n)],
    }


def _branch(sd, prefix):
    """Detect tower: Conv, Conv, Conv2d (v8) or the v11 depthwise class
    tower Sequential(Sequential(DWConv, Conv), Sequential(DWConv, Conv),
    Conv2d)."""
    if f"{prefix}.0.0.conv.weight" in sd:  # v11 dw tower
        return {
            "a_dw": _conv(sd, f"{prefix}.0.0"),
            "a": _conv(sd, f"{prefix}.0.1"),
            "b_dw": _conv(sd, f"{prefix}.1.0"),
            "b": _conv(sd, f"{prefix}.1.1"),
            "out": _conv2d(sd, f"{prefix}.2"),
        }
    return {
        "a": _conv(sd, f"{prefix}.0"),
        "b": _conv(sd, f"{prefix}.1"),
        "out": _conv2d(sd, f"{prefix}.2"),
    }


def _f32(tree):
    """Every leaf of a nested dict/list tree as float32 numpy."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return np.asarray(tree, np.float32)


# ultralytics v8 / v11 layer indices of each part of the JAX tree
_LAYOUTS = {
    "v8": {
        "stem": 0, "down1": 1, "stage1": 2, "down2": 3, "stage2": 4,
        "down3": 5, "stage3": 6, "down4": 7, "stage4": 8, "sppf": 9,
        "td1": 12, "td2": 15, "bu1_conv": 16, "bu1": 18,
        "bu2_conv": 19, "bu2": 21, "head": 22,
    },
    "v11": {
        "stem": 0, "down1": 1, "stage1": 2, "down2": 3, "stage2": 4,
        "down3": 5, "stage3": 6, "down4": 7, "stage4": 8, "sppf": 9,
        "c2psa": 10,
        "td1": 13, "td2": 16, "bu1_conv": 17, "bu1": 19,
        "bu2_conv": 20, "bu2": 22, "head": 23,
    },
}


def port_yolo(state_dict: dict, cfg: YoloConfig) -> Params:
    """An ultralytics v8/v11 state_dict -> the JAX tree."""
    sd = state_dict
    lay = _LAYOUTS[cfg.family]

    def L(name):
        return f"model.{lay[name]}"

    def stage(name):
        return (_c2f if cfg.family == "v8" else _c3k2)(sd, L(name))

    backbone = {
        "stem": _conv(sd, L("stem")),
        "down1": _conv(sd, L("down1")),
        "stage1": stage("stage1"),
        "down2": _conv(sd, L("down2")),
        "stage2": stage("stage2"),
        "down3": _conv(sd, L("down3")),
        "stage3": stage("stage3"),
        "down4": _conv(sd, L("down4")),
        "stage4": stage("stage4"),
        "sppf": _sppf(sd, L("sppf")),
    }
    if cfg.family == "v11":
        backbone["c2psa"] = _c2psa(sd, L("c2psa"))
    neck = {
        "td1": stage("td1"),
        "td2": stage("td2"),
        "bu1_conv": _conv(sd, L("bu1_conv")),
        "bu1": stage("bu1"),
        "bu2_conv": _conv(sd, L("bu2_conv")),
        "bu2": stage("bu2"),
    }
    h = L("head")
    detect = {
        "box": [_branch(sd, f"{h}.cv2.{i}") for i in range(3)],
        "cls": [_branch(sd, f"{h}.cv3.{i}") for i in range(3)],
    }
    params: Params = {"backbone": backbone, "neck": neck, "detect": detect}
    if cfg.task == "segment":
        params["proto"] = {
            k: _conv(sd, f"{h}.proto.{k}") for k in ("cv1", "cv2", "cv3")
        }
        params["mask"] = [_branch(sd, f"{h}.cv4.{i}") for i in range(3)]
    elif cfg.task == "pose":
        params["kpt"] = [_branch(sd, f"{h}.cv4.{i}") for i in range(3)]
    return _f32(params)


def infer_config(state_dict: dict, meta: dict) -> YoloConfig:
    """Family, scale, task, nc and keypoint shape of a v8/v11 checkpoint."""
    keys = state_dict.keys()
    family = "v11" if any(".attn.qkv" in k for k in keys) else "v8"
    head = _LAYOUTS[family]["head"]
    task = "detect"
    if f"model.{head}.proto.cv1.conv.weight" in keys:
        task = "segment"
    elif f"model.{head}.cv4.0.0.conv.weight" in keys:
        task = "pose"
    stem_out = state_dict["model.0.conv.weight"].shape[0]
    # the width multiple from the stem (64 * w), then v11 m/l by depth
    w_to_scales = {
        "v8": {16: ["n"], 32: ["s"], 48: ["m"], 64: ["l"], 80: ["x"]},
        "v11": {16: ["n"], 32: ["s"], 64: ["m", "l"], 96: ["x"]},
    }
    cands = w_to_scales[family].get(stem_out, ["n"])
    if len(cands) > 1:
        n_rep = 0
        while f"model.2.m.{n_rep}.cv1.conv.weight" in keys or (
            f"model.2.m.{n_rep}.cv3.conv.weight" in keys
        ):
            n_rep += 1
        scale = "l" if n_rep > 1 else "m"
    else:
        scale = cands[0]
    nc = None
    if isinstance(meta.get("names"), dict):
        nc = len(meta["names"])
    if nc is None:
        cls_w = state_dict.get(f"model.{head}.cv3.0.2.weight")
        nc = cls_w.shape[0] if cls_w is not None else 80
    kpt = (17, 3)
    if task == "pose":
        nk = state_dict[f"model.{head}.cv4.0.2.weight"].shape[0]
        kpt = (nk // 3, 3) if nk % 3 == 0 else (nk // 2, 2)
    return YoloConfig(family=family, scale=scale, task=task, nc=nc, kpt=kpt)


# layer indices of the v5 (v6.0) layout, the same for the classic and the
# 'u' checkpoints; only the Detect at 24 differs
_V5_LAYOUT = {
    "stem": 0, "down1": 1, "stage1": 2, "down2": 3, "stage2": 4,
    "down3": 5, "stage3": 6, "down4": 7, "stage4": 8, "sppf": 9,
    "lat5": 10, "td1": 13, "lat4": 14, "td2": 17,
    "bu1_conv": 18, "bu1": 20, "bu2_conv": 21, "bu2": 23, "head": 24,
}


def port_yolov5(state_dict: dict, cfg: Yolov5Config) -> Params:
    """A yolov5 / v5u state_dict -> the JAX tree: classic checkpoints carry
    plain ``model.24.m.{i}`` anchor convs, 'u' ones the v8 towers."""
    sd = state_dict
    L = {k: f"model.{v}" for k, v in _V5_LAYOUT.items()}
    p: Params = {}
    for name in ("stem", "down1", "down2", "down3", "down4", "lat5", "lat4",
                 "bu1_conv", "bu2_conv"):
        p[name] = _conv(sd, L[name])
    for name in ("stage1", "stage2", "stage3", "stage4", "td1", "td2", "bu1",
                 "bu2"):
        p[name] = _c3(sd, L[name])
    p["sppf"] = _sppf(sd, L["sppf"])
    h = L["head"]
    if cfg.anchor_free:
        p["detect"] = {
            "box": [_branch(sd, f"{h}.cv2.{i}") for i in range(3)],
            "cls": [_branch(sd, f"{h}.cv3.{i}") for i in range(3)],
        }
    else:
        p["detect"] = {"m": [_conv2d(sd, f"{h}.m.{i}") for i in range(3)]}
    return _f32(p)


def infer_v5_config(state_dict: dict) -> Yolov5Config | None:
    """The config of a yolov5 / v5u checkpoint, or None for another family."""
    classic = "model.24.m.0.weight" in state_dict
    u_head = "model.24.cv2.0.0.conv.weight" in state_dict
    if not (classic or u_head):
        return None
    stem_out = state_dict["model.0.conv.weight"].shape[0]
    scale = {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}.get(stem_out, "n")
    if classic:
        nc = state_dict["model.24.m.0.weight"].shape[0] // 3 - 5
    else:
        nc = state_dict["model.24.cv3.0.2.weight"].shape[0]
    return Yolov5Config(scale=scale, nc=nc, anchor_free=u_head)


# layer indices of the official yolov7.yaml (base model). ELAN entries are
# (cv1, cv2, [inner convs], merge); MP transitions (post-pool 1x1,
# pre-strided 1x1, strided 3x3); each index is one ``model.{i}`` Conv
_V7_IDX = {
    "stem0": 0, "stem1": 1, "stem2": 2, "down2": 3,
    "elan2": (4, 5, [6, 7, 8, 9], 11),
    "mp3": (13, 14, 15),
    "elan3": (17, 18, [19, 20, 21, 22], 24),
    "mp4": (26, 27, 28),
    "elan4": (30, 31, [32, 33, 34, 35], 37),
    "mp5": (39, 40, 41),
    "elan5": (43, 44, [45, 46, 47, 48], 50),
    "sppcspc": 51,
    "lat4": 52, "route4": 54,
    "elan_h4": (56, 57, [58, 59, 60, 61], 63),
    "lat3": 64, "route3": 66,
    "elan_h3": (68, 69, [70, 71, 72, 73], 75),
    "mp_h4": (77, 78, 79),
    "elan_h4b": (81, 82, [83, 84, 85, 86], 88),
    "mp_h5": (90, 91, 92),
    "elan_h5": (94, 95, [96, 97, 98, 99], 101),
    "rep3": 102, "rep4": 103, "rep5": 104,
    "detect": 105,
}


def _v7_repconv(sd, i):
    """RepConv: the training form (rbr_dense / rbr_1x1 conv+BN pairs) or
    the deployed single conv (rbr_reparam)."""
    if f"model.{i}.rbr_reparam.weight" in sd:
        return {"fused": {
            "w": np.transpose(sd[f"model.{i}.rbr_reparam.weight"], (2, 3, 1, 0)),
            "b": sd[f"model.{i}.rbr_reparam.bias"],
        }}

    def branch(name):
        p = f"model.{i}.{name}"
        return {
            "w": np.transpose(sd[f"{p}.0.weight"], (2, 3, 1, 0)),
            "bn_scale": sd[f"{p}.1.weight"],
            "bn_bias": sd[f"{p}.1.bias"],
            "bn_mean": sd[f"{p}.1.running_mean"],
            "bn_var": sd[f"{p}.1.running_var"],
        }

    return {"dense": branch("rbr_dense"), "one": branch("rbr_1x1")}


def _v7_detect(sd, i):
    """IDetect: the implicit layers folded into the 1x1 convs (y = im *
    conv(x + ia) => W' = W * im, b' = (b + W . ia) * im), the official
    deploy fuse's algebra."""
    out = []
    for j in range(3):
        w = sd[f"model.{i}.m.{j}.weight"]  # (na * no, c, 1, 1)
        b = sd[f"model.{i}.m.{j}.bias"].copy()
        ia = sd.get(f"model.{i}.ia.{j}.implicit")
        im = sd.get(f"model.{i}.im.{j}.implicit")
        if ia is not None:
            b = b + w.reshape(w.shape[0], -1) @ ia.reshape(-1)
        if im is not None:
            w = w * im.reshape(-1, 1, 1, 1)
            b = b * im.reshape(-1)
        out.append({"w": np.transpose(w, (2, 3, 1, 0)), "b": b})
    return {"m": out}


def port_yolov7(state_dict: dict, cfg: Yolov7Config | None = None) -> Params:
    """An official yolov7 state_dict -> the JAX tree."""
    sd = state_dict
    p: Params = {}
    for name, idx in _V7_IDX.items():
        if name.startswith("elan"):
            cv1, cv2, inner, merge = idx
            p[name] = {
                "cv1": _conv(sd, f"model.{cv1}"),
                "cv2": _conv(sd, f"model.{cv2}"),
                "inner": [_conv(sd, f"model.{i}") for i in inner],
                "merge": _conv(sd, f"model.{merge}"),
            }
        elif name.startswith("mp"):
            p[name] = {k: _conv(sd, f"model.{i}")
                       for k, i in zip(("cv1", "cv2", "cv3"), idx)}
        elif name == "sppcspc":
            p[name] = {f"cv{k}": _conv(sd, f"model.{idx}.cv{k}")
                       for k in range(1, 8)}
        elif name.startswith("rep"):
            p[name] = _v7_repconv(sd, idx)
        elif name == "detect":
            p[name] = _v7_detect(sd, idx)
        else:
            p[name] = _conv(sd, f"model.{idx}")
    return _f32(p)


def infer_v7_config(state_dict: dict) -> Yolov7Config | None:
    """The config of an official yolov7 checkpoint (RepConv keys at
    model.102-104, the head at 105), or None for another family."""
    keys = state_dict.keys()
    rep = f"model.{_V7_IDX['rep3']}"
    if not (f"{rep}.rbr_dense.0.weight" in keys
            or f"{rep}.rbr_reparam.weight" in keys):
        return None
    head = f"model.{_V7_IDX['detect']}"
    nc = state_dict[f"{head}.m.0.weight"].shape[0] // 3 - 5
    ag = state_dict.get(f"{head}.anchor_grid")
    if ag is not None:
        got = np.asarray(ag).reshape(3, 3, 2)
        if not np.allclose(got, np.asarray(V7_ANCHORS, np.float32), atol=0.5):
            warnings.warn(
                "yolov7 checkpoint anchors differ from the base priors; the "
                f"decode uses the base priors, not:\n{got}")
    return Yolov7Config(nc=nc)


def load_checkpoint(path: str):
    """-> (JAX tree with numpy leaves, config, class names or None) of a
    ``.npz`` of the JAX package or an ultralytics-format ``.pt`` of v8/v11,
    v5 or v7 (v7 is tried first: its layout has the v5 head's keys too)."""
    if path.endswith(".npz"):
        return load_npz_checkpoint(path)
    state, meta = load_torch_checkpoint(path)
    v7_cfg = infer_v7_config(state)
    v5_cfg = infer_v5_config(state)
    if v7_cfg is not None:
        cfg, tree = v7_cfg, port_yolov7(state, v7_cfg)
    elif v5_cfg is not None:
        cfg, tree = v5_cfg, port_yolov5(state, v5_cfg)
    else:
        cfg = infer_config(state, meta)
        tree = port_yolo(state, cfg)
    names = meta.get("names")
    if isinstance(names, dict):
        names = {int(k): str(v) for k, v in names.items()}
    return tree, cfg, names


# ---------------------------------------------------------------------------
# torchreid OSNet
# ---------------------------------------------------------------------------

_OSNET_STAGES = {
    "b2a": "conv2.0", "b2b": "conv2.1", "t2": "conv2.2.0",
    "b3a": "conv3.0", "b3b": "conv3.1", "t3": "conv3.2.0",
    "b4a": "conv4.0", "b4b": "conv4.1",
}


def _os_lite(sd, prefix):
    """torchreid LightConv3x3: conv1 (linear 1x1), conv2 (depthwise 3x3),
    one bn."""
    pw_w = np.transpose(sd[f"{prefix}.conv1.weight"], (2, 3, 1, 0))
    return {
        "pw": {"w": pw_w, "b": np.zeros((pw_w.shape[-1],), np.float32)},
        "dw": {
            "w": np.transpose(sd[f"{prefix}.conv2.weight"], (2, 3, 1, 0)),
            "bn_scale": sd[f"{prefix}.bn.weight"],
            "bn_bias": sd[f"{prefix}.bn.bias"],
            "bn_mean": sd[f"{prefix}.bn.running_mean"],
            "bn_var": sd[f"{prefix}.bn.running_var"],
        },
    }


def _os_block(sd, prefix):
    streams = [[_os_lite(sd, f"{prefix}.conv2a")]] + [
        [_os_lite(sd, f"{prefix}.{name}.{j}") for j in range(t)]
        for name, t in (("conv2b", 2), ("conv2c", 3), ("conv2d", 4))
    ]
    p = {
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "gate": {
            "fc1": _conv2d(sd, f"{prefix}.gate.fc1"),
            "fc2": _conv2d(sd, f"{prefix}.gate.fc2"),
        },
        "conv3": _conv(sd, f"{prefix}.conv3"),
        "streams": streams,
    }
    if f"{prefix}.downsample.conv.weight" in sd:
        p["down"] = _conv(sd, f"{prefix}.downsample")
    return p


def port_osnet(state_dict: dict) -> Params:
    """A torchreid OSNet state_dict -> the JAX tree."""
    sd = state_dict
    p: Params = {"stem": _conv(sd, "conv1")}
    for ours, theirs in _OSNET_STAGES.items():
        p[ours] = (_conv if ours.startswith("t") else _os_block)(sd, theirs)
    p["conv5"] = _conv(sd, "conv5")
    p["fc"] = {
        "lin": {
            "w": np.transpose(sd["fc.0.weight"])[None, None],  # (1,1,c4,feat)
            "b": sd["fc.0.bias"],
        },
        "bn": {
            "bn_scale": sd["fc.1.weight"],
            "bn_bias": sd["fc.1.bias"],
            "bn_mean": sd["fc.1.running_mean"],
            "bn_var": sd["fc.1.running_var"],
        },
    }
    return _f32(p)


def infer_osnet_config(state_dict: dict) -> OsnetConfig | None:
    """The OsnetConfig of a torchreid state_dict, or None."""
    if "conv2.0.conv2a.conv1.weight" not in state_dict:
        return None
    c1 = state_dict["conv1.conv.weight"].shape[0]
    for name, m in VARIANTS.items():
        if int(64 * m) == c1:
            return OsnetConfig(variant=name,
                               feat_dim=state_dict["fc.0.weight"].shape[0])
    return None


def load_reid_checkpoint(path: str):
    """A torchreid OSNet ``.pt``/``.pth`` (a bare state_dict or
    ``{"state_dict": ...}``, keys with or without DataParallel's
    ``module.``) -> (JAX tree with numpy leaves, OsnetConfig). Unpickled
    under the globals :class:`_StubUnpickler` allows."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    state = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            state[k.removeprefix("module.")] = v.detach().float().cpu().numpy()
    cfg = infer_osnet_config(state)
    if cfg is None:
        raise ValueError(f"{path} is not a recognizable torchreid OSNet checkpoint")
    return port_osnet(state), cfg
