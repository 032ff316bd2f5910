"""K6: one fused OSNet backbone stage (``csrc/os_stage.cu``), its wrapper
:func:`os_stage`, its plain PyTorch version :func:`os_stage_plain`, and
the packing of a stage's weights, :func:`stage_weights`.

Replaces ``strongsort_yolo_tpu/ops/pallas/osnet_kernel.py``: ``os_stage``
(body ``_stage_kernel``). A stage is two OS blocks (1x1 conv, four
streams of one to four lite 3x3 convs, the shared channel gate, the
aggregation, 1x1 conv, residual) and then either the 1x1 transition with
a 2x2 average pool or, for the last stage, conv5 with the global average
pool. Activations are NCHW, ``(G, C, H, W)`` in the compute dtype, and
every BatchNorm is folded into its conv.

The plain version rounds where the TPU kernel rounds, not where the
unfused model does:

- ``conv1`` -> ReLU -> cast to the compute dtype;
- each lite conv: the pointwise conv -> cast; the 9-tap depthwise
  stencil summed in float32, dy outer and dx inner, zero outside the
  crop, then ``+ bias`` -> ReLU -> cast;
- the gate: float32 spatial mean -> cast -> fc1 -> ReLU -> cast -> fc2
  -> sigmoid -> cast; then ``s * g`` in the compute dtype, the four
  streams summed in the compute dtype;
- ``conv3`` in float32 plus the residual (``down`` in float32, or the
  input as float32) -> ReLU -> cast;
- the transition -> ReLU -> cast, then the 2x2 mean in float32 -> cast;
  or conv5 -> ReLU -> cast, then the float32 spatial mean -> cast.

Pointwise products accumulate in float32. The pointwise and gate
matrices are held in the compute dtype; biases and depthwise tap weights
stay float32, as the TPU kernel's ``fold_stage`` keeps them. The TPU
kernel's channels-on-rows layout (``kron(I_tm, w)`` left products) is a
device of its vector unit; here the same function is computed per crop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from strongsort_yolo_tpu_torch.ops.cuda import _build

LITES = 10  # lite convs of an OS block: streams of 1, 2, 3 and 4
WIDTHS = (0.25, 0.5, 0.75, 1.0)  # the released OSNet widths, x0_25 to x1_0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class StageSpec:
    h: int  # input spatial size of the stage
    w: int
    c_in: int
    c_out: int
    mid: int
    epilogue: str  # "pool": 1x1 + ReLU, 2x2 mean; "gap": conv5 + ReLU, mean

    @property
    def out_shape(self) -> tuple[int, ...]:
        """Per crop, NCHW: (c_out, h/2, w/2), or (c_out,) after the GAP."""
        if self.epilogue == "gap":
            return (self.c_out,)
        return (self.c_out, self.h // 2, self.w // 2)


def stage_specs(channels: tuple[int, int, int, int], crop_hw=(128, 64)):
    """The three backbone stages of an OSNet with these channels (after
    the stem and max-pool the crop is a quarter of its size)."""
    c1, c2, c3, c4 = channels
    h, w = crop_hw[0] // 4, crop_hw[1] // 4
    return (
        StageSpec(h, w, c1, c2, c2 // 4, "pool"),
        StageSpec(h // 2, w // 2, c2, c3, c3 // 4, "pool"),
        StageSpec(h // 4, w // 4, c3, c4, c4 // 4, "gap"),
    )


def osnet_channels(width: float) -> tuple[int, int, int, int]:
    """The stem and stage widths of OSNet at ``width`` (x1_0: 64, 256,
    384, 512)."""
    return tuple(int(c * width) for c in (64, 256, 384, 512))


# (c_in, c_out, mid, pixels) of every stage K6 is built for: the stages
# of the four released widths at 128x64 crops
KERNEL_SHAPES = frozenset(
    (s.c_in, s.c_out, s.mid, s.h * s.w)
    for width in WIDTHS for s in stage_specs(osnet_channels(width)))


# dtype -> (c_in, c_out, mid, pixels) -> the blocks a crop is split over,
# a band of rows each (``csrc/os_stage_cluster.cu``,
# ``csrc/os_stage_tf32_cluster.cu``): the stages whose crop does not fit
# one block in the tensor-core layout. In bfloat16 (stage 2 of x0_5, x0_75
# and x1_0; stage 3 of x1_0) the least split whose band lets two blocks
# share an SM (a block's bytes: 89.8, 68.9, 89.5 and 75.8 KB), which ran
# faster than the least split that fits one block. In float32, whose
# layout is twice as wide (x0_25's stage 3 and the stage 4s fit one
# block), one past the least that fits where the band rule allows it (a
# block's bytes: 89.4, 88.2, 74.6, 128.9, 110.2, 169.5 and 145.8 KB).
CLUSTER_SPLIT = {
    torch.bfloat16: {(32, 128, 32, 512): 4, (48, 192, 48, 512): 8,
                     (64, 256, 64, 512): 8, (256, 384, 96, 128): 4},
    torch.float32: {(16, 64, 16, 512): 4, (32, 128, 32, 512): 8,
                    (128, 192, 48, 128): 4, (48, 192, 48, 512): 8,
                    (192, 288, 72, 128): 4, (64, 256, 64, 512): 8,
                    (256, 384, 96, 128): 4},
}


def cluster_split(spec: StageSpec, dtype: torch.dtype) -> int:
    """The blocks K6 splits one crop of this stage over in ``dtype``:
    CLUSTER_SPLIT's, else 1 (one block a crop)."""
    return CLUSTER_SPLIT.get(dtype, {}).get(
        (spec.c_in, spec.c_out, spec.mid, spec.h * spec.w), 1)


class StageWeights(NamedTuple):
    """One stage's folded weights, packed for K6: ``mats`` (1-D, compute
    dtype) holds the pointwise and gate matrices, (out, in) row-major;
    ``vecs`` (1-D, float32) the biases and the tap weights, (9, mid) with
    tap (dy, dx) at row (dy + 1) * 3 + dx + 1; ``offs`` (int32) the offset
    of every tensor in its blob, -1 for an absent one, in the order of
    :func:`_layout`."""

    mats: torch.Tensor
    vecs: torch.Tensor
    offs: torch.Tensor

    def to(self, device) -> StageWeights:
        return StageWeights(*(t.to(device) for t in self))


def _layout(spec: StageSpec) -> list[tuple[str, bool, tuple[int, ...]]]:
    """(name, is a matrix, shape) of every packed tensor, in the order of
    the offsets table: per block (a, b), 50 entries — w1, b1, per lite
    (stream t's lite k is lite t (t + 1) / 2 + k) pw, pwb, taps, dwb, then
    g1, g1b, g2, g2b, w3, b3, wd, bd — then ep_w, ep_b (102 in all)."""
    mid, r = spec.mid, max(spec.mid // 16, 1)
    out = []
    for blk, c_in in (("a", spec.c_in), ("b", spec.c_out)):
        out += [(f"{blk}.w1", True, (mid, c_in)), (f"{blk}.b1", False, (mid,))]
        for i in range(LITES):
            out += [(f"{blk}.l{i}.pw", True, (mid, mid)),
                    (f"{blk}.l{i}.pwb", False, (mid,)),
                    (f"{blk}.l{i}.taps", False, (9, mid)),
                    (f"{blk}.l{i}.dwb", False, (mid,))]
        out += [(f"{blk}.g1", True, (r, mid)), (f"{blk}.g1b", False, (r,)),
                (f"{blk}.g2", True, (mid, r)), (f"{blk}.g2b", False, (mid,)),
                (f"{blk}.w3", True, (spec.c_out, mid)),
                (f"{blk}.b3", False, (spec.c_out,)),
                (f"{blk}.wd", True, (spec.c_out, c_in)),
                (f"{blk}.bd", False, (spec.c_out,))]
    out += [("ep_w", True, (spec.c_out, spec.c_out)),
            ("ep_b", False, (spec.c_out,))]
    return out


_STAGE_KEYS = (("b2a", "b2b", "t2"), ("b3a", "b3b", "t3"),
               ("b4a", "b4b", "conv5"))


def stage_weights(
    model_or_state: nn.Module | dict[str, torch.Tensor],
    stage: int,
    dtype: torch.dtype,
) -> StageWeights:
    """Pack backbone stage ``stage`` (0, 1, 2: the stages of
    :func:`stage_specs`) of an OSNet (the port's ``models.osnet.OSNet``,
    or its state_dict: BN already folded into each conv's ``w`` and
    ``b``) for K6 in compute ``dtype``. Pack from the float32 weights:
    the biases and tap weights stay float32 and only the matrices are
    rounded to ``dtype``."""
    sd = (model_or_state.state_dict() if isinstance(model_or_state, nn.Module)
          else model_or_state)
    if sd["stem.w"].dtype != torch.float32:
        raise ValueError("stage_weights packs from float32 weights (the "
                         "biases and taps stay float32); pack before a cast")
    channels = tuple(sd[k].shape[0] for k in ("stem.w", "t2.w", "t3.w",
                                              "conv5.w"))
    spec = stage_specs(channels)[stage]  # the widths; packing needs no crop size
    pa, pb, ep = _STAGE_KEYS[stage]
    src = {}
    for blk, prefix in (("a", pa), ("b", pb)):
        src[f"{blk}.w1"], src[f"{blk}.b1"] = prefix + ".conv1.w", prefix + ".conv1.b"
        for t in range(4):
            for k in range(t + 1):
                lite, p = t * (t + 1) // 2 + k, f"{prefix}.streams.{t}.{k}"
                for name, key in (("pw", "pw.w"), ("pwb", "pw.b"),
                                  ("taps", "dw.w"), ("dwb", "dw.b")):
                    src[f"{blk}.l{lite}.{name}"] = f"{p}.{key}"
        for name, key in (("g1", "gate.fc1"), ("g2", "gate.fc2"),
                          ("w3", "conv3"), ("wd", "down")):
            src[f"{blk}.{name}"] = f"{prefix}.{key}.w"
        for name, key in (("g1b", "gate.fc1"), ("g2b", "gate.fc2"),
                          ("b3", "conv3"), ("bd", "down")):
            src[f"{blk}.{name}"] = f"{prefix}.{key}.b"
    src["ep_w"], src["ep_b"] = ep + ".w", ep + ".b"

    mats, vecs, offs = [], [], []
    sizes = {True: 0, False: 0}
    for name, is_mat, shape in _layout(spec):
        key = src[name]
        if key not in sd:  # an OS block without ``down``
            offs.append(-1)
            continue
        t = sd[key].float()
        if name.endswith(".taps"):  # (mid, 1, 3, 3) -> (9, mid)
            t = t.reshape(t.shape[0], 9).T
        t = t.reshape(shape)
        offs.append(sizes[is_mat])
        sizes[is_mat] += t.numel()
        (mats if is_mat else vecs).append(t.reshape(-1))
    return StageWeights(torch.cat(mats).to(dtype).contiguous(),
                        torch.cat(vecs).contiguous(),
                        torch.tensor(offs, dtype=torch.int32))


def _views(wts: StageWeights, spec: StageSpec) -> dict[str, torch.Tensor]:
    """name -> tensor view of the packed blobs (absent ones left out)."""
    out = {}
    offs = wts.offs.tolist()
    for (name, is_mat, shape), off in zip(_layout(spec), offs):
        if off < 0:
            continue
        n = 1
        for d in shape:
            n *= d
        blob = wts.mats if is_mat else wts.vecs
        out[name] = blob[off:off + n].reshape(shape)
    return out


def _pointwise(w: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(co, ci) @ (G, ci, P) + (co,) in float32 -> (G, co, P)."""
    return torch.matmul(w.float(), x.float()) + b[:, None]


def _lite(s, v, name: str, spec: StageSpec, dt):
    """One lite conv on (G, mid, P): pointwise -> cast, then the 3x3
    depthwise stencil in float32, dy outer and dx inner, zero outside
    the crop -> + bias -> ReLU -> cast."""
    g, c, _ = s.shape
    h, w = spec.h, spec.w
    u = _pointwise(v[name + ".pw"], s, v[name + ".pwb"]).to(dt)
    up = F.pad(u.float().reshape(g, c, h, w), (1, 1, 1, 1))
    taps = v[name + ".taps"]
    acc = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            t = (up[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                 * taps[(dy + 1) * 3 + dx + 1][:, None, None])
            acc = t if acc is None else acc + t
    out = torch.relu(acc + v[name + ".dwb"][:, None, None]).to(dt)
    return out.reshape(g, c, h * w)


def _gate_mean(s):
    """(G, mid, P) -> the float32 mean over the pixels, (G, mid)."""
    return s.float().mean(-1)


def _gate(s, v, blk: str, dt):
    """The channel gate of one stream, applied: s * g in the compute
    dtype."""
    m = _gate_mean(s).to(dt)  # (G, mid)
    a = torch.relu(m.float() @ v[blk + ".g1"].float().T + v[blk + ".g1b"])
    g = torch.sigmoid(a.to(dt).float() @ v[blk + ".g2"].float().T
                      + v[blk + ".g2b"]).to(dt)
    return s * g[:, :, None]


def _os_block(x, v, blk: str, spec: StageSpec, dt):
    y = torch.relu(_pointwise(v[blk + ".w1"], x, v[blk + ".b1"])).to(dt)
    agg = None
    for t in range(4):
        s = y
        for k in range(t + 1):
            s = _lite(s, v, f"{blk}.l{t * (t + 1) // 2 + k}", spec, dt)
        gs = _gate(s, v, blk, dt)
        agg = gs if agg is None else agg + gs
    out = _pointwise(v[blk + ".w3"], agg, v[blk + ".b3"])
    if blk + ".wd" in v:
        res = _pointwise(v[blk + ".wd"], x, v[blk + ".bd"])
    else:
        res = x.float()
    return torch.relu(out + res).to(dt)


def os_stage_plain(x: torch.Tensor, weights: StageWeights,
                   spec: StageSpec) -> torch.Tensor:
    """(G, c_in, h, w) in the compute dtype -> (G, c_out, h/2, w/2), or
    (G, c_out) for the last stage, in the compute dtype."""
    dt = x.dtype
    g = x.shape[0]
    v = _views(weights, spec)
    x = x.reshape(g, spec.c_in, spec.h * spec.w)
    x = _os_block(x, v, "a", spec, dt)
    x = _os_block(x, v, "b", spec, dt)
    y = torch.relu(_pointwise(v["ep_w"], x, v["ep_b"])).to(dt)
    if spec.epilogue == "gap":
        return y.float().mean(-1).to(dt)
    y = y.float().reshape(g, spec.c_out, spec.h, spec.w)
    return F.avg_pool2d(y, 2).to(dt)


_B_WD = 98  # the offsets table's entry of block b's ``down`` (-1: absent;
# every form also computes a down conv there, read from the table on the
# card, so the wrapper reads nothing back from the device)
FORMS = ("tensor cores", "tensor cores, cluster of {}",
         "tensor cores, 3xTF32", "tensor cores, 3xTF32, cluster of {}")


def stage_form(spec: StageSpec, dtype: torch.dtype) -> str:
    """The form K6 takes for a stage (``csrc/os_stage.cuh``): the tensor
    cores, one block a crop or, for the stages of CLUSTER_SPLIT, a
    cluster of blocks a crop ("tensor cores, cluster of 4"); in float32
    their products as 3xTF32 ("tensor cores, 3xTF32, cluster of 8")."""
    k = cluster_split(spec, dtype)
    form = _build.lib().ssyt_os_stage_form(
        spec.c_in, spec.c_out, spec.mid, spec.h, spec.w,
        int(dtype == torch.bfloat16), k)
    if form < 0:
        raise ValueError(f"os_stage: no form of K6 for {spec} in {dtype}")
    return FORMS[form].format(k)


def os_stage(x: torch.Tensor, weights: StageWeights,
             spec: StageSpec) -> torch.Tensor:
    """One fused OSNet stage: (G, c_in, h, w) -> (G, c_out, h/2, w/2), or
    (G, c_out) for the last stage, in x's dtype (float32 or bfloat16).
    CPU tensors take :func:`os_stage_plain`; CUDA tensors launch K6 on
    any stage of :data:`KERNEL_SHAPES`, in the form :func:`stage_form`
    names: one block a crop or a cluster of :func:`cluster_split` blocks
    a crop; a failed launch raises."""
    g = x.shape[0]
    if (x.shape != (g, spec.c_in, spec.h, spec.w) or x.dtype not in _DTYPES
            or weights.mats.dtype != x.dtype
            or weights.vecs.dtype != torch.float32
            or weights.offs.dtype != torch.int32
            or weights.offs.shape != (len(_layout(spec)),)
            or spec.epilogue not in ("pool", "gap")
            or any(t.device != x.device for t in weights)):
        raise ValueError(
            f"os_stage wants x (G, {spec.c_in}, {spec.h}, {spec.w}) float32 "
            "or bfloat16 and stage_weights packed in x's dtype, on x's device"
        )
    if x.device.type == "cpu":
        return os_stage_plain(x, weights, spec)
    if x.device.type != "cuda":
        raise ValueError(f"os_stage: unsupported device {x.device}")
    shape = (spec.c_in, spec.c_out, spec.mid, spec.h * spec.w)
    if shape not in KERNEL_SHAPES or (
            spec.epilogue == "pool" and (spec.h % 2 or spec.w % 2)):
        raise ValueError(
            f"os_stage: K6 is built for the stages of OSNet x0_25, x0_5, "
            f"x0_75 and x1_0 at 128x64 crops, (c_in, c_out, mid, h*w) in "
            f"{sorted(KERNEL_SHAPES)}, not {spec}")
    out = torch.empty((g, *spec.out_shape), dtype=x.dtype, device=x.device)
    if g == 0:
        return out
    x = x.contiguous()
    err = _build.lib().ssyt_os_stage(
        x.data_ptr(), weights.mats.data_ptr(), weights.vecs.data_ptr(),
        weights.offs.data_ptr(), out.data_ptr(), g, spec.c_in, spec.c_out,
        spec.mid, spec.h, spec.w, int(spec.epilogue == "gap"),
        _DTYPES[x.dtype], cluster_split(spec, x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    os_stage.launches += 1
    _build.check(err, "os_stage")
    return out


os_stage.launches = 0
