"""K7: the fused 'same' stride-1 conv + float32 bias + optional SiLU
(``csrc/conv_act.cu``), its wrapper :func:`conv_act` (an autograd
function), its plain PyTorch version :func:`conv_act_plain`, and the rule
for which convs take it, :func:`eligible`.

Replaces ``tools/prof/conv_kernel.py``: ``pallas_conv_act`` (body
``_conv_kernel``, nine shifted products with the border masked, the
``taps`` form here) with its custom VJP, and ``tools/prof/_prof_conv2.py``:
``call`` with ``_kernel_im2col`` (one product over the gathered 9 * C_in
row, the ``im2col`` form here; its ``_kernel_dy3`` is the same function
summed in another grouping). Its two cost probes with wrong numerics
(``_kernel_dots``, ``_kernel_dot1``) are not ported: the bound computed
from the shapes takes their place.

What it computes, as the TPU kernel does: y = SiLU?(conv_same(x, w) + b),
k in {1, 3}, stride 1, groups 1; the weights rounded to x's dtype, the
products summed in float32, the bias added and the SiLU applied in
float32, then one cast to x's dtype. The model's default ``Conv`` (and
the JAX ``conv_apply``) rounds the bf16 conv output before it adds the
bias, so in bf16 the route gives slightly other detections by design.

Layouts: the public :func:`conv_act` keeps the JAX signature, NHWC ``x``
and a ``(k * k * C_in, C_out)`` weight flattened over (ky, kx, ci) as
HWIO; :func:`conv_act_nchw` takes the model's NCHW activations. The
kernel reads ``x`` and writes the output through their strides, so
neither layout costs a transposing copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FORMS = ("taps", "im2col")
VMEM_BUDGET = 72 * 1024 * 1024  # the TPU kernel's whole-plane budget


def _lanes(c: int) -> int:
    """The TPU's 128-lane padding of a channel count."""
    return -(-c // 128) * 128


def _block_bytes(n_img: int, h: int, w: int, c_in: int, c_out: int) -> int:
    """The TPU kernel's peak VMEM estimate for one block of ``n_img``
    whole planes (its tap temporaries, lane-padded)."""
    return n_img * h * w * (24 * _lanes(c_in) + 10 * _lanes(c_out))


def eligible(x_shape, k: int, stride: int, groups: int, dilation: int) -> bool:
    """The convs the kernel takes over: the JAX package's rule, clause for
    clause, its TPU VMEM clause included, so that both packages pick the
    same convs. ``x_shape`` is NHWC, (n, h, w, c_in): from an NCHW tensor
    pass ``(n, h, w, c)``."""
    if k not in (1, 3) or stride != 1 or groups != 1 or dilation != 1:
        return False
    n, h, w, c_in = x_shape
    if (h * w) % 8 != 0 or h < 3 or w < 3:
        return False
    if h * w < 1600 or c_in > 192:
        return False
    return _block_bytes(1, h, w, c_in, 128) <= VMEM_BUDGET


def _check(x, w, b, k: int, layout: str) -> tuple[int, int]:
    """-> (c_in, c_out); raises on what K7 does not take."""
    if k not in (1, 3) or layout not in ("nhwc", "nchw"):
        raise ValueError(f"conv_act: k must be 1 or 3 and layout nhwc or "
                         f"nchw, got k={k}, layout={layout!r}")
    c_in = x.shape[3] if layout == "nhwc" else x.shape[1]
    if (x.dim() != 4 or x.dtype not in _DTYPES or w.dim() != 2
            or w.shape[0] != k * k * c_in or b.shape != (w.shape[1],)):
        raise ValueError(
            f"conv_act wants x (N, H, W, C_in) ({layout}) float32 or "
            f"bfloat16, w ({k}*{k}*C_in, C_out) and b (C_out,); got "
            f"{tuple(x.shape)} {x.dtype}, {tuple(w.shape)}, {tuple(b.shape)}")
    return c_in, w.shape[1]


def conv_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   k: int, act: bool, layout: str = "nhwc") -> torch.Tensor:
    """The plain version, rounding where K7 rounds: the conv in float32
    on x and on w rounded to x's dtype, + float32 bias, SiLU as
    ``y * sigmoid(y)``, one cast to x's dtype. Same layout out as in."""
    c_in, c_out = _check(x, w, b, k, layout)
    w4 = (w.to(x.dtype).float().reshape(k, k, c_in, c_out)
          .permute(3, 2, 0, 1))  # OIHW
    xf = x.float() if layout == "nchw" else x.float().permute(0, 3, 1, 2)
    y = F.conv2d(xf, w4, None, 1, (k - 1) // 2) + b.float()[:, None, None]
    if act:
        y = y * torch.sigmoid(y)
    y = y.to(x.dtype)
    return y if layout == "nchw" else y.permute(0, 2, 3, 1)


def conv_act_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int, act: bool, layout: str = "nhwc",
                    form: str = "taps") -> torch.Tensor:
    """K7 on a CUDA tensor (``form``: ``"taps"``, the route's, or
    ``"im2col"``), without autograd; a CPU tensor takes the plain
    version (both forms compute the same function)."""
    c_in, c_out = _check(x, w, b, k, layout)
    if form not in FORMS:
        raise ValueError(f"conv_act: form must be one of {FORMS}, got {form!r}")
    if x.device.type == "cpu":
        return conv_act_plain(x, w, b, k=k, act=act, layout=layout)
    if x.device.type != "cuda":
        raise ValueError(f"conv_act: unsupported device {x.device}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv_act: x, w and b must be on one device")
    if layout == "nhwc":
        n, h, wd, _ = x.shape
        out = torch.empty((n, h, wd, c_out), dtype=x.dtype, device=x.device)
        sx = (x.stride(0), x.stride(3), x.stride(1), x.stride(2))
        so = (out.stride(0), out.stride(3), out.stride(1), out.stride(2))
    else:
        n, _, h, wd = x.shape
        out = torch.empty((n, c_out, h, wd), dtype=x.dtype, device=x.device)
        sx, so = x.stride(), out.stride()
    if out.numel() == 0:
        return out
    wk = w.to(x.dtype).contiguous()
    bk = b.float().contiguous()
    err = _build.lib().ssyt_conv_act(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
        n, h, wd, c_in, c_out, *sx, *so, k, int(act), FORMS.index(form),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    conv_act.launches += 1
    _build.check(err, "conv_act")
    return out


class _ConvAct(torch.autograd.Function):
    """Forward: K7 (the plain version on the CPU). Backward: the autograd
    of the plain formulation, as the JAX custom VJP derives its gradient
    from ``_conv_ref``; there is no backward kernel."""

    @staticmethod
    def forward(ctx, x, w, b, k, act, layout):
        ctx.save_for_backward(x, w, b)
        ctx.conf = (k, act, layout)
        return conv_act_kernel(x, w, b, k=k, act=act, layout=layout)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        k, act, layout = ctx.conf
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((x, w, b), ctx.needs_input_grad[:3])]
            y = conv_act_plain(*leaves, k=k, act=act, layout=layout)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None, None, None)


def conv_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
             k: int, act: bool) -> torch.Tensor:
    """The JAX ``conv_act``: NHWC ``x`` (N, H, W, C_in), ``w`` (k * k *
    C_in, C_out) HWIO flattened, ``b`` (C_out,) -> (N, H, W, C_out) in x's
    dtype, differentiable. CUDA tensors launch K7 (``taps``); CPU tensors
    take :func:`conv_act_plain`."""
    return _ConvAct.apply(x, w, b, k, act, "nhwc")


def conv_act_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  k: int, act: bool) -> torch.Tensor:
    """:func:`conv_act` on the model's NCHW activations -> (N, C_out, H,
    W): the route of ``Pipeline(conv_kernel=True)``."""
    return _ConvAct.apply(x, w, b, k, act, "nchw")


conv_act.launches = 0
