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

Forms, chosen by dtype: bfloat16 runs the ``mma`` form
(``csrc/conv_mma.cuh``, an implicit GEMM on the tensor cores with
``wgmma``, its weights packed by :func:`pack_mma`); float32 runs the
``taps`` form (``csrc/conv_act.cuh``: a register-tiled implicit GEMM on
the CUDA cores, 8 pixels x 8 channels a thread, the tile's input slab
and the weights staged by ``cp.async``), since the tensor cores take
float32 only as TF32. The ``im2col`` form is the port of the TPU
shootout's ``_prof_conv2`` kernel, for the profiling tool and the card
checks only: in bfloat16 a GEMM on ``wgmma`` over the gathered rows
(``csrc/conv_im2col_mma.cu``, weights packed by :func:`pack_im2col`), in
float32 the CUDA-core tile over the gathered rows. The ``taps`` form
also takes bfloat16, with float32 products.

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
FORMS = ("taps", "im2col", "mma")
MMA_N_TILES = (16, 32, 64, 80, 128)  # output channels of one wgmma (N)
CORE_N_TILES = (32, 64, 80, 128)  # output channels of a CUDA-core block
# csrc/conv_act.cuh's tiling, which the CPU tests emulate: the taps form's
# output tile (rows, columns) and a block's output pixels
CORE_TILE = (8, 16)
CORE_M = 128
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


def default_form(dtype: torch.dtype) -> str:
    """The form K7 runs for ``dtype``: ``mma`` (tensor cores) for
    bfloat16, ``taps`` (CUDA cores) for float32."""
    return "mma" if dtype == torch.bfloat16 else "taps"


def mma_n_tile(c_out: int) -> int:
    """Output channels per block of the ``mma`` form: the smallest wgmma
    width in :data:`MMA_N_TILES` that holds ``c_out``, else the largest
    (then the grid loops over chunks of it)."""
    return next((n for n in MMA_N_TILES if n >= c_out), MMA_N_TILES[-1])


def core_n_tile(c_out: int) -> int:
    """Output channels per block of the CUDA-core forms (``taps``, and
    ``im2col`` in float32): the smallest of :data:`CORE_N_TILES` that
    holds ``c_out``, else the largest (then the grid loops over them)."""
    return next((n for n in CORE_N_TILES if n >= c_out), CORE_N_TILES[-1])


def core_chunk(k: int, form: str, dtype: torch.dtype) -> int:
    """The K chunk of the CUDA-core forms, staged per step (``Cfg::CK``
    of ``csrc/conv_act.cuh``): ``taps`` input channels (each with its
    k * k taps; 4 for k = 3, 16 for k = 1 in float32 and 8 in bfloat16),
    ``im2col`` entries of the row (16)."""
    if form == "im2col":
        return 16
    return 4 if k == 3 else (16 if dtype == torch.float32 else 8)


def mma_chunks(c_in: int, k: int) -> int:
    """16-channel chunks of the ``mma`` form's packed weights: C_in
    padded to a whole number of the kernel's stages, 64 input channels
    for k = 1 and 16 for k = 3."""
    stage = 64 if k == 1 else 16
    return -(-c_in // stage) * stage // 16


def pack_mma(w: torch.Tensor, k: int) -> torch.Tensor:
    """The ``(k * k * C_in, C_out)`` weight, rounded to bfloat16, as the
    ``mma`` form stages it: ``(C_in_pad / 16, k * k, 2, N_pad, 8)``, zero
    where C_in is padded (to a multiple of 16 for k = 3, of 64 for k = 1:
    a whole number of the kernel's stages) and where C_out is padded to a
    multiple of :func:`mma_n_tile`. Per 16-channel chunk and tap, two
    (N_pad, 8) planes of 8 input channels each: wgmma's no-swizzle
    K-major layout of B, 8 output channels x 8 input channels to a
    128-byte core matrix."""
    c_out = w.shape[1]
    c_in = w.shape[0] // (k * k)
    n_tile = mma_n_tile(c_out)
    n_pad = -(-c_out // n_tile) * n_tile
    ci_pad = 16 * mma_chunks(c_in, k)
    blob = torch.zeros((k * k, ci_pad, n_pad), dtype=torch.bfloat16,
                       device=w.device)
    blob[:, :c_in, :c_out] = w.reshape(k * k, c_in, c_out).to(torch.bfloat16)
    return (blob.reshape(k * k, ci_pad // 16, 2, 8, n_pad)
            .permute(1, 0, 2, 4, 3).contiguous())


def unpack_mma(blob: torch.Tensor, k: int, c_in: int, c_out: int) -> torch.Tensor:
    """The inverse of :func:`pack_mma`: -> ``(k * k * C_in, C_out)``."""
    chunks, _, _, n_pad, _ = blob.shape
    w = blob.permute(1, 0, 2, 4, 3).reshape(k * k, chunks * 16, n_pad)
    return w[:, :c_in, :c_out].reshape(k * k * c_in, c_out)


def pack_im2col(w: torch.Tensor) -> torch.Tensor:
    """The ``(k * k * C_in, C_out)`` weight, rounded to bfloat16, as the
    bfloat16 ``im2col`` form stages it: its rows are the gathered row's
    entries in (ky, kx, ci) order, so it is :func:`pack_mma` of a 1x1
    conv of k * k * C_in input channels, ``(K_pad / 16, 1, 2, N_pad,
    8)``, zero past the row (K_pad a multiple of 64: whole stages of the
    kernel's 32 entries) and past C_out (N_pad a multiple of
    :func:`mma_n_tile`). :func:`unpack_mma` with k = 1 inverts it."""
    return pack_mma(w, 1)


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
                    form: str | None = None,
                    packed: torch.Tensor | None = None) -> torch.Tensor:
    """K7 on a CUDA tensor, without autograd; a CPU tensor takes the plain
    version (every form computes the same function). ``form`` None is
    :func:`default_form` of x's dtype; ``"mma"`` takes bfloat16 only and
    uses ``packed`` (:func:`pack_mma` of ``w``) where given, else packs
    ``w`` itself; so does ``"im2col"`` in bfloat16 with
    :func:`pack_im2col`."""
    c_in, c_out = _check(x, w, b, k, layout)
    form = default_form(x.dtype) if form is None else form
    if form not in FORMS:
        raise ValueError(f"conv_act: form must be one of {FORMS}, got {form!r}")
    if form == "mma" and x.dtype != torch.bfloat16:
        raise ValueError(f"conv_act: the mma form takes bfloat16 (the tensor "
                         f"cores take float32 only as TF32), got {x.dtype}")
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
    bk = b.float().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if form == "mma" or (form == "im2col" and x.dtype == torch.bfloat16):
        # im2col's K is the weight's k*k*C_in rows: packed as a 1x1 conv's
        kk, rows = (k, c_in) if form == "mma" else (1, k * k * c_in)
        blob = pack_mma(w, kk) if packed is None else packed
        if (blob.dtype != torch.bfloat16 or blob.device != x.device
                or not blob.is_contiguous()
                or blob.shape[:3] != (mma_chunks(rows, kk), kk * kk, 2)
                or blob.shape[3] % mma_n_tile(c_out) or blob.shape[3] < c_out):
            raise ValueError(f"conv_act: packed weights {tuple(blob.shape)} "
                             f"{blob.dtype} are not the {form} packing of a "
                             f"k={k} {c_in}->{c_out} weight on {x.device}")
        entry = (_build.lib().ssyt_conv_mma if form == "mma"
                 else _build.lib().ssyt_conv_im2col_mma)
        err = entry(x.data_ptr(), blob.data_ptr(), bk.data_ptr(),
                    out.data_ptr(), n, h, wd, c_in, c_out, *sx, *so, k,
                    int(act), mma_n_tile(c_out), blob.shape[3], blob.shape[0],
                    stream)
    else:  # the CUDA-core forms: float32 weights rounded to x's dtype
        wk = w.to(x.dtype).float().contiguous()
        err = _build.lib().ssyt_conv_act(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            n, h, wd, c_in, c_out, *sx, *so, k, int(act), FORMS.index(form),
            _DTYPES[x.dtype], core_n_tile(c_out), stream)
    conv_act.launches += 1
    _build.check(err, "conv_act")
    return out


class _ConvAct(torch.autograd.Function):
    """Forward: K7 in the form of x's dtype (the plain version on the
    CPU). Backward: the autograd of the plain formulation, as the JAX
    custom VJP derives its gradient from ``_conv_ref``; there is no
    backward kernel."""

    @staticmethod
    def forward(ctx, x, w, b, k, act, layout, packed):
        ctx.save_for_backward(x, w, b)
        ctx.conf = (k, act, layout)
        return conv_act_kernel(x, w, b, k=k, act=act, layout=layout,
                               packed=packed)

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
                None, None, None, None)


def conv_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
             k: int, act: bool) -> torch.Tensor:
    """The JAX ``conv_act``: NHWC ``x`` (N, H, W, C_in), ``w`` (k * k *
    C_in, C_out) HWIO flattened, ``b`` (C_out,) -> (N, H, W, C_out) in x's
    dtype, differentiable. CUDA tensors launch K7 in the form of x's dtype
    (:func:`default_form`; the ``mma`` form packs ``w`` per call); CPU
    tensors take :func:`conv_act_plain`."""
    return _ConvAct.apply(x, w, b, k, act, "nhwc", None)


def conv_act_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  k: int, act: bool,
                  packed: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`conv_act` on the model's NCHW activations -> (N, C_out, H,
    W): the route of ``Pipeline(conv_kernel=True)``, which passes
    ``packed``, :func:`pack_mma` of ``w`` cached per conv, for bfloat16."""
    return _ConvAct.apply(x, w, b, k, act, "nchw", packed)


conv_act.launches = 0
