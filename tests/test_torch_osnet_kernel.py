"""K6's plain version (``ops/cuda/osnet_kernel.os_stage_plain``) and the
port's fused OSNet route against the JAX package's fused stage kernel
(``ops/pallas/osnet_kernel.os_stage``, run in interpret mode), on the same
seeded inputs and the same weights (JAX-initialised, and the trained
``assets/osnet_x0_25_synth.npz``, through the port's converter).

Tolerances:

- one stage in float32: within 1e-4 absolute (the JAX package holds its
  kernel to 2e-4); sums run in another order (measured: 3.4e-05 at
  outputs up to 48);
- one stage in bfloat16, with the port's packed weights: the mean
  absolute difference within 2e-4 of the largest output. Measured on
  these inputs: 1.6e-05, 1.1e-04 and 0 of it for the three stages (a
  float32 sum in another order, or a BN scale one unit in the last place
  apart, flips some bf16 roundings: 2%, 15% and 0% of the outputs, by
  one unit). Tap weights rounded to bf16, which the TPU kernel keeps in
  float32, give 4.4e-04, 5.7e-04 and 3.9e-04: the bound fails them;
- the whole embedding, fused route against the JAX fused route: float32
  within 5e-4; bfloat16 cosine >= 0.999 averaged over the crops and >=
  0.998 on every crop (measured, trained weights: 0.99932 and 0.99889;
  JAX-initialised: 0.99997 and 0.99981). That is the bf16 noise floor,
  not a fault of the stages: against the float32 embedding every bf16
  route lands at a least cosine of 0.9974-0.9988 on these crops, and the
  two stems round differently (the port normalises in float32 and casts,
  the JAX package folds the normalisation into its bf16 stem conv). The
  port's fused route against its own unfused one in bfloat16: cosine >=
  0.995 on every crop, the JAX package's bar for its kernel (measured
  0.99852). The crops hold whole multiples of 1/255, as crops of uint8
  frames do.

A mutation test shows the bounds can fail: mirrored stencil taps and a
stream whose gate is skipped break the float32 bound, bf16-rounded tap
weights the bfloat16 one.

The wider widths K6 also takes (x0_5 and x1_0, JAX-initialised, G = 2
crops per call in interpret mode, whose cost grows with the width):

- float32 within the bound above scaled with the output, 1e-4 for every
  48 of the largest output (the bound was set at outputs up to 48; the
  float32 rounding grows with the output: measured 1.3e-04 at 156 for
  x0_5 stage 2, 1.4e-04 at 169 for x1_0, about 8e-7 of the largest
  output at every width);
- bfloat16 at x0_5 within the bound above (measured 1.6e-05, 5.4e-07
  and 0 of the largest output), which bf16-rounded taps break at every
  stage (the mutation test below); at x1_0 the packed bf16 weights
  themselves differ from the JAX fold's where the two BN folds land one
  float32 unit apart, and the mean difference is 2.8e-04 to 3.1e-04 on
  every stage, about what bf16-rounded taps give there: x1_0 is held
  within 4e-4 of the largest output, a bar for gross faults only; the
  bit-level check of K6 at every width is on the card, against this
  plain version;
- one whole x0_5 embedding, fused, against the JAX fused route on 2
  crops (one of them smooth), with the whole-embedding bars above.

K6's float32 forms run the 1x1 products as 3xTF32 on the tensor cores;
an emulation (each operand split into TF32 hi and lo, lo.lo dropped,
8-wide K chunks, the gate's mean per band where the stage is split over
a cluster) is held to the JAX float32 stage within F32_TOL (x0_25's
three stages; x0_5 stage 3 and x1_0 stage 2, split over 4 and 8 blocks,
within the wider widths' float32 bar) and to the plain version within
the card's 1e-4; TF32 alone misses that bar.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.models import osnet as josnet
from strongsort_yolo_tpu.ops.pallas import osnet_kernel as jk
from strongsort_yolo_tpu_torch.models.osnet import (
    OsnetConfig,
    osnet_from_state_dict,
)
from strongsort_yolo_tpu_torch.models.porting import osnet_params_from_jax
from strongsort_yolo_tpu_torch.ops.cuda import osnet_kernel as tk

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
SPECS = tk.stage_specs(OsnetConfig().channels)
BLOCKS = (("b2", "t2"), ("b3", "t3"), ("b4", "conv5"))
G = 8  # crops per stage call: one TPU tile
F32_TOL = 1e-4
BF16_MEAN_TOL = 2e-4  # of the largest output
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(josnet.init_osnet(jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def model(jparams):
    return osnet_from_state_dict(osnet_params_from_jax(jparams, OsnetConfig()))


def _stage_input(i):
    spec = SPECS[i]
    return np.random.default_rng(i).normal(
        0, 1, (G, spec.c_in, spec.h, spec.w)).astype(np.float32)


_JAX_STAGES = {}


def _jax_stage(jparams, i, dt):
    """JAX os_stage in interpret mode, cached per stage and dtype."""
    if (i, dt) not in _JAX_STAGES:
        spec, (blk, ep) = SPECS[i], BLOCKS[i]
        jspec = jk.StageSpec(**dataclasses.asdict(spec))
        jdt = DTYPES[dt][1]
        folded = jk.fold_stage(jparams[blk + "a"], jparams[blk + "b"],
                               jparams[ep], jspec, wdtype=jdt, tm=8)
        out = jk.os_stage(jnp.asarray(_stage_input(i), jdt), folded,
                          spec=jspec, tm=8, interpret=True)
        _JAX_STAGES[i, dt] = np.asarray(out.astype(jnp.float32))
    return _JAX_STAGES[i, dt]


def _port_stage(weights, i, dt):
    x = torch.from_numpy(_stage_input(i)).to(DTYPES[dt][0])
    return tk.os_stage_plain(x, weights, SPECS[i]).float().numpy()


def _bf16_mean_err(got, want) -> float:
    return float(np.abs(got - want).mean() / np.abs(want).max())


@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_stage_plain_vs_jax(jparams, model, i, dt):
    want = _jax_stage(jparams, i, dt)
    weights = tk.stage_weights(model, i, DTYPES[dt][0])
    got = _port_stage(weights, i, dt)
    assert got.shape == want.shape == (G, *SPECS[i].out_shape)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        assert _bf16_mean_err(got, want) <= BF16_MEAN_TOL


def _mirror_taps(v):
    for k, t in v.items():
        if k.endswith(".taps"):
            t.copy_(t.flip(0))


def _round_taps(v):
    for k, t in v.items():
        if k.endswith(".taps"):
            t.copy_(t.to(torch.bfloat16).float())


@pytest.mark.parametrize("mutation", ["mirrored_taps", "skipped_gate",
                                      "bf16_taps"])
def test_mutations_break_the_bounds(jparams, model, monkeypatch, mutation):
    """Each wrong variant of the plain version, against the JAX kernel,
    must fail the bound its dtype is held to, at every stage."""
    dt = "bf16" if mutation == "bf16_taps" else "f32"
    for i, spec in enumerate(SPECS):
        w = tk.stage_weights(model, i, DTYPES[dt][0])
        w = tk.StageWeights(w.mats, w.vecs.clone(), w.offs)
        if mutation == "mirrored_taps":
            _mirror_taps(tk._views(w, spec))
        elif mutation == "bf16_taps":
            _round_taps(tk._views(w, spec))
        else:  # the second stream of each block goes ungated
            gate, calls = tk._gate, []

            def skip_second(s, v, blk, dt_, gate=gate, calls=calls):
                calls.append(blk)
                return s if len(calls) % 4 == 2 else gate(s, v, blk, dt_)

            monkeypatch.setattr(tk, "_gate", skip_second)
        got = _port_stage(w, i, dt)
        monkeypatch.undo()
        want = _jax_stage(jparams, i, dt)
        if dt == "f32":
            assert np.abs(got - want).max() > F32_TOL, (mutation, i)
        else:
            assert _bf16_mean_err(got, want) > BF16_MEAN_TOL, (mutation, i)


F32_SCALE = 48.0  # the output scale F32_TOL was set at
WIDE_G = 2  # crops per stage call at the wider widths (one TPU tile, tm=2)
WIDE_BF16_MEAN_TOL = {"osnet_x0_5": BF16_MEAN_TOL, "osnet_x0_75": BF16_MEAN_TOL,
                      "osnet_x1_0": 4e-4}
WIDE_PLAIN_VARIANTS = ("osnet_x0_5", "osnet_x1_0")  # every stage vs JAX


@pytest.fixture(scope="module")
def wide():
    """variant -> (JAX params, the port's folded model), JAX-initialised."""
    out = {}
    for variant in WIDE_BF16_MEAN_TOL:
        jp = jax.device_get(josnet.init_osnet(
            jax.random.PRNGKey(7), josnet.OsnetConfig(variant=variant)))
        cfg = OsnetConfig(variant=variant)
        out[variant] = (jp, osnet_from_state_dict(osnet_params_from_jax(jp, cfg),
                                                  cfg))
    return out


_WIDE_JAX = {}


def _wide_stage(wide, variant, i, dt):
    """(spec, input, the JAX os_stage output in interpret mode), cached
    per width, stage and dtype."""
    jp, _ = wide[variant]
    spec = tk.stage_specs(OsnetConfig(variant=variant).channels)[i]
    x = np.random.default_rng(i).normal(
        0, 1, (WIDE_G, spec.c_in, spec.h, spec.w)).astype(np.float32)
    if (variant, i, dt) not in _WIDE_JAX:
        blk, ep = BLOCKS[i]
        jspec = jk.StageSpec(**dataclasses.asdict(spec))
        jdt = DTYPES[dt][1]
        folded = jk.fold_stage(jp[blk + "a"], jp[blk + "b"], jp[ep], jspec,
                               wdtype=jdt, tm=WIDE_G)
        _WIDE_JAX[variant, i, dt] = np.asarray(jk.os_stage(
            jnp.asarray(x, jdt), folded, spec=jspec, tm=WIDE_G,
            interpret=True).astype(jnp.float32))
    return spec, x, _WIDE_JAX[variant, i, dt]


@pytest.mark.parametrize("variant", WIDE_PLAIN_VARIANTS)
@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_stage_plain_vs_jax_wider_widths(wide, variant, i, dt):
    """K6's plain version against the JAX os_stage (interpret mode) at
    the widths K6 takes beside x0_25, stage by stage."""
    spec, x, want = _wide_stage(wide, variant, i, dt)
    got = tk.os_stage_plain(torch.from_numpy(x).to(DTYPES[dt][0]),
                            tk.stage_weights(wide[variant][1], i,
                                             DTYPES[dt][0]),
                            spec).float().numpy()
    assert got.shape == want.shape == (WIDE_G, *spec.out_shape)
    if dt == "f32":
        tol = F32_TOL * max(1.0, float(np.abs(want).max()) / F32_SCALE)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        assert _bf16_mean_err(got, want) <= WIDE_BF16_MEAN_TOL[variant]


def test_bf16_taps_break_the_x0_5_bound(wide):
    """The x0_5 bfloat16 bound fails bf16-rounded tap weights at every
    stage, as at x0_25."""
    for i in range(3):
        spec, x, want = _wide_stage(wide, "osnet_x0_5", i, "bf16")
        w = tk.stage_weights(wide["osnet_x0_5"][1], i, torch.bfloat16)
        w = tk.StageWeights(w.mats, w.vecs.clone(), w.offs)
        _round_taps(tk._views(w, spec))
        got = tk.os_stage_plain(torch.from_numpy(x).bfloat16(), w,
                                spec).float().numpy()
        assert _bf16_mean_err(got, want) > BF16_MEAN_TOL, i


def test_fused_x0_5_embedding_vs_jax_fused(wide):
    """One whole OSNet-x0_5 embedding through the port's fused route
    against the JAX osnet_apply(fused=True) in interpret mode, with the
    whole-embedding bars of test_fused_osnet_vs_jax_fused."""
    cfg = OsnetConfig(variant="osnet_x0_5")
    params = wide[cfg.variant][0]
    sd = osnet_params_from_jax(params, cfg)
    crops = _crops(2)
    model = osnet_from_state_dict(sd, cfg)
    model.use_fused_stages(torch.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(crops).permute(0, 3, 1, 2)
                           .contiguous()).numpy()
    want = np.asarray(josnet.osnet_apply(params, jnp.asarray(crops),
                                         fused=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    model16 = osnet_from_state_dict(sd, cfg)
    model16.use_fused_stages(torch.bfloat16)
    with torch.no_grad():
        got16 = model16.to(dtype=torch.bfloat16).eval()(
            torch.from_numpy(crops).permute(0, 3, 1, 2).contiguous()).numpy()
    want16 = np.asarray(josnet.osnet_apply(
        params, jnp.asarray(crops), compute_dtype=jnp.bfloat16, fused=True,
        interpret=True))
    cos = (got16 * want16).sum(-1)
    assert cos.mean() >= 0.999 and cos.min() >= 0.998, cos


def _jax_tree(source):
    if source == "init":
        return jax.device_get(josnet.init_osnet(jax.random.PRNGKey(3)))
    return jax.device_get(josnet.load_osnet_npz(NPZ)[0])


def _crops(m=8):
    """m crops in whole multiples of 1/255, one of them smooth."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (m, 128, 64, 3)).astype(np.float32)
    x[1] = np.round(np.linspace(50, 230, 128))[:, None, None]
    return x / np.float32(255.0)


def _port_embed(sd, crops, dt, fused: bool):
    model = osnet_from_state_dict(sd, OsnetConfig())
    if fused:
        model.use_fused_stages(dt)  # packed from float32, before the cast
    model = model.to(dtype=dt).eval()
    inp = torch.from_numpy(crops).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        return model(inp).numpy()


@pytest.mark.parametrize("source", ["init", "trained"])
def test_fused_osnet_vs_jax_fused(source):
    params = _jax_tree(source)
    sd = osnet_params_from_jax(params, OsnetConfig())
    crops = _crops()
    want = np.asarray(josnet.osnet_apply(params, jnp.asarray(crops),
                                         fused=True, interpret=True))
    got = _port_embed(sd, crops, torch.float32, fused=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)

    want16 = np.asarray(josnet.osnet_apply(
        params, jnp.asarray(crops), compute_dtype=jnp.bfloat16, fused=True,
        interpret=True))
    got16 = _port_embed(sd, crops, torch.bfloat16, fused=True)
    cos = (got16 * want16).sum(-1)
    assert cos.mean() >= 0.999 and cos.min() >= 0.998, cos
    # and against the port's own unfused bf16 route
    plain16 = _port_embed(sd, crops, torch.bfloat16, fused=False)
    assert (got16 * plain16).sum(-1).min() >= 0.995


def test_stage_weights_layout(model):
    """The packed blobs: matrices in the compute dtype, biases and taps in
    float32 whatever the dtype; the second OS block has no ``down``;
    packing a cast model is refused."""
    for i, spec in enumerate(SPECS):
        w32 = tk.stage_weights(model, i, torch.float32)
        w16 = tk.stage_weights(model.state_dict(), i, torch.bfloat16)
        assert w16.mats.dtype == torch.bfloat16 and w16.vecs.dtype == torch.float32
        assert torch.equal(w16.vecs, w32.vecs) and torch.equal(w16.offs, w32.offs)
        assert torch.equal(w16.mats, w32.mats.to(torch.bfloat16))
        v = tk._views(w32, spec)
        assert "a.wd" in v and "b.wd" not in v
        assert len(w32.offs) == 102 and int(w32.offs[tk._B_WD]) == -1
        assert v["a.l9.taps"].shape == (9, spec.mid)
    blk = "b3a.streams.3.2.dw.w"
    taps = tk._views(tk.stage_weights(model, 1, torch.float32),
                     SPECS[1])["a.l8.taps"]
    assert torch.equal(taps[1], model.state_dict()[blk][:, 0, 0, 1])
    with pytest.raises(ValueError, match="float32"):
        tk.stage_weights(model.state_dict() | {
            "stem.w": model.stem.w.detach().bfloat16()}, 0, torch.bfloat16)
    assert [dataclasses.astuple(s) for s in SPECS] == [
        dataclasses.astuple(s) for s in jk.stage_specs((16, 64, 96, 128))]


def test_os_stage_wrapper_on_cpu(model):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; it refuses a wrong shape or mismatched dtypes."""
    spec = SPECS[2]
    w = tk.stage_weights(model, 2, torch.float32)
    x = torch.from_numpy(_stage_input(2))
    before = tk.os_stage.launches
    assert torch.equal(tk.os_stage(x, w, spec), tk.os_stage_plain(x, w, spec))
    assert tk.os_stage.launches == before
    with pytest.raises(ValueError):
        tk.os_stage(x[:, :10], w, spec)
    with pytest.raises(ValueError):
        tk.os_stage(x.bfloat16(), w, spec)


# --- K6's tensor-core form, emulated on the CPU -----------------------



def _pointwise_chunked(w, x, b):
    """(co, ci) @ (G, ci, P) + (co,) as the tensor-core form sums it:
    the bf16 operands' products summed in float32 per 16-wide K chunk,
    the chunks added in order (a K of 24 is a chunk of 16 and one of 8,
    the rest of it zero), then + b."""
    acc = None
    for k0 in range(0, w.shape[1], 16):
        part = torch.matmul(w[:, k0:k0 + 16].float(), x[:, k0:k0 + 16].float())
        acc = part if acc is None else acc + part
    return acc + b[:, None]


def _tc_emulated(x, weights, spec, monkeypatch, per_crop=False):
    """The stage as the tensor-core form computes it: the 1x1 products in
    16-wide chunks, every rounding point of os_stage_plain; with
    ``per_crop`` one crop at a time, as a block of the form takes it."""
    monkeypatch.setattr(tk, "_pointwise", _pointwise_chunked)
    if per_crop:
        out = torch.cat([tk.os_stage_plain(x[g:g + 1], weights, spec)
                         for g in range(x.shape[0])])
    else:
        out = tk.os_stage_plain(x, weights, spec)
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tensor_core_emulation_vs_jax(jparams, model, monkeypatch, i, dt):
    """The emulated tensor-core form against the JAX os_stage (interpret
    mode), within the bars the plain version is held to; in bfloat16
    also against os_stage_plain, within the card's bar (the same mean
    bar)."""
    want = _jax_stage(jparams, i, dt)
    w = tk.stage_weights(model, i, DTYPES[dt][0])
    x = torch.from_numpy(_stage_input(i)).to(DTYPES[dt][0])
    got = _tc_emulated(x, w, SPECS[i], monkeypatch)
    assert got.shape == (G, *SPECS[i].out_shape)
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        assert _bf16_mean_err(got, want) <= BF16_MEAN_TOL
        _assert_tc_bar(got, tk.os_stage_plain(x, w, SPECS[i]).float().numpy())


def _assert_tc_bar(got, want):
    assert _bf16_mean_err(got, want) <= BF16_MEAN_TOL


def _pointwise_exact(w, x, b):
    """The 1x1 products summed exactly (float64), rounded once to
    float32, then + b."""
    return torch.matmul(w.double(), x.double()).float() + b[:, None]


def test_exact_sums_break_two_bf16_units(model, monkeypatch):
    """Why the card's bar is not "within two bf16 units": the plain
    version with exact sums, against itself with float32 sums, moves
    some output of stage 3 by more than two bf16 units at 1.0 x max(1,
    |ref|) (a flipped rounding of a gate value moves a whole channel),
    and stays within the mean bar at every stage."""
    worst = 0.0
    for i, spec in enumerate(SPECS):
        w = tk.stage_weights(model, i, torch.bfloat16)
        x = torch.from_numpy(_stage_input(i)).bfloat16()
        want = tk.os_stage_plain(x, w, spec).float().numpy()
        monkeypatch.setattr(tk, "_pointwise", _pointwise_exact)
        got = tk.os_stage_plain(x, w, spec).float().numpy()
        monkeypatch.undo()
        _assert_tc_bar(got, want)
        worst = max(worst, float((np.abs(got - want)
                                  / np.maximum(1.0, np.abs(want))).max()))
    assert worst > 2.0 ** -6


def test_tensor_core_emulation_per_crop(model, monkeypatch):
    """One crop per block, as the form runs: stage 4 crop by crop equals
    the whole batch bit for bit (crops never mix)."""
    spec = SPECS[2]
    w = tk.stage_weights(model, 2, torch.bfloat16)
    x = torch.from_numpy(_stage_input(2)).bfloat16()
    assert torch.equal(_tc_emulated(x, w, spec, monkeypatch, per_crop=True),
                       _tc_emulated(x, w, spec, monkeypatch))


# --- K6's cluster form, emulated on the CPU ----------------------------

# (variant, stage index): the stages bfloat16 splits over a cluster of
# blocks a crop (tk.CLUSTER_SPLIT)
CLUSTER_STAGES = [("osnet_x0_5", 0), ("osnet_x0_75", 0), ("osnet_x1_0", 0),
                  ("osnet_x1_0", 1)]


def _gate_mean_banded(k):
    """The gate's mean as the cluster form takes it: each of k bands of
    whole rows sums its pixels in float32 (in order: the result must not
    depend on G), then the k sums are added in rank order 0 .. k-1 and
    divided by the crop's pixels."""
    def mean(s):
        g, c, p = s.shape
        bands = s.float().reshape(g, c, k, p // k)
        part = bands[..., 0]
        for q in range(1, p // k):
            part = part + bands[..., q]
        total = part[..., 0]
        for j in range(1, k):
            total = total + part[..., j]
        return total / p
    return mean


def _cluster_emulated(x, weights, spec, monkeypatch, per_crop=False):
    """The stage as the cluster form computes it: the tensor-core form's
    16-wide chunks (each band's 1x1 products are its own pixels'), the
    gate's mean summed per band and then in rank order, at the split the
    wrapper takes (tk.cluster_split)."""
    monkeypatch.setattr(tk, "_gate_mean",
                        _gate_mean_banded(tk.cluster_split(spec, torch.bfloat16)))
    return _tc_emulated(x, weights, spec, monkeypatch, per_crop)


def test_cluster_split_is_whole_even_rows():
    """In bfloat16 exactly the four stages of CLUSTER_STAGES split a crop,
    in float32 the seven of F32_CLUSTER_STAGES (every stage but x0_25's
    stage 3 and the stage 4s), each into bands of an even number of whole
    rows (the 2x2 pool stays in a band) and a multiple of 32 pixels (the
    tensor-core units' rows), over at most 8 blocks (the portable
    cluster size)."""
    for dtype, stages in ((torch.bfloat16, CLUSTER_STAGES),
                          (torch.float32, F32_CLUSTER_STAGES)):
        split = set()
        for variant in WIDE_BF16_MEAN_TOL | {"osnet_x0_25": None}:
            for i, spec in enumerate(
                    tk.stage_specs(OsnetConfig(variant=variant).channels)):
                k = tk.cluster_split(spec, dtype)
                if k > 1:
                    split.add((variant, i))
                    assert k in (2, 4, 8) and spec.epilogue == "pool"
                    assert spec.h % (2 * k) == 0 and spec.h * spec.w // k % 32 == 0
        assert split == set(stages)


@pytest.mark.parametrize("variant,i", CLUSTER_STAGES,
                         ids=[f"{v}-stage{i + 2}" for v, i in CLUSTER_STAGES])
def test_cluster_emulation_vs_jax(wide, monkeypatch, variant, i):
    """The emulated cluster form in bfloat16 against the JAX os_stage
    (interpret mode) within the width's bar, and against os_stage_plain
    within the card's bar; crop by crop it equals the whole batch bit for
    bit (a crop's bands never see another crop)."""
    spec, x, want = _wide_stage(wide, variant, i, "bf16")
    w = tk.stage_weights(wide[variant][1], i, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    got = _cluster_emulated(xb, w, spec, monkeypatch)
    assert got.shape == want.shape == (WIDE_G, *spec.out_shape)
    assert _bf16_mean_err(got.float().numpy(), want) <= WIDE_BF16_MEAN_TOL[variant]
    _assert_tc_bar(got.float().numpy(),
                   tk.os_stage_plain(xb, w, spec).float().numpy())
    assert torch.equal(_cluster_emulated(xb, w, spec, monkeypatch, per_crop=True),
                       got)


# --- K6's float32 forms (3xTF32 on the tensor cores), emulated ----------

# (variant, stage index): the stages float32 splits over a cluster of
# blocks a crop (tk.CLUSTER_SPLIT[torch.float32])
F32_CLUSTER_STAGES = [("osnet_x0_25", 0), ("osnet_x0_5", 0), ("osnet_x0_5", 1),
                      ("osnet_x0_75", 0), ("osnet_x0_75", 1), ("osnet_x1_0", 0),
                      ("osnet_x1_0", 1)]


def _tf32(v):
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero on the bit pattern, as float32: the kernel's tf32_rna."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pointwise_3xtf32(w, x, b, split=True):
    """(co, ci) @ (G, ci, P) + (co,) as the float32 form sums it: each
    operand split into hi = tf32(v) and lo = tf32(v - hi), each 8-wide K
    chunk's x_lo w_hi + x_hi w_lo + x_hi w_hi (lo.lo dropped) summed in
    float64 and rounded once to float32 (the products of TF32 values are
    exact, and so, nearly always, is their sum: the result does not
    depend on the order of the sums, nor on G), the chunks added in
    float32 in order, then + b. ``split=False``: TF32 alone, hi.hi."""
    w, x = w.float(), x.float()
    wh, xh = _tf32(w), _tf32(x)
    wl, xl = _tf32(w - wh), _tf32(x - xh)
    acc = None
    for k0 in range(0, w.shape[1], 8):
        s = slice(k0, k0 + 8)
        if split:
            wk = torch.cat([wh[:, s], wh[:, s], wl[:, s]], 1)
            xk = torch.cat([xh[:, s], xl[:, s], xh[:, s]], 1)
        else:
            wk, xk = wh[:, s], xh[:, s]
        part = torch.matmul(wk.double(), xk.double()).float()
        acc = part if acc is None else acc + part
    return acc + b[:, None]


def _ordered(a, w):
    """(G, n) @ (m, n)^T summed over n in order, each product and sum
    rounded to float32, whatever G is."""
    acc = None
    for c in range(w.shape[1]):
        t = a[:, c, None] * w[None, :, c]
        acc = t if acc is None else acc + t
    return acc


def _gate_ordered(s, v, blk, dt):
    """tk._gate with its two small layers summed in a fixed order (a
    batched matmul may sum in another order at another G) and the
    sigmoid crop by crop (the CPU's vector loop and its scalar tail round
    it differently, so a value's result depends on its position)."""
    m = tk._gate_mean(s).to(dt).float()
    a = torch.relu(_ordered(m, v[blk + ".g1"].float()) + v[blk + ".g1b"])
    z = _ordered(a.to(dt).float(), v[blk + ".g2"].float()) + v[blk + ".g2b"]
    g = torch.stack([torch.sigmoid(row) for row in z]).to(dt)
    return s * g[:, :, None]


def _tf32_emulated(x, weights, spec, monkeypatch, per_crop=False, split=True):
    """The stage as the float32 form computes it: 3xTF32 1x1 products in
    8-wide chunks, and where CLUSTER_SPLIT splits the stage, the gate's
    mean summed per band and then in rank order; every sum in a fixed
    order, so that one crop at a time (``per_crop``) must equal the
    batch."""
    monkeypatch.setattr(tk, "_pointwise", lambda w, a, b: _pointwise_3xtf32(
        w, a, b, split))
    monkeypatch.setattr(tk, "_gate", _gate_ordered)
    k = tk.cluster_split(spec, torch.float32)
    if k > 1:
        monkeypatch.setattr(tk, "_gate_mean", _gate_mean_banded(k))
    if per_crop:
        out = torch.cat([tk.os_stage_plain(x[g:g + 1], weights, spec)
                         for g in range(x.shape[0])])
    else:
        out = tk.os_stage_plain(x, weights, spec)
    monkeypatch.undo()
    return out


def test_tf32_rounding():
    """tf32 keeps 10 mantissa bits, rounds half away from zero, and hi +
    lo holds all but the last bits of a float32."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, 0.1], dtype=torch.float32)
    got = _tf32(v)
    assert got[:4].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                1.0 + 2.0 ** -9]
    hi = _tf32(v)
    lo = _tf32(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
def test_tf32_emulation_vs_jax(jparams, model, monkeypatch, i):
    """x0_25's three stages as the float32 form computes them (3xTF32 in
    8-wide chunks; stage 2 split over a cluster) against the JAX
    os_stage in float32 (interpret mode) within F32_TOL, and against
    os_stage_plain within the card's float32 bar (1e-4); TF32 alone
    misses the bar."""
    want = _jax_stage(jparams, i, "f32")
    w = tk.stage_weights(model, i, torch.float32)
    x = torch.from_numpy(_stage_input(i))
    got = _tf32_emulated(x, w, SPECS[i], monkeypatch)
    assert got.shape == (G, *SPECS[i].out_shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)
    plain = tk.os_stage_plain(x, w, SPECS[i])
    assert float((got - plain).abs().max()) <= F32_TOL
    if i == 0:
        alone = _tf32_emulated(x, w, SPECS[i], monkeypatch, split=False)
        assert float((alone - plain).abs().max()) > F32_TOL


@pytest.mark.parametrize("variant,i", [("osnet_x0_5", 1), ("osnet_x1_0", 0)],
                         ids=["x0_5-stage3", "x1_0-stage2"])
def test_tf32_cluster_emulation_vs_jax(wide, monkeypatch, variant, i):
    """The float32 cluster form, emulated (3xTF32, the gate's mean per
    band in rank order at CLUSTER_SPLIT's split), against the JAX
    os_stage in float32 (interpret mode) within the wider widths' float32
    bar, and against os_stage_plain within 1e-4; crop by crop it equals
    the whole batch bit for bit."""
    spec, x, want = _wide_stage(wide, variant, i, "f32")
    assert tk.cluster_split(spec, torch.float32) > 1
    w = tk.stage_weights(wide[variant][1], i, torch.float32)
    xf = torch.from_numpy(x)
    got = _tf32_emulated(xf, w, spec, monkeypatch)
    assert got.shape == want.shape == (WIDE_G, *spec.out_shape)
    tol = F32_TOL * max(1.0, float(np.abs(want).max()) / F32_SCALE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert float((got - tk.os_stage_plain(xf, w, spec)).abs().max()) <= F32_TOL
    assert torch.equal(_tf32_emulated(xf, w, spec, monkeypatch, per_crop=True),
                       got)
