"""The port's OSNet trainer (tools/train_osnet.py), its unfused OSNet and
``save_osnet_npz`` against the repo's JAX ``tools/train_osnet.py`` and
the JAX package's OSNet.

Tolerances: the data (recipes, views, datasets) and rank-1 equal the
repo tool's exactly; the unfused OSNet's embeddings within 1e-5 of the
folded model's (folding rounds the BN into the weights); the gradient of
the tool's cross-entropy on a batch of 4, for every tensor of the
checkpoint (the BN statistics included, which the tool's optax.adam
trains) and the head, within 1e-4 of the norm of JAX's gradient of that
tensor (the forwards sum in another order; the JAX stem folds the input
normalisation into its conv), in float64 from the tool's random initial
tree and in float32 from the trained one.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from strongsort_yolo_tpu.models import osnet as josnet
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models import osnet as tosnet
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.pipeline import Pipeline
from strongsort_yolo_tpu_torch.tools import train_osnet as tto
from strongsort_yolo_tpu_torch.train.trainer import trained_tensors
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import train_osnet as jto  # noqa: E402  the repo's JAX trainer

OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
CFG = tosnet.OsnetConfig()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(josnet.init_osnet(jax.random.PRNGKey(0),
                                            josnet.OsnetConfig()))


def unfused(tree) -> tosnet.OSNet:
    model = tosnet.OSNet(CFG, fused=False)
    model.load_state_dict(tporting.osnet_params_from_jax(tree, CFG))
    return model


def test_data_and_rank1_equal_the_repo_tool():
    for seed in (0, 5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        ja, jb = jto.make_recipe(a), tto.make_recipe(b)
        assert ja.keys() == jb.keys()
        assert all(np.array_equal(ja[k], jb[k]) for k in ja)
        assert np.array_equal(jto.render_view(a, ja), tto.render_view(b, jb))
        jx, jy, _ = jto.make_dataset(a, 6, 3)
        tx, ty, _ = tto.make_dataset(b, 6, 3)
        assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
        assert tx.dtype == np.float32 and ty.dtype == np.int32
        assert a.integers(1 << 30) == b.integers(1 << 30)
    emb = np.random.default_rng(1).normal(0, 1, (18, 8))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert tto.rank1(emb, ty) == jto.rank1(emb, jy)


@pytest.mark.parametrize("which", ["init", "trained"])
def test_unfused_osnet_equals_the_folded_one(which, jax_init):
    tree = jax_init if which == "init" else tporting.load_osnet_npz(OSNET)[0]
    model = unfused(tree)  # a strict load: the tree's keys, the model's
    folded = tosnet.osnet_from_state_dict(
        tporting.osnet_params_from_jax(tree, CFG), CFG)
    x = torch.from_numpy(tto.make_dataset(np.random.default_rng(3), 4, 2)[0]
                         ).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, want = model(x), folded(x)
    assert float((got - want).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="fused"):
        model.use_fused_stages(torch.float32)


@pytest.mark.parametrize("which", ["init", "trained"])
def test_ce_gradients_equal_jax(which, jax_init):
    """The repo tool's loss_fn on a batch of 4, from the tool's initial tree
    (float64 on both sides: from a random init the float32 gradients of
    the two forwards drift apart by up to 1.5e-3 of a tensor's norm,
    against 2.2e-6 in float64, where the port's embeddings are still
    rounded to float32) and from the shipped trained tree (float32)."""
    f64 = which == "init"
    tree = jax_init if f64 else tporting.load_osnet_npz(OSNET)[0]
    x, y, _ = tto.make_dataset(np.random.default_rng(2), 4, 1)
    head = (np.random.default_rng(4).normal(0, 1, (CFG.feat_dim, 4)) * 0.02
            ).astype(np.float32)
    jdt = jnp.float64 if f64 else jnp.float32

    def loss_fn(st):
        feats = josnet.osnet_apply(st["osnet"], jnp.asarray(x, jdt),
                                   compute_dtype=jdt)
        logits = feats.astype(jdt) @ st["head"] * 16.0
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean() + 0.0 * jnp.sum(st["head"] ** 2)

    with jax.enable_x64(f64):
        jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
            {"osnet": jax.tree.map(lambda a: jnp.asarray(a, jdt), tree),
             "head": jnp.asarray(head, jdt)})
        jl, jg = float(jl), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                         jax.device_get(jg))
    model = unfused(tree)
    if f64:
        model = model.double()
    tensors = trained_tensors(model)
    th = torch.from_numpy(head).requires_grad_()
    loss = tto.ce_loss(model, th, torch.from_numpy(x).to(
        torch.float64 if f64 else torch.float32), torch.from_numpy(y).long())
    loss.backward()
    assert abs(float(loss.detach()) - jl) <= 1e-5 * jl
    want = tporting.osnet_params_from_jax(jg["osnet"], CFG)
    held = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    assert set(want) == set(held) and len(tensors) == len(held)
    assert sum(k.endswith(("bn_mean", "bn_var")) for k in want) > 100
    want["head"], held["head"] = torch.from_numpy(jg["head"]), th
    for k, g in want.items():
        got = held[k].grad
        assert got is not None, k
        assert float((got.float() - g).norm()) <= 1e-4 * float(g.norm()), k


def test_save_osnet_npz_loads_in_both_packages(tmp_path, jax_init):
    sd = unfused(jax_init).state_dict()
    path = str(tmp_path / "osnet.npz")
    tporting.save_osnet_npz(path, sd, CFG)
    tree, tcfg = tporting.load_osnet_npz(path)
    jtree, jcfg = josnet.load_osnet_npz(path)
    assert tcfg == CFG and jcfg.variant == CFG.variant
    assert jax.tree.structure(jtree) == jax.tree.structure(jax_init)
    for a, b, c in zip(jax.tree.leaves(jtree), jax.tree.leaves(jax_init),
                       jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), b) and np.array_equal(c, b)
    with pytest.raises(ValueError, match="checkpoint"):
        tporting.save_osnet_npz(path, {"w": sd["stem.w"]}, CFG)


def test_main_trains_and_serves(tmp_path):
    out = str(tmp_path / "osnet.npz")
    res = tto.main(["--steps", "3", "--ids", "8", "--device", "cpu",
                    "--out", out])
    assert [s for s, _ in res["losses"]] == [0, 2] == [s for s, _ in res["rank1"]]
    assert all(np.isfinite(v) for _, v in res["losses"])
    assert 0.0 <= res["rank1_init"] <= 1.0 and os.path.exists(out)
    pipe = Pipeline(DetectorConfig(weights="yolov8n", imgsz=160, half=False,
                                   max_det=16),
                    tracker=StrongSortConfig(gmc_method="none"), track_slots=16,
                    tracker_max_dets=16, reid_topk=16, reid_weights=out,
                    device="cpu")
    frame = np.random.default_rng(0).integers(0, 255, (160, 160, 3), np.uint8)
    pipe.track(frame)
