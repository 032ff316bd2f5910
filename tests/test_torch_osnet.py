"""The port's OSNet (``models/osnet.py``) against the JAX ``osnet_apply``
on the same crops and weights: JAX-initialised parameters and the trained
``assets/osnet_x0_25_synth.npz``, converted with ``osnet_params_from_jax``
(the trained file also through the port's numpy-only ``load_osnet_npz``).

Features are L2-normalised; float32 on both sides, they agree within
1e-4 (the JAX package folds the input normalisation into the stem conv,
the port normalises first; convolutions sum in another order), for RGB
crops and for BGR crops through ``channel_order="bgr"``; the loader
folds every BN into its conv.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.models import osnet as josnet
from strongsort_yolo_tpu_torch.models.osnet import (
    OsnetConfig,
    checkpoint_keys,
    init_osnet,
    osnet_from_state_dict,
)
from strongsort_yolo_tpu_torch.models.porting import (
    load_osnet_npz,
    osnet_params_from_jax,
)
from strongsort_yolo_tpu_torch.pipeline import _reid_checkpoint

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crops(seed, m=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (m, 128, 64, 3)).astype(np.float32)
    x[1] = np.linspace(0.2, 0.9, 128)[:, None, None]  # a smooth crop
    return x


def _jax_params(source):
    if source == "init":
        cfg = josnet.OsnetConfig()
        return jax.device_get(josnet.init_osnet(jax.random.PRNGKey(3), cfg)), cfg
    params, cfg = josnet.load_osnet_npz(NPZ)
    return jax.device_get(params), cfg


@pytest.mark.parametrize("order", ["rgb", "bgr"])
@pytest.mark.parametrize("source", ["init", "trained"])
def test_osnet_features_vs_jax(source, order):
    params, jcfg = _jax_params(source)
    cfg = OsnetConfig(variant=jcfg.variant)
    sd = osnet_params_from_jax(params, cfg)
    x = _crops(7)
    want = np.asarray(josnet.osnet_apply(params, jnp.asarray(x),
                                         channel_order=order))
    inp = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    model = osnet_from_state_dict(sd, cfg, channel_order=order).eval()
    with torch.no_grad():
        got = model(inp).numpy()
    assert got.shape == (4, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_npz_loader_matches_jax_loader():
    tree, cfg = load_osnet_npz(NPZ)
    jtree, jcfg = josnet.load_osnet_npz(NPZ)
    assert cfg.variant == jcfg.variant == "osnet_x0_25"
    sd = osnet_params_from_jax(tree, OsnetConfig(variant=cfg.variant))
    jsd = osnet_params_from_jax(jax.device_get(jtree),
                                OsnetConfig(variant=cfg.variant))
    assert len(sd) == 545 and sd.keys() == jsd.keys()
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k
    # HWIO -> OIHW; a depthwise (3, 3, 1, C) becomes (C, 1, 3, 3)
    assert tuple(tree["b2a"]["streams"][0][0]["dw"]["w"].shape) == (3, 3, 1, 16)
    assert tuple(sd["b2a.streams.0.0.dw.w"].shape) == (16, 1, 3, 3)
    assert tuple(sd["fc.lin.w"].shape) == (512, 128, 1, 1)


def test_converter_rejects_mismatched_tree():
    tree, cfg = load_osnet_npz(NPZ)
    del tree["b2a"]["down"]
    with pytest.raises(ValueError, match="missing"):
        osnet_params_from_jax(tree, OsnetConfig(variant=cfg.variant))
    tree, _ = load_osnet_npz(NPZ)
    tree["extra"] = {"w": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        osnet_params_from_jax(tree, OsnetConfig(variant=cfg.variant))


def test_init_checkpoint_keys_and_loader_rejects_mismatch():
    cfg = OsnetConfig()
    sd = init_osnet(cfg, torch.Generator().manual_seed(0))
    assert set(sd) == checkpoint_keys(cfg) and len(sd) == 545
    osnet_from_state_dict(sd, cfg)
    del sd["b2a.conv1.bn_var"]
    with pytest.raises(ValueError, match="missing"):
        osnet_from_state_dict(sd, cfg)


def test_reid_weights_resolution(tmp_path):
    sd, cfg = _reid_checkpoint(None, None, 1)
    assert cfg == OsnetConfig() and set(sd) == checkpoint_keys(cfg)
    sd2, cfg2 = _reid_checkpoint("osnet_x0_5", None, 1)
    assert cfg2.variant == "osnet_x0_5" and sd2["stem.w"].shape[0] == 32
    # a state_dict: the variant comes from the stem's width
    assert _reid_checkpoint(None, sd2, 1)[1] == cfg2
    with pytest.raises(ValueError, match="not both"):
        _reid_checkpoint(NPZ, sd2, 1)
    # a missing file names itself, not a variant lookup
    missing = str(tmp_path / "nope.npz")
    with pytest.raises(FileNotFoundError, match="nope.npz"):
        _reid_checkpoint(missing, None, 1)
    sd3, cfg3 = _reid_checkpoint(NPZ, None, 1)
    assert cfg3.variant == "osnet_x0_25" and set(sd3) == checkpoint_keys(cfg3)
