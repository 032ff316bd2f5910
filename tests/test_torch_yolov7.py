"""The port's YOLOv7 against the JAX package: the full model at 160x160
against a jitted ``yolov7_apply`` on JAX-initialised weights converted
with params_from_jax, in its training form and in its deploy form
(``fuse_yolov7`` on both sides), at rtol = atol = 1e-4 (float32, each
conv summed in another order); ``fuse_repconv`` against the JAX one
(atol 1e-4, the JAX package's own bar); then ``Pipeline.track`` and
``BatchedPipeline.step`` under ByteTrack and StrongSORT + the trained
OSNet-x0_25 against the JAX Pipeline, as in test_torch_yolov5.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.models import yolov7 as jv7
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.models import yolov7 as tv7
from strongsort_yolo_tpu_torch.models.yolo import build_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tests.test_torch_yolov5 import TOL, run_track_and_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jv7.init_yolov7(jax.random.PRNGKey(4), jv7.Yolov7Config()))


@pytest.mark.parametrize("fuse", [False, True])
def test_forward_vs_jax(jparams, fuse):
    cfg = tv7.Yolov7Config()
    x = np.random.default_rng(5).uniform(0, 1, (1, 160, 160, 3)).astype(np.float32)
    model = tporting.model_from_state_dict(
        tporting.params_from_jax(jparams, cfg), cfg)
    params, models = jparams, [model]
    if fuse:  # the port's fuse, and the JAX deploy tree converted
        params = jax.device_get(jv7.fuse_yolov7(jparams))
        models = [tv7.fuse_yolov7(model), tporting.model_from_state_dict(
            tporting.params_from_jax(params, cfg), cfg)]
        assert all(m.fused and m.rep_deploy for m in models)
    want = jax.jit(lambda p, x: jv7.yolov7_apply(p, x, jv7.Yolov7Config()))(
        params, jnp.asarray(x))
    a = 3 * (20 * 20 + 10 * 10 + 5 * 5)
    for model in models:
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got["boxes"].shape == (1, a, 4)
        assert got["scores"].shape == (1, a, 80)
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **TOL)


def test_fuse_repconv_vs_jax(rng):
    p = jax.device_get(jv7.init_repconv(jax.random.PRNGKey(0), 8, 16))
    for branch in p.values():  # BN statistics away from the identity
        for k, lo, hi in (("bn_scale", 0.5, 1.5), ("bn_bias", -0.2, 0.2),
                          ("bn_mean", -0.3, 0.3), ("bn_var", 0.5, 2.0)):
            branch[k] = rng.uniform(lo, hi, branch[k].shape).astype(np.float32)
    rep = tv7.RepConv(8, 16, deploy=False, fused=False)
    rep.load_state_dict(tporting._state_dict_from_tree(
        p, set(rep.state_dict()), "RepConv"))
    fused = tv7.fuse_repconv(rep)
    assert fused.deploy
    want = jax.device_get(jv7.fuse_repconv(p))["fused"]
    np.testing.assert_allclose(
        fused.fused.w.detach().permute(2, 3, 1, 0).numpy(), want["w"], atol=1e-4)
    np.testing.assert_allclose(fused.fused.b.detach().numpy(), want["b"], atol=1e-4)
    x = rng.normal(0, 1, (1, 16, 16, 8)).astype(np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        a, b = rep(xt), fused(xt)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    np.testing.assert_allclose(
        a.permute(0, 2, 3, 1).numpy(),
        np.asarray(jv7.repconv_apply(p, jnp.asarray(x))), atol=1e-4)


def test_parameter_count_and_tree(jparams):
    """The published yolov7 is ~36.9M; the port's state_dict holds the JAX
    tree's leaves, BN statistics included, and nothing else."""
    model = tv7.Yolov7Model()
    n = sum(v.numel() for v in model.state_dict().values())
    assert n == sum(x.size for x in jax.tree.leaves(jparams))
    assert 35e6 < n < 40e6
    assert build_model("yolov7") == tv7.Yolov7Config()


@pytest.mark.parametrize("tracker", ["bytetrack", "strongsort"])
def test_pipeline_vs_jax(jparams, tracker):
    assert run_track_and_step("yolov7", jparams, tracker, t=4) >= 16
