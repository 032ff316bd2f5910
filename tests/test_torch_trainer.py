"""The port's train step (train/trainer.py), its trainer tool
(tools/train.py) and ``save_npz_checkpoint`` against the JAX package's.

Every step starts from ``assets/yolov8n_synth160.npz`` at imgsz 64,
batch 2: a random init assigns no foreground there and would leave the
box and DFL terms out, so the cases assert ``num_fg > 0``.

Tolerances: each tensor's gradient (the BN statistics included, which
the JAX step differentiates and optax's adamw updates and decays) within
1e-4 of the norm of JAX's gradient of that tensor (the two forwards sum
the convolutions in another order); the optimizer fed equal gradients
within 1e-6 of optax's ``chain(clip_by_global_norm(10), adamw)`` over
three updates, one of them clipped; three full steps' losses within 1e-4
relative of the jitted JAX ``make_train_step``'s. Raw parameters after
several Adam steps are not held: where a gradient entry is near 0 the
two sides' rounding can flip the sign of its update. The cosine schedule
equals optax's within float32 rounding of its peak; the synthetic batches and
``yolo_txt_batches`` equal the JAX tool's exactly.
"""

import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from strongsort_yolo_tpu.models import porting as jporting
from strongsort_yolo_tpu.models import yolo as jyolo
from strongsort_yolo_tpu.ops.decode import make_anchors as jmake_anchors
from strongsort_yolo_tpu.tools import train as jtrain
from strongsort_yolo_tpu.train import loss as jloss
from strongsort_yolo_tpu.train import trainer as jtrainer
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.models import yolo as tyolo
from strongsort_yolo_tpu_torch.parallel.mesh import make_mesh
from strongsort_yolo_tpu_torch.tools import eval_e2e
from strongsort_yolo_tpu_torch.tools import train as ttrain
from strongsort_yolo_tpu_torch.train import trainer as tt

CKPT = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "yolov8n_synth160.npz")
IMGSZ, LR = 64, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        imgs, tg = jtrain.synthetic_batch(rng, 2, IMGSZ)
        out.append((np.array(imgs), {k: np.array(v) for k, v in tg.items()}))
    return out


@pytest.fixture(scope="module")
def jax_start():
    tree, cfg, _ = jporting.load_npz_checkpoint(CKPT)
    return tree, cfg


def port_model():
    tree, cfg, _ = tporting.load_npz_checkpoint(CKPT)
    return tporting.model_from_state_dict(tporting.params_from_jax(tree, cfg),
                                          cfg), cfg


@pytest.fixture(scope="module")
def jax_grads(jax_start, batches):
    """(loss, metrics, gradient tree) of the JAX step's loss_fn on batch 0."""
    tree, cfg = jax_start
    anchors, strides = jmake_anchors(jyolo.feat_hw((IMGSZ, IMGSZ), cfg.strides),
                                     cfg.strides)

    def loss_fn(params, images, targets):
        out = jyolo.model_apply(params, images, cfg, compute_dtype=jnp.float32)
        return jloss.detection_loss(out, targets, anchors, strides, nc=cfg.nc,
                                    reg_max=cfg.reg_max)

    (loss, m), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tree, *batches[0])
    return float(loss), {k: float(v) for k, v in m.items()}, jax.device_get(g)


@pytest.fixture(scope="module")
def jax_curve(jax_start, batches):
    """The losses and num_fg of three jitted make_train_step steps."""
    tree, cfg = jax_start
    tx = jtrainer.make_optimizer(LR)
    state = jtrainer.TrainState(tree, tx.init(tree), jnp.int32(0))
    step = jtrainer.make_train_step(cfg, IMGSZ, tx)
    curve = []
    for images, targets in batches:
        state, m = step(state, images, targets)
        curve.append((float(m["loss"]), float(m["num_fg"])))
    return curve


def port_curve(batches, state, cfg):
    step = tt.make_train_step(cfg, IMGSZ, tt.make_optimizer(LR))
    curve = []
    for images, targets in batches:
        state, m = step(state, images, targets)
        curve.append((float(m["loss"]), float(m["num_fg"])))
    assert state.step == len(batches)
    return curve


def assert_same_curve(got, want):
    for (gl, gf), (wl, wf) in zip(got, want):
        assert gf == wf > 0
        assert abs(gl - wl) <= 1e-4 * abs(wl), (got, want)


def test_every_gradient_equals_jax(jax_grads, batches):
    jl, jm, jg = jax_grads
    model, cfg = port_model()
    tensors = tt.trained_tensors(model)
    loss, m = tt.make_loss_fn(cfg, IMGSZ)(model, *batches[0])
    loss.backward()
    assert m["num_fg"] == jm["num_fg"] > 0 and jm["box_loss"] > 0
    assert abs(float(loss.detach()) - jl) <= 1e-5 * jl
    want = tporting.params_from_jax(jg, cfg)
    held = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    assert set(want) == set(held) and len(tensors) == len(held)
    stats = [k for k in want if k.endswith(("bn_mean", "bn_var"))]
    assert len(stats) == 2 * sum(k.endswith("bn_scale") for k in want) > 100
    for k, g in want.items():
        got = held[k].grad
        assert got is not None, k
        assert float((got - g).norm()) <= 1e-4 * float(g.norm()), k


@pytest.mark.parametrize("lr,wd", [(1e-2, 5e-4), ("cosine", 0.1)])
def test_optimizer_equals_optax_on_equal_gradients(lr, wd):
    """Three updates of a few tensors, the second with a gradient norm of
    ~40 (clipped to 10); the cosine case trains at lr 0 at count 0."""
    rng = np.random.default_rng(11)
    shapes = {"w": (3, 4, 2, 2), "b": (5,), "bn_var": (6,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, s, v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 8.0, 0.1)]
    assert np.sqrt(sum(np.sum(g ** 2) for g in grads[1].values())) > 10
    jlr = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 3, 1e-4)
           if lr == "cosine" else lr)
    tlr = (tt.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 3, 1e-4)
           if lr == "cosine" else lr)
    jtx = jtrainer.make_optimizer(jlr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ttx = tt.make_optimizer(tlr, weight_decay=wd)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = ttx.init(list(tp.values()))
    for count, g in enumerate(grads):
        upd, jstate = jax.jit(jtx.update)(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        ttx.update(opt, count)
        for k in params:
            err = np.max(np.abs(tp[k].detach().numpy() - np.asarray(jp[k])))
            assert err <= 1e-6, (count, k, err)
        moved = max(np.max(np.abs(np.asarray(jp[k]) - params[k])) for k in params)
        assert moved > 1e-4 or (lr == "cosine" and count == 0)


def test_three_steps_follow_the_jax_loss_curve(jax_curve, batches):
    model, cfg = port_model()
    state = tt.train_state(model, tt.make_optimizer(LR))
    assert_same_curve(port_curve(batches, state, cfg), jax_curve)


def test_bn_statistics_left_out_of_the_optimizer_fail_step_parity(
        jax_curve, batches, monkeypatch):
    """A mutation: a trainer whose optimizer takes the parameters only (the
    BN statistics are buffers) drifts from the JAX step after one update."""
    monkeypatch.setattr(tt, "trained_tensors", lambda m: list(m.parameters()))
    model, cfg = port_model()
    curve = port_curve(batches, tt.train_state(model, tt.make_optimizer(LR)), cfg)
    assert curve[0] == pytest.approx(jax_curve[0], rel=1e-4)
    with pytest.raises(AssertionError):
        assert_same_curve(curve, jax_curve)


@pytest.mark.parametrize("steps", [3, 10, 600, 2000])
def test_cosine_schedule_equals_optax(steps):
    """tools/train.py's --cosine arguments; step 0 trains at lr 0."""
    args = (0.0, 1e-3, min(100, max(steps // 10, 1)), steps, 1e-5)
    want = optax.warmup_cosine_decay_schedule(*args)
    got = tt.warmup_cosine_decay_schedule(*args)
    counts = np.arange(steps + 3)
    w = np.asarray(jax.vmap(want)(jnp.asarray(counts)))
    g = np.asarray([got(int(c)) for c in counts])
    assert g[0] == 0.0 and abs(g[args[2]] - 1e-3) <= 1e-9
    # optax computes in float32, where 1 + cos(.) cancels near the end of
    # the decay: equal within float32 rounding of the peak rate
    np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6 * args[1])


@pytest.mark.parametrize("name", ["synthetic_batch", "synthetic_batch_seg",
                                  "synthetic_batch_pose"])
@pytest.mark.parametrize("imgsz", [64, 160])
def test_synthetic_batches_equal_the_jax_tool(name, imgsz):
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        ji, jt = getattr(jtrain, name)(a, 4, imgsz)
        ti, tt_ = getattr(ttrain, name)(b, 4, imgsz)
        assert isinstance(ti, np.ndarray) and np.array_equal(ti, np.asarray(ji))
        assert set(tt_) == set(jt)
        for k in jt:
            assert tt_[k].dtype == np.asarray(jt[k]).dtype
            assert np.array_equal(tt_[k], np.asarray(jt[k])), k
    assert a.integers(1 << 30) == b.integers(1 << 30)
    assert np.array_equal(ttrain.POSE_KPT_COLORS, jtrain.POSE_KPT_COLORS)


def test_yolo_txt_batches_equal_the_jax_tool(tmp_path):
    import cv2

    rng = np.random.default_rng(1)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i, (h, w) in enumerate([(48, 64), (80, 80), (64, 40)]):
        cv2.imwrite(str(tmp_path / "images" / f"im{i}.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i < 2:  # the third image has no label file
            rows = [f"{i} 0.5 0.5 0.25 0.5", "2 0.3 0.6 0.2 0.1"][: i + 1]
            (tmp_path / "labels" / f"im{i}.txt").write_text("\n".join(rows))
    jgen = jtrain.yolo_txt_batches(str(tmp_path), np.random.default_rng(3), 4, 32)
    tgen = ttrain.yolo_txt_batches(str(tmp_path), np.random.default_rng(3), 4, 32)
    for _ in range(3):
        ji, jt = next(jgen)
        ti, tt_ = next(tgen)
        assert np.array_equal(ti, np.asarray(ji))
        for k in jt:
            assert np.array_equal(tt_[k], np.asarray(jt[k])), k
        assert tt_["valid"].sum() <= 8


@pytest.mark.parametrize("name", ["yolov8n", "yolov8n-seg", "yolov8n-pose",
                                  "yolo11n", "yolo11n-seg", "yolo11n-pose"])
def test_save_npz_checkpoint_round_trip(name, tmp_path):
    """Saved by the port, loaded by both packages' loaders: the same tree,
    config and names; the port's reload equals the model exactly."""
    import dataclasses

    cfg = dataclasses.replace(tyolo.build_model(name), nc=3, kpt=(5, 3))
    model = tyolo.init_model(cfg, torch.Generator().manual_seed(2))
    names = {0: "red", 1: "green", 2: "blue"}
    path = str(tmp_path / "m.npz")
    tporting.save_npz_checkpoint(path, model.state_dict(), cfg, names)
    tree, tcfg, tnames = tporting.load_npz_checkpoint(path)
    jtree, jcfg, jnames = jporting.load_npz_checkpoint(path)
    assert tcfg == cfg and tnames == jnames == names
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = tporting.params_from_jax(tree, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert jax.tree.structure(jtree) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(jtree), jax.tree.leaves(
            tporting.jax_params(model.state_dict()))):
        assert np.array_equal(np.asarray(x), y)


def test_saved_checkpoint_forward_equals_jax(tmp_path):
    """One saved model (YOLO11 seg: the proto layout too) through the JAX
    loader and model_apply against the port's forward, rtol = atol = 1e-4
    (the two sum the convolutions in another order)."""
    cfg = tyolo.YoloConfig(family="v11", task="segment", nc=3)
    model = tyolo.init_model(cfg, torch.Generator().manual_seed(4))
    path = str(tmp_path / "m.npz")
    tporting.save_npz_checkpoint(path, model.state_dict(), cfg)
    jtree, jcfg, _ = jporting.load_npz_checkpoint(path)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jyolo.model_apply(p, x, jcfg, pack=False))(
        jtree, jnp.asarray(x))
    with torch.no_grad():
        got = tyolo.model_apply(model, torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("flags", [[], ["--model", "yolov8n-pose", "--kpt",
                                        "5", "--nc", "3", "--cosine"]])
def test_main_trains_and_saves(flags, tmp_path):
    path = str(tmp_path / "x.npz")
    res = ttrain.main(["--synthetic", "--steps", "3", "--imgsz", "64",
                       "--device", "cpu", "--save", path, "--log-every", "1",
                       *flags])
    assert [s for s, _ in res["losses"]] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for _, m in res["losses"])
    assert len(res["step_ms"]) == 3 and res["seconds"] > 0
    _, cfg, _ = tporting.load_npz_checkpoint(path)
    _, jcfg, _ = jporting.load_npz_checkpoint(path)
    assert cfg.task == jcfg.task == ("pose" if flags else "detect")
    if flags:
        assert cfg.kpt == jcfg.kpt == (5, 3) and "kpt_loss" in res["losses"][0][1]


def test_eval_e2e_trains_seeds_and_serves(monkeypatch, tmp_path):
    """The shipped detector served by eval_e2e clears the bars of
    tests/test_trained_e2e.py through the port; --train-seeds trains
    tools/train's recipe (cut here to 2 steps at imgsz 64) from a seed,
    saves it by seed and serves it too."""
    monkeypatch.setattr(eval_e2e, "RECIPE", ("--synthetic", "--steps", "2",
                                             "--imgsz", "64", "--nc", "3"))
    shipped, seed1 = eval_e2e.main([CKPT, "--train-seeds", "1", "--out",
                                    str(tmp_path), "--device", "cpu"])
    assert shipped["mota"] > 0.8 and shipped["idf1"] > 0.8, shipped
    assert shipped["idsw"] == 0 and shipped["class_test"], shipped
    assert shipped["classes"] == [0, 1, 2]
    assert seed1["weights"] == str(tmp_path / "seed1.npz")
    _, cfg, _ = tporting.load_npz_checkpoint(seed1["weights"])
    assert cfg.nc == 3 and np.isfinite(seed1["mota"])


def test_e2e_bar_separates_the_trainers_from_a_worse_one():
    """chip_smoke's phase-7b bar: the mean over the port's first six
    recorded draws clears it, every six of the JAX trainer's ten keys
    clear it, and a trainer whose draws are 0.2 worse in MOTA or 0.1 in
    IDF1 fails it."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    n = len(chip_smoke.E2E_SEEDS)
    for k, worse in (("mota", 0.2), ("idf1", 0.1)):
        bar = chip_smoke.e2e_bar(k, n)
        port = np.asarray(chip_smoke.E2E_SPREAD["port"][k])
        jax_keys = np.asarray(chip_smoke.E2E_SPREAD["jax"][k])
        assert port[:n].mean() > bar, k
        assert min(np.mean(c) for c in itertools.combinations(jax_keys, n)) > bar
        assert (port[:n] - worse).mean() < bar, k


def test_mesh_and_mixed_precision_raise(tmp_path):
    """What still raises: a mesh outside a run of ranks, a batch that dp
    does not split, a compute dtype that is not a float, the fused model.
    What no longer does: bfloat16 (test_bf16_steps_follow_the_jax_bf16_step)
    and --dp/--tp: tools/train over 2 x 2 gloo ranks on the CPU logs the
    losses of the one-process run within 1e-5 relative and saves the
    whole model."""
    cfg = tyolo.build_model("yolov8n")
    tx = tt.make_optimizer()
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tt.init_train_state(0, cfg, tx, "cpu", mesh=mesh)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        tt.shard_batch(mesh, np.zeros((3, 8, 8, 3), np.float32), {})
    with pytest.raises(ValueError, match="not a float"):
        tt.make_train_step(cfg, 64, tx, compute_dtype=torch.int32)
    flags = ["--synthetic", "--steps", "2", "--imgsz", "64", "--batch", "4",
             "--log-every", "1", "--device", "cpu"]
    one = ttrain.main(flags)
    path = str(tmp_path / "mesh.npz")
    res = ttrain.main([*flags, "--dp", "2", "--tp", "2", "--save", path])
    assert [i for i, _ in res["losses"]] == [0, 1] and len(res["step_ms"]) == 2
    for (_, got), (_, want) in zip(res["losses"], one["losses"]):
        assert got["num_fg"] == want["num_fg"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    tree, saved_cfg, _ = tporting.load_npz_checkpoint(path)
    sd = tporting.params_from_jax(tree, saved_cfg)
    assert sd["backbone.down4.w"].shape == (256, 128, 3, 3)
    with pytest.raises(ValueError, match="unfused"):
        tt.train_state(tyolo.YoloModel(cfg, fused=True), tx)


@pytest.fixture(scope="module")
def jax_bf16_curve(jax_start, batches):
    """The metrics of three jitted make_train_step steps in bfloat16."""
    tree, cfg = jax_start
    tx = jtrainer.make_optimizer(LR)
    state = jtrainer.TrainState(tree, tx.init(tree), jnp.int32(0))
    step = jtrainer.make_train_step(cfg, IMGSZ, tx, compute_dtype=jnp.bfloat16)
    curve = []
    for images, targets in batches:
        state, m = step(state, images, targets)
        curve.append({k: float(v) for k, v in m.items()})
    return curve


def test_bf16_steps_follow_the_jax_bf16_step(jax_bf16_curve, batches):
    """compute_dtype=bfloat16 against the JAX step's, three steps from the
    synth160 asset. The bar: each step's loss within 1e-2 relative of
    JAX's and each loss term within 2e-2 (the two sides round the bf16
    convolutions, the BN epilogues and SiLU at their own points: a
    different last bit in one layer moves the next; JAX's own bf16 and
    float32 steps differ by 0.8% at step 1), num_fg equal and above 0,
    every term above 0. The parameters, the BN statistics and AdamW's
    moments stay float32, and the loss is not the float32 step's."""
    model, cfg = port_model()
    state = tt.train_state(model, tt.make_optimizer(LR))
    step = tt.make_train_step(cfg, IMGSZ, tt.make_optimizer(LR),
                              compute_dtype=torch.bfloat16)
    f32 = port_curve(batches[:1], tt.train_state(port_model()[0],
                                                 tt.make_optimizer(LR)), cfg)
    for t, (images, targets) in enumerate(batches):
        state, m = step(state, images, targets)
        got, want = {k: float(v) for k, v in m.items()}, jax_bf16_curve[t]
        assert got["num_fg"] == want["num_fg"] > 0
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-2), t
        for k in ("box_loss", "cls_loss", "dfl_loss"):
            assert got[k] > 0 and got[k] == pytest.approx(want[k], rel=2e-2), k
        if t == 0:
            assert got["loss"] != pytest.approx(f32[0][0], rel=1e-4)
    assert all(p.dtype == torch.float32 for p in tt.trained_tensors(state.model))
    moments = [v for s in state.opt.state.values() for v in s.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)


def test_exact_step_sets_and_restores_the_backend_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32
    with tt.exact_step():
        assert cudnn.deterministic
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
    assert (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32) == saved
