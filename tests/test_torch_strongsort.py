"""The port's StrongSORT (``track/strongsort.py``) and its Kalman/cost
additions against the JAX package: ``gating_distance``, the NSA
``update``, the ReID costs, and ``strongsort_step`` (vmapped over the same
streams on the JAX side) over seeded 32-frame scenarios of two streams,
plus the scenarios of ``tests/test_strongsort.py`` run through the port.

Track ids, statuses, activation, hits and det indices must be equal; KF
means, covariances and EMA features agree within rtol = atol = 1e-4
(float32, the same algebra summed in another order). The JAX side solves
with its XLA auction, the port with the TPU kernel's semantics; the
scenarios have no near-ties, where the two may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.track import cost as jcost
from strongsort_yolo_tpu.track import kalman as jkf
from strongsort_yolo_tpu.track import strongsort as jss
from strongsort_yolo_tpu.track.state import init_track_state as j_init
from strongsort_yolo_tpu_torch.track import cost as tcost
from strongsort_yolo_tpu_torch.track import kalman as tkf
from strongsort_yolo_tpu_torch.track import strongsort as tss
from strongsort_yolo_tpu_torch.track.state import init_track_state as t_init

TOL = dict(rtol=1e-4, atol=1e-4)
D = 16
FIELDS = ("mean", "cov", "track_id", "status", "activated", "score", "cls",
          "feat", "end_frame", "hits", "next_id", "frame_id", "dropped_births")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, *shape):
    a = rng.normal(0, 3, (*shape, 8, 8))
    return (a @ np.swapaxes(a, -1, -2) + 5 * np.eye(8)).astype(np.float32)


def _means(rng, s, k):
    m = rng.uniform(-5, 5, (s, k, 8)).astype(np.float32)
    m[..., 0:2] = rng.uniform(50, 600, (s, k, 2))
    m[..., 2] = rng.uniform(0.3, 0.8, (s, k))
    m[..., 3] = rng.uniform(40, 200, (s, k))
    return m


def test_gating_distance_vs_jax():
    rng = np.random.default_rng(0)
    s, k, n = 2, 12, 9
    mean, cov = _means(rng, s, k), _spd(rng, s, k)
    meas = _means(rng, s, n)[..., :4]
    want = jax.vmap(lambda m, c, z: jkf.gating_distance(m, c, z, jkf.XYAH))(
        mean, cov, meas)
    got = tkf.gating_distance(torch.from_numpy(mean), torch.from_numpy(cov),
                              torch.from_numpy(meas), tkf.XYAH)
    assert got.shape == (s, k, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert tkf.CHI2_95_4DOF == jkf.CHI2_95_4DOF


@pytest.mark.parametrize("form", ["xyah", "xywh"])
def test_nsa_update_vs_jax(form):
    rng = np.random.default_rng(1)
    s, k = 2, 10
    mean, cov = _means(rng, s, k), _spd(rng, s, k)
    meas = _means(rng, s, k)[..., :4]
    conf = rng.uniform(0, 1, (s, k)).astype(np.float32)
    conf[0, :2] = (1.0, 0.0)  # R floored at 1e-9, and R unscaled
    want = jkf.update(mean, cov, meas, form, conf=conf)
    got = tkf.update(*(torch.from_numpy(v) for v in (mean, cov, meas)), form,
                     conf=torch.from_numpy(conf))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


def test_reid_costs_vs_jax():
    rng = np.random.default_rng(2)
    s, k, n = 2, 8, 6
    tf = rng.normal(0, 1, (s, k, D)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    tf[:, -2:] = 0.0  # empty slots: distance 1
    df = rng.normal(0, 1, (s, n, D)).astype(np.float32)
    df /= np.linalg.norm(df, axis=-1, keepdims=True)
    emb = tcost.embedding_distance(torch.from_numpy(tf), torch.from_numpy(df))
    want = jax.vmap(jcost.embedding_distance)(tf, df)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want), atol=1e-6)
    assert (emb[:, -2:] == 1.0).all()
    maha = rng.uniform(0, 15, (s, k, n)).astype(np.float32)
    np.testing.assert_allclose(
        tcost.strongsort_cost(torch.from_numpy(maha), emb).numpy(),
        np.asarray(jcost.strongsort_cost(maha, want)), rtol=1e-6)
    d_iou = rng.uniform(0, 1, (s, k, n)).astype(np.float32)
    sc = rng.uniform(0, 1, (s, n)).astype(np.float32)
    got = tcost.botsort_fused_cost(torch.from_numpy(d_iou), emb,
                                   torch.from_numpy(sc))
    want_b = jax.vmap(lambda a, e, b: jcost.botsort_fused_cost(a, e, b))(
        d_iou, want, sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_b), atol=1e-6)


def _unit(rng, n):
    v = rng.normal(0, 1, (n, D))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _scenario(seed, t_len=32, n_det=10):
    """One stream: five objects with their own appearance (noisy per
    frame), a pair that crosses, an occlusion of five frames, a late
    birth, an object that leaves, a low-confidence object that never
    becomes a track, and a spurious det."""
    rng = np.random.default_rng(seed)
    app = _unit(rng, 6)
    objs = [  # x, y, w, h, vx, vy, cls, first, last, score
        (40, 50, 60, 120, 3.0, 1.0, 0, 0, t_len, 0.9),
        (300, 60, 50, 110, -6.0, 0.5, 0, 0, t_len, 0.85),  # crosses obj 0
        (120, 260, 80, 70, 1.5, -1.0, 2, 0, t_len, 0.8),
        (420, 300, 40, 90, -1.0, 0.0, 1, 9, t_len, 0.75),  # late birth
        (520, 120, 45, 95, 0.5, 1.5, 0, 0, 14, 0.9),  # leaves at 14
        (600, 400, 30, 60, 0.0, 0.0, 0, 0, t_len, 0.2),  # below det_thresh
    ]
    boxes = np.zeros((t_len, n_det, 4), np.float32)
    scores = np.zeros((t_len, n_det), np.float32)
    cls = np.zeros((t_len, n_det), np.int32)
    valid = np.zeros((t_len, n_det), bool)
    feats = np.zeros((t_len, n_det, D), np.float32)
    for t in range(t_len):
        n = 0
        order = rng.permutation(len(objs))  # detector row order varies
        for k in order:
            x, y, w, h, vx, vy, c, first, last, score = objs[k]
            if not first <= t < last or (k == 2 and 12 <= t < 17):
                continue
            jit = rng.normal(0, 0.8, 4)
            boxes[t, n] = (x + vx * t + jit[0], y + vy * t + jit[1],
                           x + w + vx * t + jit[2], y + h + vy * t + jit[3])
            f = app[k] + rng.normal(0, 0.15, D)
            feats[t, n] = f / np.linalg.norm(f)
            scores[t, n] = score + rng.uniform(-0.03, 0.03)
            cls[t, n], valid[t, n] = c, True
            n += 1
        boxes[t, n] = (700, 30 + 7 * (t % 5), 730, 90 + 7 * (t % 5))
        scores[t, n], valid[t, n] = 0.5, True
        feats[t, n] = _unit(rng, 1)[0]
    return boxes, scores, cls, valid, feats


def _warps(s):
    th = 0.004 * (s + 1)
    return np.array([[np.cos(th), -np.sin(th), 1.5 - s],
                     [np.sin(th), np.cos(th), 0.5]], np.float32)


def _run_both(cfg_kw, seeds, warp=False, slots=16):
    jcfg = jss.StrongSortConfig(**cfg_kw)
    tcfg = tss.StrongSortConfig(**cfg_kw)
    s = len(seeds)
    seqs = [_scenario(sd) for sd in seeds]
    warps = np.stack([_warps(i) for i in range(s)])

    def jstep(st, b, sc, c, v, f, w):
        return jss.strongsort_step(st, b, sc, c, v, f, jcfg,
                                   warp=w if warp else None)

    jstep = jax.jit(jax.vmap(jstep))
    jstate = jax.tree.map(lambda x: jnp.stack([x] * s), j_init(slots, feat_dim=D))
    tstate = t_init(s, slots, feat_dim=D)
    t_len = seqs[0][0].shape[0]
    seen_ids = set()
    for t in range(t_len):
        b, sc, c, v, f = (np.stack([seq[i][t] for seq in seqs]) for i in range(5))
        jstate, jout = jstep(jstate, b, sc, c, v, f, warps)
        tstate, tout = tss.strongsort_step(
            tstate, *(torch.from_numpy(a) for a in (b, sc, c, v, f)), tcfg,
            warp=torch.from_numpy(warps) if warp else None,
        )
        for name in FIELDS:
            want = np.asarray(getattr(jstate, name))
            got = getattr(tstate, name).numpy()
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, err_msg=f"t={t} {name}",
                                           **TOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"t={t} {name}")
        for name in ("track_id", "active", "det_index", "cls"):
            np.testing.assert_array_equal(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"t={t} out.{name}",
            )
        np.testing.assert_allclose(tout.boxes.numpy(), np.asarray(jout.boxes),
                                   **TOL)
        seen_ids |= set(tout.track_id[tout.active].tolist())
    return tstate, seen_ids


@pytest.mark.parametrize("case", ["default", "warp", "short_memory"])
def test_strongsort_step_vs_jax(case):
    kw = dict(gmc_method="none")
    if case == "short_memory":
        kw.update(max_age=3, n_init=2)
    state, ids = _run_both(kw, seeds=(11, 12), warp=case == "warp")
    # the five trackable objects surfaced as confirmed tracks
    assert len(ids) >= 5 and int(state.next_id.min()) > 5


# --- the scenarios of tests/test_strongsort.py, through the port -------

N_DET = 8


def _embed(seed):
    v = np.random.default_rng(seed).normal(0, 1, D)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _frame(dets):
    boxes = np.zeros((1, N_DET, 4), np.float32)
    scores = np.zeros((1, N_DET), np.float32)
    cls = np.zeros((1, N_DET), np.int32)
    valid = np.zeros((1, N_DET), bool)
    feats = np.zeros((1, N_DET, D), np.float32)
    for i, d in enumerate(dets):
        boxes[0, i], scores[0, i], cls[0, i] = d[:4], d[4], d[5]
        feats[0, i], valid[0, i] = _embed(d[6]), True
    return boxes, scores, cls, valid, feats


def _run(frames, cfg=tss.StrongSortConfig(gmc_method="none")):
    jcfg = jss.StrongSortConfig(**{
        f: getattr(cfg, f) for f in ("det_thresh", "max_cosine_distance",
                                     "lambda_appearance", "match_thresh",
                                     "max_iou_distance", "max_age", "n_init",
                                     "ema_alpha", "gmc_method")})
    jstep = jax.jit(jax.vmap(lambda st, *a: jss.strongsort_step(st, *a, jcfg)))
    jstate = jax.tree.map(lambda x: x[None], j_init(32, feat_dim=D))
    state = t_init(1, 32, feat_dim=D)
    outs = []
    for dets in frames:
        arrays = _frame(dets)
        state, out = tss.strongsort_step(
            state, *(torch.from_numpy(a) for a in arrays), cfg)
        jstate, jout = jstep(jstate, *arrays)
        np.testing.assert_array_equal(out.track_id.numpy(),
                                      np.asarray(jout.track_id))
        np.testing.assert_array_equal(out.active.numpy(),
                                      np.asarray(jout.active))
        outs.append(out)
    return outs


def _active(out):
    return {int(out.track_id[0, i]): out.boxes[0, i].numpy()
            for i in range(out.active.shape[1]) if out.active[0, i]}


def _box(t, x0=100, y0=100, vx=4, vy=2, w=40, h=80):
    x, y = x0 + vx * t, y0 + vy * t
    return (x, y, x + w, y + h)


def test_confirmation_after_n_init():
    outs = _run([[(*_box(t), 0.9, 0, 7)] for t in range(5)])
    assert _active(outs[0]) == {} and _active(outs[1]) == {}
    assert set(_active(outs[2])) == {1}  # hit 3 == n_init -> confirmed
    assert set(_active(outs[4])) == {1}


def test_tentative_dies_on_single_miss():
    frames = [[(*_box(0), 0.9, 0, 7)], []] + [
        [(*_box(t), 0.9, 0, 7)] for t in (2, 3, 4)]
    outs = _run(frames)
    assert set(_active(outs[4])) == {2}


def test_appearance_resolves_crossover():
    frames = []
    for t in range(12):
        xa, xb = 100.0 + 18.0 * t, 300.0 - 18.0 * t
        frames.append([(xa, 100.0, xa + 40, 180.0, 0.9, 0, 11),
                       (xb, 100.0, xb + 40, 180.0, 0.9, 0, 23)])
    outs = _run(frames)
    ids0 = _active(outs[2])
    id_a = min(ids0, key=lambda i: ids0[i][0])
    id_b = max(ids0, key=lambda i: ids0[i][0])
    last = _active(outs[-1])
    assert id_a != id_b and set(last) == {id_a, id_b}
    assert last[id_a][0] > last[id_b][0]  # A started left, ends right


def test_occlusion_reid_recovery():
    frames = [[(*_box(t), 0.9, 0, 5)] for t in range(4)] + [[]] * 6
    frames += [[(*_box(10 + i), 0.9, 0, 5)] for i in range(2)]
    outs = _run(frames)
    assert set(_active(outs[3])) == {1}
    assert _active(outs[9]) == {}
    assert set(_active(outs[-1])) == {1}


def test_max_age_prunes():
    frames = [[(*_box(t), 0.9, 0, 5)] for t in range(4)] + [[]] * 6
    frames += [[(*_box(t), 0.9, 0, 5)] for t in (10, 11, 12)]
    outs = _run(frames, tss.StrongSortConfig(max_age=3, gmc_method="none"))
    assert set(_active(outs[-1])) == {2}


def test_low_conf_detections_ignored():
    outs = _run([[(*_box(t), 0.1, 0, 5)] for t in range(4)])
    assert all(_active(o) == {} for o in outs)
