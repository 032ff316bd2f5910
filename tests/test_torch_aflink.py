"""The port's learned AFLink linker (track/aflink.py) and its trainer
(tools/train_aflink.py) against the JAX package's.

Tolerances: the logits of the port's ``nn.Conv1d``/``nn.Linear`` forward
sum in another order than the jitted JAX forward, so they are held within
1e-5 x max(1, |logit|) (the shipped net's logits reach ~300, where a
float32 unit is 3e-5); link costs, 1 - sigmoid, within 1e-5; five Adam
steps from the same initial weights on the same batches within 1e-5 of
optax's ``adam(1e-3)``, parameter for parameter. Everything host-side
(pair features, trajectories, pairs, linking, GSI) is equal exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from strongsort_yolo_tpu.track import aflink as jaf
from strongsort_yolo_tpu.track import postprocess as jpp
from strongsort_yolo_tpu_torch.tools import train_aflink as tta
from strongsort_yolo_tpu_torch.track import aflink as taf
from strongsort_yolo_tpu_torch.track import postprocess as tpp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                "tools"))
import train_aflink as jta  # noqa: E402  the repo's JAX trainer

TOL = 1e-5


def close(got, want) -> float:
    """Largest |got - want| / max(1, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.fixture(scope="module")
def jparams():
    return jaf.load_aflink(jaf.default_checkpoint())


@pytest.fixture(scope="module")
def model():
    return taf.load_aflink(taf.default_checkpoint(), "cpu")


@pytest.fixture(scope="module")
def fresh_pairs():
    """The JAX test's fresh pairs (tests/test_aflink.py)."""
    rng = np.random.default_rng(1234)  # not the training seed
    return jta.make_pairs(rng, jta.make_trajectories(rng, 30), 400, 400)


@pytest.fixture(scope="module")
def jax_fwd():
    return jax.jit(jaf.aflink_logits)


def jax_tree(params):
    return jax.tree.map(np.asarray, params)


def test_trajectories_and_pairs_equal_the_repo_trainer():
    for seed in (0, 1234):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        ja, ta = jta.make_trajectories(a, 12), tta.make_trajectories(b, 12)
        assert all(np.array_equal(x, y) for x, y in zip(ja, ta))
        jp, tp = jta.make_pairs(a, ja, 50, 50), tta.make_pairs(b, ta, 50, 50)
        assert all(np.array_equal(x, y) for x, y in zip(jp, tp))
        assert a.integers(1 << 30) == b.integers(1 << 30)  # same draws used
    rows = ja[0][:40]
    for x, y in zip(jaf.pair_features(rows[:20], rows[25:]),
                    taf.pair_features(rows[:20], rows[25:])):
        assert np.array_equal(x, y)


def test_shipped_checkpoint_loads_as_the_jax_tree(jparams, model):
    sd = taf.aflink_params_from_jax(jax_tree(jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert model.c1.weight.shape == (32, taf.FEAT, 3)
    assert model.c2.weight.shape == (32, 32, 3)
    assert model.h1.weight.shape == (64, 128)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(v).size for sub in jparams.values() for v in sub.values())


def test_save_round_trips_the_jax_layout(model, tmp_path):
    path = str(tmp_path / "af.npz")
    taf.save_aflink(path, model)
    want, got = np.load(taf.default_checkpoint()), np.load(path)
    assert sorted(want.files) == sorted(got.files)
    for k in want.files:
        assert np.array_equal(want[k], got[k]), k
    back = taf.load_aflink(path, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, back.state_dict()[k])


def test_logits_equal_jax_shipped(jparams, model, fresh_pairs, jax_fwd):
    fa, ma, fb, mb, _ = fresh_pairs
    want = np.asarray(jax_fwd(jparams, *map(jnp.asarray, (fa, ma, fb, mb))))
    assert close(taf.aflink_logits(model, fa, ma, fb, mb), want) <= TOL


@pytest.mark.parametrize("seed", [0, 3])
def test_logits_equal_jax_random_init(seed, fresh_pairs, jax_fwd):
    params = jaf.init_aflink(jax.random.PRNGKey(seed))
    m = taf.AFLink()
    m.load_state_dict(taf.aflink_params_from_jax(jax_tree(params)))
    fa, ma, fb, mb, _ = fresh_pairs
    want = np.asarray(jax_fwd(params, *map(jnp.asarray, (fa, ma, fb, mb))))
    assert close(taf.aflink_logits(m, fa, ma, fb, mb), want) <= TOL
    # short tracklets: the masked pooling of a 2-row segment
    fa2, ma2 = fa.copy(), ma.copy()
    ma2[:, 2:] = 0.0
    fa2[:, 2:] = 0.0
    want = np.asarray(jax_fwd(params, *map(jnp.asarray, (fa2, ma2, fb, mb))))
    assert close(taf.aflink_logits(m, fa2, ma2, fb, mb), want) <= TOL


@pytest.mark.parametrize("mutation", ["taps_reversed", "in_out_swapped"])
def test_wrong_conv_transpose_fails_the_bar(mutation, jparams, fresh_pairs,
                                            jax_fwd, monkeypatch):
    """The conversion WIO -> (out, in, width) matters: a kernel read
    backwards (convolution for correlation), or c2's input and output
    channels swapped, moves the logits far past the bar."""
    real = taf.conv_weight

    def wrong(w):
        w = np.asarray(w)
        if mutation == "taps_reversed":
            return real(w[::-1].copy())
        if w.shape[1] == w.shape[2]:
            return real(w.transpose(0, 2, 1))
        return real(w)

    monkeypatch.setattr(taf, "conv_weight", wrong)
    m = taf.AFLink()
    m.load_state_dict(taf.aflink_params_from_jax(jax_tree(jparams)))
    fa, ma, fb, mb, _ = fresh_pairs
    want = np.asarray(jax_fwd(jparams, *map(jnp.asarray, (fa, ma, fb, mb))))
    assert close(taf.aflink_logits(m, fa, ma, fb, mb), want) > 100 * TOL


def test_pairwise_accuracy_through_the_port(model, fresh_pairs):
    fa, ma, fb, mb, y = fresh_pairs
    logits = taf.aflink_logits(model, fa, ma, fb, mb)
    assert float(np.mean((logits > 0) == (y > 0.5))) >= 0.95


def cut_tracks():
    """tests/test_aflink.py's 8 trajectories, each cut once."""
    trajs = tta.make_trajectories(np.random.default_rng(77), 8, t_len=120)
    recs = []
    for k, tr in enumerate(trajs):
        cut, gap = 50 + 3 * k, 4 + k
        recs += [(int(r[0]), 2 * k + 1, *r[1:5]) for r in tr[:cut]]
        recs += [(int(r[0]), 2 * k + 2, *r[1:5]) for r in tr[cut + gap:]]
    return recs


def test_cost_fn_and_linking_equal_jax(jparams, model):
    tracks = tpp.records_to_tracks(cut_tracks())
    assert len(tracks) == 16
    ordered = [tracks[t] for t in sorted(tracks)]
    want = jaf.make_cost_fn(jparams)(ordered)
    got = taf.make_cost_fn(model)(ordered)
    assert got.dtype == want.dtype and np.array_equal(got == 10.0, want == 10.0)
    assert float(np.max(np.abs(got - want))) <= TOL
    linked = tpp.link_tracklets(tracks, cost_fn=taf.make_cost_fn(model),
                                link_thresh=0.5)
    jlinked = jpp.link_tracklets(tracks, cost_fn=jaf.make_cost_fn(jparams),
                                 link_thresh=0.5)
    assert list(linked) == list(jlinked)
    assert all(np.array_equal(linked[t], jlinked[t]) for t in linked)
    # the JAX test's bar: every cut healed with the earlier, odd id
    assert set(linked) == {2 * k + 1 for k in range(8)}
    for k in range(8):
        frames = linked[2 * k + 1][:, 0]
        assert frames[0] == 0 and frames[-1] == 119


def test_cost_fn_separates_pairs(model):
    t = np.arange(60, dtype=float)
    x = 100.0 + 6.0 * t
    rows = np.stack([t, x, 50 + 0 * t, x + 40, 130 + 0 * t], 1)
    a, b = rows[:30], rows[36:]
    decoy = b.copy()
    decoy[:, [1, 3]] += 400.0
    cost = taf.make_cost_fn(model)([a, b, decoy])
    assert cost[0, 1] < 0.2 and cost[0, 2] > 0.8 and cost[1, 0] == 10.0
    assert np.all(taf.make_cost_fn(model)([a]) == 10.0)


def test_strongsort_pp_aflink_equals_jax():
    t = np.arange(40, dtype=float)
    x = 50.0 + 5.0 * t
    recs = [(int(tt), 1, xx, 50.0, xx + 40.0, 130.0)
            for tt, xx in zip(t[:18], x[:18])]
    recs += [(int(tt), 2, xx, 50.0, xx + 40.0, 130.0)
             for tt, xx in zip(t[24:], x[24:])]
    out = tpp.strongsort_pp(recs, aflink=True, link_thresh=0.5, device="cpu")
    assert out == jpp.strongsort_pp(recs, aflink=True, link_thresh=0.5)
    assert {r[1] for r in out} == {1}
    frames = sorted(r[0] for r in out)
    assert frames[0] == 0 and frames[-1] == 39
    path = taf.default_checkpoint()
    assert out == tpp.strongsort_pp(recs, aflink=path, link_thresh=0.5,
                                    device="cpu")


def test_adam_steps_equal_optax(fresh_pairs):
    """Five steps of the port's train_step (torch Adam, lr 1e-3, mean BCE
    with logits) against the JAX trainer's step (optax adam(1e-3),
    sigmoid_binary_cross_entropy) from the same init on the same
    batches."""
    params = jaf.init_aflink(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, fa, ma, fb, mb, y):
        def loss_fn(p):
            logits = jaf.aflink_logits(p, fa, ma, fb, mb)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    model = taf.AFLink()
    model.load_state_dict(taf.aflink_params_from_jax(jax_tree(params)))
    topt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = np.random.default_rng(5)
    for _ in range(5):
        sel = rng.integers(0, len(fresh_pairs[-1]), 128)
        batch = [a[sel] for a in fresh_pairs]
        params, opt_state, loss = step(params, opt_state, *batch)
        tloss = tta.train_step(model, topt, *map(torch.from_numpy, batch))
        assert close(float(tloss), float(loss)) <= TOL
        want = taf.aflink_params_from_jax(jax_tree(params))
        for k, v in model.state_dict().items():
            assert close(v.numpy(), want[k].numpy()) <= TOL, k


def test_trainer_main_runs_and_learns(tmp_path):
    out = str(tmp_path / "af.npz")
    res = tta.main(["--steps", "30", "--batch", "256", "--device", "cpu",
                    "--out", out])
    (first, l0), (last, l1) = res["losses"][0], res["losses"][-1]
    assert (first, last) == (0, 29) and l1 < l0 and 0.5 < res["val_acc"] <= 1
    m = taf.load_aflink(out, "cpu")
    assert all(torch.isfinite(p).all() for p in m.parameters())
    with pytest.raises(SystemExit):  # --out is required
        tta.main(["--steps", "1", "--device", "cpu"])
