"""The port's tools/eval_sequence.py (``run_arm``, ``eval_pp``, ``main``)
against the JAX package's on the first 48 frames of
``OcclusionRelayClip(cycles=1)``: the trained synth160 detector and the
trained OSNet-x0_25 with StrongSORT (λ=0.98), float32 on both sides.

Records carry the JAX records' ids, boxes within 1e-3 px (the bar of the
port's other pipeline parity tests); the metrics of both protocols (vis,
occ), of the arm and of its StrongSORT++ pass, are equal. The port's
batched arm at ``--cadence 1`` equals its classic ``track`` arm bit for
bit, as BASELINE.md says of the JAX package.
"""

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.media.video import OcclusionRelayClip as JaxRelayClip
from strongsort_yolo_tpu.tools import eval_sequence as jseq
from strongsort_yolo_tpu_torch.media.video import OcclusionRelayClip
from strongsort_yolo_tpu_torch.tools import eval_sequence as tseq

FRAMES = 48


class Prefix:
    """The first ``n`` frames of a clip, with its truth."""

    def __init__(self, clip, n: int):
        self.clip, self.n, self.h, self.w = clip, n, clip.h, clip.w

    def __iter__(self):
        for t, frame in zip(range(self.n), self.clip):
            yield frame

    def truth(self, t: int, include_hidden: bool = False):
        return self.clip.truth(t, include_hidden=include_hidden)


@pytest.fixture(scope="module")
def arms():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = jseq.run_arm(Prefix(JaxRelayClip(cycles=1), FRAMES), lam=0.98)
        got = tseq.run_arm(Prefix(OcclusionRelayClip(cycles=1), FRAMES),
                           lam=0.98, device="cpu")
        batched = tseq.run_arm(Prefix(OcclusionRelayClip(cycles=1), FRAMES),
                               lam=0.98, cadence=1, device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    return want, got, batched


def assert_records_close(got, want):
    assert len(got) == len(want) > 0
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert np.abs(np.array([r[2:] for r in got])
                  - np.array([r[2:] for r in want])).max() <= 1e-3


def test_run_arm_equals_jax(arms):
    (wm, wrec, wg), (gm, grec, gg), _ = arms
    assert_records_close(grec, wrec)
    assert gm == wm
    assert gg[:2] == wg[:2]  # the ground truth of both protocols
    assert gm["vis"]["gt"] > 60 and gm["occ"]["gt"] > gm["vis"]["gt"]


def test_eval_pp_equals_jax(arms):
    (_, wrec, wg), (_, grec, gg), _ = arms
    want = jseq.eval_pp(wrec, wg[:2])
    assert tseq.eval_pp(grec, gg[:2], device="cpu") == want
    # the port's pass on the JAX records: the same rows again
    assert tseq.eval_pp(wrec, wg[:2], device="cpu") == want


def test_cadence_one_equals_the_classic_arm(arms):
    _, (gm, grec, gg), (bm, brec, bg) = arms
    assert brec == grec and bm == gm and bg == gg


def test_main_refuses_a_missing_device_and_reads_lk_iters(monkeypatch):
    """``--lk-iters`` sets the port's gmc_flow schedule before any arm
    runs; the arms run on ``--device`` (here a device the CPU build does
    not have, which fails at the first pipeline)."""
    from strongsort_yolo_tpu_torch.track import gmc_flow

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    monkeypatch.setattr(gmc_flow, "_ITERS_BY_LEVEL", gmc_flow._ITERS_BY_LEVEL)
    with pytest.raises((RuntimeError, AssertionError)):
        tseq.main(["--cycles", "1", "--lk-iters", "3,4,5", "--device",
                   "cuda"])
    assert gmc_flow._ITERS_BY_LEVEL == (3, 4, 5)
