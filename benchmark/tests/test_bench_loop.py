"""The measured loop: every tick completed in the window counts toward
the tail, so a stall in one tick moves ``tick_p95_ms``."""

import time

import numpy as np

from harness import loop


class FakeResults:
    class boxes:
        xyxy = np.zeros((1, 4), np.float32)


class FakeBatched:
    """step_async returns at once; materialize of tick ``slow`` sleeps."""

    def __init__(self, slow=None):
        self.states, self.ring, self.last_warps = None, None, None
        self.slow, self.n = slow, 0

    def step_async(self, frames):
        self.n += 1
        return self.n - 1

    def materialize(self, handle):
        time.sleep(0.25 if handle == self.slow else 0.002)
        return [FakeResults()]


def p95(d):
    return float(np.percentile(np.asarray(d.latency_s), 95)) * 1e3


def test_one_stall_moves_the_tail():
    ticks = [np.zeros((1, 2, 2, 3), np.uint8)] * 3
    calm = loop.drive(FakeBatched(), ticks, 0, n=30)
    stall = loop.drive(FakeBatched(slow=10), ticks, 0, n=30)
    assert len(calm.latency_s) == len(stall.latency_s) == 29
    assert p95(calm) < 50.0 < p95(stall) or max(stall.latency_s) > 0.2
    # 29 ticks: the 95th percentile lies between the two largest, one of
    # which is the stall
    assert p95(stall) > 2 * p95(calm)


def test_window_counts_what_it_completed():
    ticks = [np.zeros((1, 2, 2, 3), np.uint8)]
    d = loop.drive(FakeBatched(), ticks, 0, seconds=0.1)
    assert d.completed == d.dispatched - 1 and d.t1 - d.t0 >= 0.1
