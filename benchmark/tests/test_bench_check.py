"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (2 streams of 180 x 320 frames, imgsz 160), the
program in float32 so that it and the reference agree to rounding:
the run is correct; each fault a cell can have, planted in the program
underneath, makes it not correct; and the control (the reference in a
lower precision in the program's place) fails a limit. The exchange
between chips is a fault no cell here can have: every cell takes one
chip."""

import dataclasses
import time

import pytest
import torch

from harness.cell import Cell, run_cell

SMALL = {"config": {"detector": {"imgsz": 160, "dtype": "float32"}},
         "traffic": {"streams": 2, "frame_hw": [180, 320], "ring": 3,
                     "objects": {"sizes_hw": [[40, 30], [30, 20]]}}}
SEED = 2**31 + 977
# cells whose files the benchmark keeps and BENCHMARK.json does not list yet
DEFERRED = {w["name"]: w for w in (
    {"name": "v8bot.s64.pan", "config": "yolov8n-botsort-flow",
     "traffic": "s64_pan_dense", "chips": 1},
    {"name": "v7ss.s32.sparse", "config": "yolov7-strongsort-osnet_x0_25",
     "traffic": "s32_fixed_sparse", "chips": 1})}


def cell(name, overrides=None):
    return Cell(name, overrides=overrides, entry=DEFERRED.get(name))


def run(name, hook=None, control=False, device="cpu", overrides=SMALL):
    torch.manual_seed(0)
    return run_cell(cell(name, overrides), SEED, 4.0, False,
                    t_start=time.perf_counter(), device=device, hook=hook,
                    control=control)


def limits_failed(result):
    return [k for k, c in result["checks"].items()
            if "limit" in c and not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", ["v7ss.s32.dense", "v8bot.s64.pan"])
def test_one_tick_float32_agrees(name):
    result, numbers, controls = run(name, control=True)
    assert result["correct"], result["checks"]
    exact = ("det_box_px_p50", "det_score", "det_missed", "nms_mismatch",
             "trk_mismatch", "state_mismatch")
    assert all(numbers[k] == 0.0 for k in exact), numbers
    # the control, on the same ticks, fails at least one limit
    limits = cell(name).cfg["limits"]
    assert any(controls[k] > v for k, v in limits.items() if k in controls), controls


def state_unchanged(pipe, bp):
    step = pipe.associate

    def frozen(states, *a, **k):
        return states, step(states, *a, **k)[1]

    pipe.associate = frozen


def half_the_batch(pipe, bp):
    detect = pipe.detect_with_extras

    def half(frames, k):
        kept = frames.clone()
        kept[len(kept) // 2:] = 0
        return detect(kept, k)

    pipe.detect_with_extras = half


def answer_altered(pipe, bp):
    step = pipe.associate

    def altered(*a, **k):
        states, out = step(*a, **k)
        return states, out._replace(track_id=out.track_id + 1)

    pipe.associate = altered


def conf_raised(pipe, bp):
    """Candidates lost before NMS: every stage after it still agrees with
    the reference on the program's own inputs; only the recall does not."""
    pipe.det_cfg = dataclasses.replace(pipe.det_cfg, conf=pipe.det_cfg.conf + 0.1)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, answer_altered,
                                   conf_raised], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    result, numbers, _ = run("v7ss.s32.dense", hook=fault)
    assert not result["correct"], numbers
    assert limits_failed(result)
    if fault is conf_raised:
        assert limits_failed(result) == ["det_missed"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v7ss.s32.dense", "v8bot.s64.pan", "v7ss.s32.sparse"])
def test_control_fails_on_the_card(card, name):
    """The control at a size a test run holds (4 streams of 1080p frames,
    the cell's own configuration in bfloat16): the program is correct,
    the control fails a limit."""
    small = {"traffic": {"streams": 4}}
    result, numbers, controls = run(name, control=True, device="cuda", overrides=small)
    assert result["correct"], result["checks"]
    limits = cell(name).cfg["limits"]
    assert any(controls[k] > v for k, v in limits.items() if k in controls), controls
