"""The program's spans in a trace (``harness/spans.split``) on synthetic
profiler events, and the trace's reduction (``harness/trace.reduce``)
unmoved by them: the program's spans are host events, with no mirror on
the device row. And ``tick_split.k6_ops`` on the reference's layer shapes
against the program's own count of K6's stages."""

import types

import torch

from harness import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, device=CPU, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=a, end=b),
                                 is_user_annotation=annotation)


def one_tick(program=True):
    """bench.step_async over [0, 100]: ssyt.tick with the ring's fill at
    [10, 40] and the count wait at [60, 90]; kernels at [0, 5], [45, 55],
    [95, 120], a copy at [100, 104]; the slice ends at 130."""
    out = [ev("bench.step_async", 0, 100, annotation=True),
           ev("bench.step_async", 0, 120, CUDA, annotation=True),
           ev("k_a", 0, 5, CUDA), ev("k_b", 45, 55, CUDA),
           ev("k_c", 95, 120, CUDA), ev("Memcpy HtoD", 100, 104, CUDA),
           ev("aten::copy_", 12, 38), ev("cudaLaunchKernel", 1, 2),
           ev("cudaLaunchKernel", 44, 45), ev("cudaEventSynchronize", 61, 89),
           ev("cudaLaunchKernel", 93, 94), ev("bench.materialize", 101, 130)]
    if program:
        out += [ev("ssyt.tick", 0, 100), ev("ssyt.ring.fill", 10, 40),
                ev("ssyt.embed.count_wait", 60, 90), ev("ssyt.track", 92, 99)]
    return out


def test_idle_is_charged_piecewise_to_the_innermost_span():
    got = spans.split(one_tick(), 0, 130)
    us = {name: round(row["idle_s"] * 1e6, 6) for name, row in got.items()}
    # [5, 45]: tick 5, fill 30, tick 5; [55, 95]: tick 5, wait 30, tick 2,
    # track 3; [120, 130] outside every span
    assert us == {"ssyt.tick": 17.0, "ssyt.ring.fill": 30.0,
                  "ssyt.embed.count_wait": 30.0, "ssyt.track": 3.0,
                  spans.NONE: 10.0}
    assert got["ssyt.tick"]["host_s"] * 1e6 == 100.0
    assert got["ssyt.tick"]["count"] == got["ssyt.track"]["count"] == 1
    assert (got["ssyt.tick"]["launches"], got["ssyt.track"]["launches"]) == (2, 1)
    assert got["ssyt.embed.count_wait"]["syncs"] == 1
    assert sum(r["syncs"] for r in got.values()) == 1


def test_a_slice_without_program_spans_charges_no_span():
    got = spans.split(one_tick(program=False), 0, 130)
    assert list(got) == [spans.NONE]
    assert round(got[spans.NONE]["idle_s"] * 1e6, 6) == 90.0
    assert got[spans.NONE]["launches"] == 3


def test_nested_pieces():
    pieces = spans._innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                               (6, 8, "d"), (12, 14, "e")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                      (6, 8, "d"), (8, 10, "a"), (12, 14, "e")]


class FakeSlice:
    def __init__(self, events):
        self.prof = types.SimpleNamespace(events=lambda: events)
        self.t0, self.t1 = 0.0, 1.0


def test_program_spans_leave_the_reduction_as_it_was():
    """The parent's trace holds bench. spans alone: adding the program's
    host spans changes no field of the reduction."""
    before = trace.reduce(FakeSlice(one_tick(program=False)))
    after = trace.reduce(FakeSlice(one_tick()))
    assert after["busy_s"] == before["busy_s"]
    assert after["kernels"] == before["kernels"]
    assert after["device_ops"] == before["device_ops"]
    assert [g[1] for g in after["idle_gaps"]] == [g[1] for g in before["idle_gaps"]]
    assert not any(name.startswith(spans.PREFIX) for name in after["kernels"])


def test_k6_ops_are_the_three_stages_of_the_program():
    import tick_split
    from reference.osnet import Model
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import stage_specs
    from strongsort_yolo_tpu_torch.tools.prof_k6 import stage_macs

    for variant in ("osnet_x0_25", "osnet_x1_0"):
        m = Model(variant)
        want = 2.0 * sum(stage_macs(sp) for sp in stage_specs(m.c))
        assert tick_split.k6_ops(m, (128, 64)) == want
    assert tick_split.k6_ops(Model("osnet_x0_25"), (128, 64)) == 31493376.0
