"""The pipeline's spans and crop counters (``Pipeline.spans``,
``crop_slots``, ``crop_real``) on a CPU ``BatchedPipeline`` tick:
StrongSORT with the trained synth160 detector and OSNet, two streams.

- With no profiler running a span opens no profiler range, yet every
  span of the tick is counted once.
- Under ``torch.profiler`` the tick's spans are ranges of the trace,
  nested in ``ssyt.tick``, operator-scope records (no user annotation,
  so no mirror on a GPU row), ``ssyt.tick`` and ``ssyt.materialize``
  carrying the tick's number.
- The crop counters add up ``embed_slots``' G and real slots; a twin
  from ``on_device`` starts from zero with a recorder of its own, and
  with no tracker graph and zero tracker-step counters.
- On the CPU ``associate`` steps eagerly: no graph, no capture span,
  ``track_eager`` counting every step, the results those of the tracker
  step called as ``associate`` called it before it had graphs.
- ``utils/graphs.copy_all`` copies every dtype bit for bit, one foreach
  copy per element size for the contiguous pairs and the others alone.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import (
    ByteTrackConfig,
    bytetrack_step,
)
from strongsort_yolo_tpu_torch.track.strongsort import (
    StrongSortConfig,
    strongsort_step,
)
from strongsort_yolo_tpu_torch.utils import graphs, profiling
from strongsort_yolo_tpu_torch.utils.profiling import StageTimers
from track_ticks import make_ticks

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
HW = (320, 320)
# the spans of a CPU tick (no frame ring there, no GMC with gmc none)
TICK_SPANS = ("ssyt.detect.letterbox", "ssyt.detect.model", "ssyt.detect.nms",
              "ssyt.embed.start", "ssyt.embed.count_wait", "ssyt.embed.crop",
              "ssyt.embed.reid", "ssyt.track", "ssyt.download")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(t, s=2):
    """S frames of dark noise with shaded 64-pixel squares on a 3x3 grid
    (the synth160 detector's training distribution), drifting by t."""
    h, w = HW
    out = np.empty((s, h, w, 3), np.uint8)
    for k in range(s):
        f = (np.random.default_rng(1000 + 7 * t + k).uniform(0, 0.3, (h, w, 3))
             * 255).astype(np.uint8)
        for i in range(3 + 2 * k):
            r, c = divmod(i % 9, 3)
            x, y = c * 106 + 12 + t % 5, r * 106 + 12 + t % 3
            f[y:y + 64, x:x + 64] = int((0.5 + 0.16 * (i % 3)) * 255)
        out[k] = f
    return out


def _batched(pipe=None):
    pipe = pipe or Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
        tracker=StrongSortConfig(gmc_method="none"), track_slots=16,
        tracker_max_dets=16, reid_topk=16, reid_weights=OSNET, device="cpu")
    return pipe, BatchedPipeline(pipe, 2, HW)


def test_no_profiler_no_range_but_every_span_counted(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_Record", lambda *a: opened.append(a))
    pipe, bp = _batched()
    bp.materialize(bp.step_async(_frames(0)))
    assert opened == []
    counts = dict(pipe.spans.count)
    assert counts == {name: 1 for name in
                      ("ssyt.tick", "ssyt.materialize") + TICK_SPANS}
    bp.step(_frames(1))
    assert set(pipe.spans.count.values()) == {2}
    tick = pipe.spans.total["ssyt.tick"]
    assert 0.0 < sum(pipe.spans.total[n] for n in TICK_SPANS) <= tick


def test_profiled_tick_nests_its_spans_and_carries_its_number():
    pipe, bp = _batched()
    bp.step(_frames(0))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        bp.materialize(bp.step_async(_frames(1)))
    spans = {}
    for e in prof.events():
        if e.name.startswith("ssyt."):
            assert e.name not in spans, e.name
            spans[e.name] = e
    assert set(spans) == {"ssyt.tick", "ssyt.materialize", *TICK_SPANS}
    tick = spans["ssyt.tick"].time_range
    for name in TICK_SPANS:
        r = spans[name].time_range
        assert tick.start <= r.start <= r.end <= tick.end, name
    assert spans["ssyt.materialize"].time_range.start >= tick.end
    for name in ("ssyt.tick", "ssyt.materialize"):
        assert spans[name].kwinputs == {"tick": 1}
    assert not any(e.is_user_annotation for e in spans.values())
    # inside the spans, the detector's and tracker's operators
    assert any(c.name.startswith("aten::")
               for c in spans["ssyt.detect.model"].cpu_children)
    assert pipe.spans.count["ssyt.tick"] == 2


def test_crop_counters_and_a_twin_from_zero():
    pipe, bp = _batched()
    got, embed_slots = [], pipe.embed_slots

    def recording(counts, mask=None):
        slots = embed_slots(counts, mask)
        got.append((slots.shape[1], int(slots[2].sum())))
        return slots

    pipe.embed_slots = recording
    for t in range(2):
        bp.step(_frames(t))
    g, real = (sum(x) for x in zip(*got))
    assert len(got) == 2 and 0 < real < g and g % 8 == 0
    assert (pipe.crop_slots, pipe.crop_real) == (g, real)
    twin = pipe.on_device(torch.device("cpu", 0))
    assert twin is not pipe
    assert (twin.crop_slots, twin.crop_real, twin.count_waits) == (0, 0, 0)
    assert pipe.track_eager == 2 and twin._track_graphs == {}
    assert twin._track_graphs is not pipe._track_graphs
    assert (twin.track_captures, twin.track_replays, twin.track_eager) == (
        0, 0, 0)
    assert twin.spans is not pipe.spans and not twin.spans.count
    assert twin._copies.spans is twin.spans
    _, twin_bp = _batched(twin)
    twin_bp.step(_frames(0))
    assert twin.crop_slots == got[0][0] and twin.spans.count["ssyt.tick"] == 1
    assert (pipe.crop_slots, pipe.spans.count["ssyt.tick"]) == (g, 2)


def test_stage_timers_reset_and_a_bare_range():
    t = StageTimers()
    with t.stage("ssyt.a", 5):
        pass
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with t.stage("ssyt.a", 6):
            torch.ones(4).add_(1)
        with t.stage("ssyt.b"):
            pass
    events = {e.name: e for e in prof.events() if e.name.startswith("ssyt.")}
    assert set(events) == {"ssyt.a", "ssyt.b"}
    assert events["ssyt.a"].kwinputs == {"tick": 6}
    assert events["ssyt.b"].kwinputs == {}
    assert t.count == {"ssyt.a": 2, "ssyt.b": 1}
    assert t.summary()["ssyt.a"]["count"] == 2
    t.reset()
    assert t.summary() == {} and t.report() == ""


def _step_before_graphs(pipe, states, det, warp, feats, has_app):
    """What ``associate`` computed before it had graphs."""
    t = pipe.tracker_max_dets
    rows = (det.boxes[:, :t], det.scores[:, :t], det.classes[:, :t],
            det.valid[:, :t])
    if pipe.is_strongsort:
        states, out = strongsort_step(states, *rows, feats, pipe.tracker_cfg,
                                      warp=warp, has_app=has_app)
    else:
        states, out = bytetrack_step(states, *rows, pipe.tracker_cfg,
                                     det_feats=feats, warp=warp)
    return states._replace(truncated_dets=states.truncated_dets
                           + det.valid[:, t:].sum(1, dtype=torch.int32)), out


@pytest.mark.parametrize("name", ["strongsort", "strongsort_cadence2",
                                  "botsort_reid_warp"])
def test_cpu_associate_steps_eagerly_as_before(name):
    """Eight ticks of synthetic detections through ``associate`` on the
    CPU, 3 streams of 20 detections cut to 16 on 16 slots: every field of
    the state and outputs equal to the tracker step called directly, no
    graph captured or replayed, every step counted eager, no capture
    span; tracks are confirmed and rows cut."""
    if name == "botsort_reid_warp":
        tracker = ByteTrackConfig(tracker_type="botsort",
                                  gmc_method="flow_tpu", with_reid=True)
    else:
        tracker = StrongSortConfig(gmc_method="none")
    pipe = Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=20),
        tracker=tracker, track_slots=16, tracker_max_dets=16, reid_topk=16,
        reid_weights=OSNET, device="cpu")
    s = 3
    got = want = pipe.init_states(s)
    active = 0
    for k, (det, feats, warp) in enumerate(
            make_ticks(5, s, 20, pipe.feat_dim, 8, objects=16)):
        feats, has_app = feats[:, :16], None
        if name == "strongsort_cadence2":
            has_app = (torch.arange(s) + k) % 2 == 0
            feats = feats * has_app[:, None, None]
        w = warp if pipe.gmc_method != "none" else None
        want, want_out = _step_before_graphs(pipe, want, det, w, feats,
                                             has_app)
        got, got_out = pipe.associate(got, det, w, feats, has_app)
        for a, b, field in zip((*want, *want_out), (*got, *got_out),
                               (*want._fields, *want_out._fields)):
            assert torch.equal(a, b), f"tick {k}: {field}"
        active += int(got_out.active.sum())
    assert active > 0 and int(got.truncated_dets.sum()) > 0
    assert (pipe.track_captures, pipe.track_replays, pipe.track_eager) == (
        0, 0, 8)
    assert pipe._track_graphs == {}
    assert pipe.spans.count["ssyt.track"] == 8
    assert "ssyt.track.capture" not in pipe.spans.count


def test_copy_all_is_exact_and_grouped_by_element_size(monkeypatch):
    """float32 NaN payloads, int32, bool, float64 and bfloat16 copied bit
    for bit; the contiguous pairs in one foreach copy per element size,
    a strided source and a pair of two dtypes copied alone."""
    gen = torch.Generator().manual_seed(0)
    nan = torch.tensor([0x7FC00001, 0x7F800002, -1], dtype=torch.int32)
    src = [
        torch.randn((3, 5), generator=gen),
        nan.view(torch.float32),
        torch.randint(-9, 9, (7,), generator=gen, dtype=torch.int32),
        torch.rand(6, generator=gen) > 0.5,
        torch.randn(4, generator=gen, dtype=torch.float64),
        torch.randn(5, generator=gen).to(torch.bfloat16),
        torch.randn((4, 6), generator=gen)[:, ::2],
        torch.randint(0, 9, (3,), generator=gen, dtype=torch.int32),
    ]
    dst = [torch.empty_like(x, memory_format=torch.contiguous_format)
           for x in src]
    dst[-1] = torch.empty(3, dtype=torch.int64)  # a pair of two dtypes
    calls, foreach = [], torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda d, s: calls.append(len(d)) or foreach(d, s))
    graphs.copy_all(dst, src)
    assert sorted(calls) == [1, 1, 1, 3]  # bf16, f64, bool; three of 4 bytes
    for d, x in zip(dst[:-1], src[:-1]):
        assert d.dtype == x.dtype and d.shape == x.shape
        assert torch.equal(d.view(torch.uint8), x.contiguous().view(torch.uint8))
    assert torch.equal(dst[-1], src[-1].long())
