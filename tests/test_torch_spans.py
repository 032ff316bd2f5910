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
  from ``on_device`` starts from zero with a recorder of its own.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
from strongsort_yolo_tpu_torch.utils import profiling
from strongsort_yolo_tpu_torch.utils.profiling import StageTimers

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
