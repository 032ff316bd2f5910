"""Embed cadence and StrongSORT's motion-only fallback in the port, and the
fused OSNet slice end to end, against the JAX package.

- ``strongsort_step(..., has_app=)`` with every stream, no stream and
  alternate streams carrying appearance equals the JAX ``strongsort_step``
  vmapped over the streams (skipped streams carry zero features): same
  ids, statuses and det indices, float fields within 1e-4.
- ``BatchedPipeline`` with ``reid_cadence=2`` on the scenes of
  tests/test_reid_cadence.py (S=2, synth160 detector, trained OSNet,
  float32): the masks are staggered, one stream per tick, the crop batch
  halves against cadence 1, and ids and boxes equal the JAX
  ``track_batch_prepare(..., auto_topk=True)`` cadence-2 run (boxes
  within 1e-3 px) and, on the slow scene, the port's cadence-1 run (within
  1e-2 px, the JAX test's bound).
- ``Pipeline.track`` with ``reid_fused=True`` (K6's plain version on the
  CPU) gives the JAX ``Pipeline.track`` ids and boxes within 1e-3 px on a
  synth160 StrongSORT clip with the trained OSNet, the JAX side running
  its fused stage kernel in interpret mode; ``SSYT_OSNET=fused``, the
  JAX package's switch, selects that route when ``reid_fused`` is None.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.models import osnet as josnet
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track import strongsort as jss
from strongsort_yolo_tpu.track.state import init_track_state as j_init
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import os_stage
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track import strongsort as tss
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.state import init_track_state as t_init
from test_auto_topk import _frames
from test_torch_strongsort import D, FIELDS, TOL, _scenario

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
DET = dict(weights=CKPT, imgsz=160, half=False, max_det=16)
SIZES = dict(track_slots=16, tracker_max_dets=16, reid_topk=16,
             reid_weights=OSNET)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pattern", ["all", "none", "alternate"])
def test_strongsort_has_app_vs_jax(pattern):
    cfg_kw = dict(gmc_method="none")
    jcfg, tcfg = JStrongSortConfig(**cfg_kw), tss.StrongSortConfig(**cfg_kw)
    seqs = [_scenario(sd) for sd in (21, 22)]
    s, t_len = len(seqs), seqs[0][0].shape[0]
    jstep = jax.jit(jax.vmap(
        lambda st, b, sc, c, v, f, h: jss.strongsort_step(
            st, b, sc, c, v, f, jcfg, has_app=h)))
    jstate = jax.tree.map(lambda x: jnp.stack([x] * s), j_init(16, feat_dim=D))
    tstate = t_init(s, 16, feat_dim=D)
    for t in range(t_len):
        has_app = {"all": np.ones(s, bool), "none": np.zeros(s, bool),
                   "alternate": (np.arange(s) + t) % 2 == 0}[pattern]
        b, sc, c, v, f = (np.stack([seq[i][t] for seq in seqs])
                          for i in range(5))
        f = np.where(has_app[:, None, None], f, 0.0).astype(np.float32)
        jstate, jout = jstep(jstate, b, sc, c, v, f, has_app)
        tstate, tout = tss.strongsort_step(
            tstate, *(torch.from_numpy(a) for a in (b, sc, c, v, f)), tcfg,
            has_app=torch.from_numpy(has_app))
        for name in FIELDS:
            want, got = np.asarray(getattr(jstate, name)), getattr(tstate, name).numpy()
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, err_msg=f"t={t} {name}", **TOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"t={t} {name}")
        for name in ("track_id", "active", "det_index"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                          np.asarray(getattr(jout, name)))
    assert int(tstate.next_id.sum()) >= 8  # the objects became tracks


def _port_pipe(cadence=1, tracker=None):
    return Pipeline(DetectorConfig(**DET),
                    tracker=tracker or tss.StrongSortConfig(gmc_method="none"),
                    reid_cadence=cadence, device="cpu", **SIZES)


def _port_run(cadence, frame_seq):
    """-> (results per tick, G per tick, masks per tick)."""
    pipe = _port_pipe(cadence)
    bp = BatchedPipeline(pipe, 2, (320, 320))
    g, embed_slots = [], pipe.embed_slots

    def recording(counts, mask=None):
        slots = embed_slots(counts, mask)
        g.append(slots.shape[1])
        return slots

    pipe.embed_slots = recording
    res, masks = [], []
    for f in frame_seq:
        res.append(bp.step(f))
        masks.append(bp.last_embed_mask)
    return res, g, masks


def _assert_same(want, got, atol):
    for t, (rs_w, rs_g) in enumerate(zip(want, got)):
        for s, (a, b) in enumerate(zip(rs_w, rs_g)):
            assert len(a) == len(b), (t, s)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id,
                                          err_msg=f"t={t} s={s}")
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=atol,
                                       err_msg=f"t={t} s={s}")


def test_cadence_masks_stagger_and_the_crop_batch_halves():
    frame_seq = [_frames(t, 9) for t in range(6)]  # 9 objects per stream
    _, g1, masks1 = _port_run(1, frame_seq)
    _, g2, masks2 = _port_run(2, frame_seq)
    assert masks1 == [None] * 6
    masks2 = np.stack(masks2)
    assert (masks2.sum(1) == 1).all()  # one stream per tick
    np.testing.assert_array_equal(masks2[:, 0], np.arange(6) % 2 == 0)
    assert g1 == [32] * 6 and g2 == [16] * 6  # 9 dets -> 16 slots a stream


@pytest.mark.parametrize("scene", ["slow", "dense"])
def test_cadence_two_vs_jax(scene):
    n = 4 if scene == "slow" else 9
    frame_seq = [_frames(t, n) for t in range(8)]
    jp = JPipeline(JDetectorConfig(**DET),
                   tracker=JStrongSortConfig(gmc_method="none"),
                   reid_cadence=2, **SIZES)
    jb = jp.track_batch_prepare(2, (320, 320), auto_topk=True)
    want = [jb.step(f) for f in frame_seq]
    got, _, _ = _port_run(2, frame_seq)
    _assert_same(want, got, 1e-3)
    assert sum(len(r) for rs in got for r in rs) >= 2 * n * (8 - 3)
    if scene == "slow":  # motion alone pairs as appearance does
        ref, _, _ = _port_run(1, frame_seq)
        _assert_same(ref, got, 1e-2)


def test_cadence_errors():
    with pytest.raises(ValueError, match="reid_cadence"):
        _port_pipe(cadence=0)
    pipe = _port_pipe(2, ByteTrackConfig(tracker_type="botsort",
                                         with_reid=True, gmc_method="none"))
    with pytest.raises(ValueError, match="StrongSORT"):
        BatchedPipeline(pipe, 2, (320, 320))
    # a tracker without ReID has nothing to skip
    pipe = _port_pipe(2, "bytetrack.yaml")
    assert BatchedPipeline(pipe, 2, (320, 320)).cadence == 1


def test_fused_osnet_track_vs_jax(monkeypatch):
    """The fused slice end to end on the CPU: the port's K6 plain version
    inside Pipeline.track against the JAX Pipeline.track with the fused
    stage kernel in interpret mode, float32."""
    apply, calls = josnet.osnet_apply, []

    def fused_apply(*a, **k):
        calls.append(1)
        return apply(*a, **{**k, "fused": True, "interpret": True})

    monkeypatch.setattr(josnet, "osnet_apply", fused_apply)
    det = dict(DET, conf=0.3, iou=0.4)
    jp = JPipeline(JDetectorConfig(**det),
                   tracker=JStrongSortConfig(gmc_method="none"), **SIZES)
    tp = Pipeline(DetectorConfig(**det),
                  tracker=tss.StrongSortConfig(gmc_method="none"),
                  reid_fused=True, device="cpu", **SIZES)
    assert tp.reid._stages is not None
    frames = list(SyntheticDetSource(num_frames=6, size=(320, 320),
                                     num_objects=3, seed=2))
    before, rows = os_stage.launches, 0
    for t, f in enumerate(frames):
        want, got = jp.track(f), tp.track(f)
        _assert_same([[want]], [[got]], 1e-3)
        rows += len(got)
    assert rows >= 3 * (6 - 3)  # confirmed from the third hit on
    assert calls  # the JAX side traced its fused route
    assert os_stage.launches == before  # the CPU runs the plain version


def test_ssyt_osnet_selects_the_fused_route(monkeypatch):
    """reid_fused=None follows SSYT_OSNET; an explicit value wins."""
    def fused(**kw):
        pipe = Pipeline(DetectorConfig(**DET),
                        tracker=tss.StrongSortConfig(gmc_method="none"),
                        device="cpu", **SIZES, **kw)
        return pipe.reid._stages is not None

    monkeypatch.delenv("SSYT_OSNET", raising=False)
    assert not fused() and fused(reid_fused=True)
    monkeypatch.setenv("SSYT_OSNET", "fused")
    assert fused() and not fused(reid_fused=False)
