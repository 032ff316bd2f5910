"""The port's multi-device layer (parallel/) against the JAX package's, on
the CPU: meshes that repeat the CPU device stand for several cards, and
the JAX side runs on the conftest's virtual 8-device CPU mesh.

- Mesh axes and the sharding rule: ``down4``'s 256-channel weight splits
  to 128 per tp rank, the stem's 16 stay whole, and the port's rule picks
  the same tensors as JAX's ``make_param_shardings``, key for key
  through ``params_from_jax``.
- ``StreamBatch`` over dp=4 (the JAX cases: shapes, frame counters,
  independent states) and equal to the JAX ``StreamBatch`` on a 4-device
  mesh: the same valid rows, boxes within 1e-3 px, scores within 1e-5,
  track ids and active flags equal.
- ``track_batch_prepare(mesh=)``, S=8 over dp=4 at imgsz 160, float32,
  ByteTrack and StrongSORT with the fused OSNet (K6's plain version; the
  JAX side through its fused stage kernel in interpret mode): equal to
  the unsharded port (rows, ids and classes equal, boxes within 1e-3 px,
  scores within 1e-5: a block's forward runs a smaller batch, which the
  CPU's convs may round otherwise in the last bit) and to the JAX meshed
  ``BatchedPipeline`` with boxes within 1e-3 px and equal ids, the bar
  of ``test_batched_pipeline_on_mesh_equals_unsharded``.
- One dp=2 x tp=2 train step in 4 gloo processes from the trained
  synth160 asset (imgsz 64, batch 4) against the one-process port step
  and the JAX step on a 2 x 2 mesh. float32 bars: the loss and every
  metric within 1e-6 relative of the one-process port step (the dp mean
  of two half-batch means, the tp sums of channel parts) and 1e-4 of
  JAX's (the conv summation order); every tensor's clipped gradient
  within 1e-4 of its norm; the updated parameters within 1e-6 of both
  wherever the gradient entry is above 1e-6 and 1e-3 of its tensor's
  norm (Adam's first step is lr * g / (|g| + eps): an entry at the
  rounding noise of its sums may take either sign).

Multi-process cases: each rank runs one intra-op thread, meets the
others through a file under ``tmp_path``, has a 60 s collective timeout,
and the launch is joined within a deadline.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.models import osnet as josnet
from strongsort_yolo_tpu.models import porting as jporting
from strongsort_yolo_tpu.models import yolo as jyolo
from strongsort_yolo_tpu.parallel import mesh as jmesh
from strongsort_yolo_tpu.parallel.streams import StreamBatch as JStreamBatch
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu.tools import train as jtrain
from strongsort_yolo_tpu.train import trainer as jtrainer
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models import porting
from strongsort_yolo_tpu_torch.models import yolo as tyolo
from strongsort_yolo_tpu_torch.ops.cuda import osnet_kernel
from strongsort_yolo_tpu_torch.parallel import ranks as tranks
from strongsort_yolo_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh, make_param_shardings, replicate,
)
from strongsort_yolo_tpu_torch.parallel.streams import StreamBatch
from strongsort_yolo_tpu_torch.pipeline import Pipeline, ShardedBatchedPipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig, bytetrack_step
from strongsort_yolo_tpu_torch.track.state import init_track_state
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
from strongsort_yolo_tpu_torch.train import trainer as tt

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
CKPT = os.path.join(ASSETS, "yolov8n_synth160.npz")
OSNET = os.path.join(ASSETS, "osnet_x0_25_synth.npz")
CPU4 = ["cpu"] * 4
IMGSZ, LR = 64, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(n, tp=1):
    return jmesh.make_mesh(n, tp=tp, devices=jax.devices("cpu")[:n])


# -- (i) meshes and the sharding rule --------------------------------------

def test_mesh_axes():
    mesh = make_mesh(8, tp=2, devices=["cpu"] * 8)
    assert dict(mesh.shape) == {"dp": 4, "tp": 2}
    assert mesh.devices.shape == (4, 2) and mesh.axis_names == ("dp", "tp")
    assert dict(jax_mesh(8, tp=2).shape) == dict(mesh.shape)
    with pytest.raises(ValueError, match="dp"):
        make_mesh(4, dp=3, devices=CPU4)
    s = batch_sharding(mesh)
    assert s.shard_shape((8, 3, 5)) == (2, 3, 5)
    assert replicate(mesh).shard_shape((8, 3)) == (8, 3)


def test_param_shardings_tp():
    cfg = tyolo.build_model("yolov8n")
    model = tyolo.init_model(cfg, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    sh = make_param_shardings(model, make_mesh(8, tp=2, devices=["cpu"] * 8))
    w = sd["backbone.down4.w"]  # cout = 256, OIHW
    assert w.shape[0] == 256
    assert sh["backbone.down4.w"].shard_shape(w.shape) == (128, *w.shape[1:])
    assert sh["backbone.down4.bn_var"].shard_shape((256,)) == (128,)
    stem = sd["backbone.stem.w"]  # cout = 16
    assert sh["backbone.stem.w"].shard_shape(stem.shape) == tuple(stem.shape)
    mesh1 = make_mesh(8, tp=1, devices=["cpu"] * 8)
    assert all(s.replicated for s in make_param_shardings(sd, mesh1).values())


@pytest.mark.parametrize("name", ["yolov8n", "yolo11n-pose", "yolov8n-seg"])
def test_shard_rule_picks_the_jax_tensors(name):
    """Each JAX leaf marked 1.0 where JAX's rule splits it and 0.0 where it
    replicates it, through params_from_jax: every port tensor carries the
    mark of its own rule's choice."""
    jcfg = jyolo.build_model(name)
    tree = jyolo.init_model(jax.random.PRNGKey(0), jcfg)
    jsh = jmesh.make_param_shardings(tree, jax_mesh(8, tp=2))
    marks = jax.tree.map(
        lambda leaf, s: np.full(leaf.shape, float(s.spec != jax.sharding.
                                                  PartitionSpec()), np.float32),
        tree, jsh)
    sd = porting.params_from_jax(marks, tyolo.build_model(name))
    ours = make_param_shardings(sd, make_mesh(8, tp=2, devices=["cpu"] * 8))
    split = 0
    for key, t in sd.items():
        assert np.unique(t.numpy()).size == 1, key
        assert bool(t.flatten()[0]) == (not ours[key].replicated), key
        split += not ours[key].replicated
    assert split > 50


# -- (ii) StreamBatch --------------------------------------------------------

def _synth_frames(n, t, seed=1):
    return np.stack([np.stack(list(SyntheticDetSource(
        num_frames=t, size=(320, 320), num_objects=3, seed=seed + s)))
        for s in range(n)], 1)


def test_stream_batch_sharded_end_to_end():
    """4 streams over dp=4, the JAX case: full detect + track steps with
    per-stream tracker state, on a 4-device mesh of the CPU."""
    cfg = tyolo.build_model("yolov8n")
    params = tyolo.init_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    sb = StreamBatch(params, cfg, DetectorConfig(imgsz=160, half=False, max_det=16),
                     ByteTrackConfig(gmc_method="none"), num_streams=4,
                     src_hw=(240, 320), track_slots=16,
                     mesh=make_mesh(4, devices=CPU4))
    assert [b.states.mean.shape[0] for b in sb.blocks] == [1, 1, 1, 1]
    frames = np.random.default_rng(0).integers(0, 255, (4, 240, 320, 3),
                                               dtype=np.uint8)
    dets, touts = sb.step(frames)
    assert dets.boxes.shape == (4, 16, 4)
    assert touts.active.shape == (4, 16)
    sb.step(frames)
    assert np.all(sb.states.frame_id.numpy() == 2)


def test_stream_batch_equals_jax_on_a_mesh():
    tree, jcfg, _ = jporting.load_npz_checkpoint(CKPT)
    cfg = porting.load_npz_checkpoint(CKPT)[1]
    frames = _synth_frames(4, 4)
    want = JStreamBatch(tree, jcfg, JDetectorConfig(imgsz=160, half=False,
                                                    max_det=16),
                        JByteTrackConfig(gmc_method="none"), num_streams=4,
                        src_hw=(320, 320), track_slots=16, mesh=jax_mesh(4))
    got = StreamBatch(porting.params_from_jax(tree, cfg), cfg,
                      DetectorConfig(imgsz=160, half=False, max_det=16,
                                     fuse=False),
                      ByteTrackConfig(gmc_method="none"), num_streams=4,
                      src_hw=(320, 320), track_slots=16,
                      mesh=make_mesh(4, devices=CPU4))
    tracked = 0
    for t in range(len(frames)):
        jd, jo = jax.device_get(want.step(frames[t]))
        td, to = got.step(frames[t])
        np.testing.assert_array_equal(td.valid.numpy(), jd.valid)
        v = jd.valid
        np.testing.assert_allclose(td.boxes.numpy()[v], jd.boxes[v], atol=1e-3)
        np.testing.assert_allclose(td.scores.numpy()[v], jd.scores[v], atol=1e-5)
        np.testing.assert_array_equal(to.active.numpy(), jo.active)
        a = jo.active
        np.testing.assert_array_equal(to.track_id.numpy()[a], jo.track_id[a])
        np.testing.assert_allclose(to.boxes.numpy()[a], jo.boxes[a], atol=1e-3)
        tracked += int(a.sum())
    assert v.sum() >= 4 and tracked >= 4


def test_stream_states_independent():
    """Detections in stream 0 must not leak tracks into stream 1."""
    cfg = ByteTrackConfig()
    states = init_track_state(2, 8)
    boxes = torch.zeros((2, 4, 4))
    boxes[0, 0] = torch.tensor([10.0, 10, 50, 50])
    scores = torch.zeros((2, 4))
    scores[0, 0] = 0.9
    for _ in range(3):
        states, outs = bytetrack_step(states, boxes, scores,
                                      torch.zeros((2, 4), dtype=torch.int32),
                                      scores > 0, cfg)
    assert int(outs.active[0].sum()) == 1
    assert int(outs.active[1].sum()) == 0


# -- (iii) the serving path over dp ------------------------------------------

@pytest.mark.parametrize("tracker", ["bytetrack", "strongsort_fused"])
def test_batched_pipeline_on_mesh_equals_unsharded_and_jax(tracker, monkeypatch):
    S, T = 8, 3
    frames = _synth_frames(S, T)
    det = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16,
               half=False)
    kw = dict(track_slots=16, tracker_max_dets=16)
    if tracker == "bytetrack":
        port_t = ByteTrackConfig(tracker_type="bytetrack")
        jax_t = JByteTrackConfig(tracker_type="bytetrack")
        fused = {}
    else:
        port_t = StrongSortConfig(gmc_method="none")
        jax_t = JStrongSortConfig(gmc_method="none")
        kw.update(reid_topk=16, reid_weights=OSNET)
        fused = dict(reid_fused=True)
        apply = josnet.osnet_apply
        monkeypatch.setattr(josnet, "osnet_apply", lambda *a, **k: apply(
            *a, **{**k, "fused": True, "interpret": True}))
    pipe = Pipeline(DetectorConfig(**det), tracker=port_t, device="cpu",
                    **fused, **kw)
    plain = pipe.track_batch_prepare(S, (320, 320))
    ref = [plain.step(frames[t]) for t in range(T)]
    launches = osnet_kernel.os_stage.launches
    sharded = pipe.track_batch_prepare(S, (320, 320),
                                       mesh=make_mesh(4, devices=CPU4))
    assert isinstance(sharded, ShardedBatchedPipeline)
    # streams really split over dp: 2 a block, one model copy on the CPU
    assert [b.num_streams for b in sharded.blocks] == [2] * 4
    assert all(b.pipeline is pipe for b in sharded.blocks)
    handles = [sharded.step_async(frames[t]) for t in range(T)]
    got = [sharded.materialize(h) for h in handles]
    assert osnet_kernel.os_stage.launches == launches  # the plain version
    jpipe = JPipeline(JDetectorConfig(**det), tracker=jax_t, **kw)
    jbatch = jpipe.track_batch_prepare(S, (320, 320), mesh=jax_mesh(4))
    want = [jbatch.step(frames[t]) for t in range(T)]
    rows = 0
    for t in range(T):
        for s in range(S):
            a, b, j = ref[t][s].boxes, got[t][s].boxes, want[t][s].boxes
            assert len(b) == len(a), (t, s)
            np.testing.assert_array_equal(b.id, a.id)
            np.testing.assert_array_equal(b.cls, a.cls)
            np.testing.assert_allclose(b.xyxy, a.xyxy, atol=1e-3)
            np.testing.assert_allclose(b.conf, a.conf, atol=1e-5)
            assert len(b) == len(j), (t, s)
            np.testing.assert_allclose(b.xyxy, j.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.id, j.id)
            rows += len(b)
    assert rows >= S * T // 2
    states = sharded.states
    assert states.frame_id.shape == (S,) and np.all(states.frame_id.numpy() == T)


def test_mesh_refusals():
    pipe = Pipeline(DetectorConfig(weights=CKPT, imgsz=160, half=False,
                                   max_det=16),
                    tracker=StrongSortConfig(gmc_method="none"), device="cpu",
                    reid_weights=OSNET, reid_topk=16, track_slots=16,
                    tracker_max_dets=16, reid_cadence=2)
    with pytest.raises(ValueError, match="reid_cadence"):
        pipe.track_batch_prepare(4, (320, 320), mesh=make_mesh(2, devices=CPU4))
    pipe.reid_cadence = 1
    with pytest.raises(ValueError, match="dp=4"):
        pipe.track_batch_prepare(6, (320, 320), mesh=make_mesh(4, devices=CPU4))


# -- (iv) training over dp x tp ranks ----------------------------------------

@pytest.fixture(scope="module")
def batch():
    imgs, tg = jtrain.synthetic_batch(np.random.default_rng(0), 4, IMGSZ)
    return np.array(imgs), {k: np.array(v) for k, v in tg.items()}


def _port_one_process(batch):
    tree, cfg, _ = porting.load_npz_checkpoint(CKPT)
    model = porting.model_from_state_dict(porting.params_from_jax(tree, cfg), cfg)
    state = tt.train_state(model, tt.make_optimizer(LR))
    state, m = tt.make_train_step(cfg, IMGSZ, tt.make_optimizer(LR))(state, *batch)
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    grads = {k: t.grad.numpy() for k, t in
             list(state.model.named_parameters()) + list(state.model.named_buffers())
             if t.grad is not None}
    return {k: float(v) for k, v in m.items()}, sd, grads


def _jax_mesh_step(batch):
    tree, cfg, _ = jporting.load_npz_checkpoint(CKPT)
    mesh = jax_mesh(4, tp=2)
    tx = jtrainer.make_optimizer(LR)
    params = jax.device_put(tree, jmesh.make_param_shardings(tree, mesh))
    state = jtrainer.TrainState(params, tx.init(params), jnp.int32(0))
    step = jtrainer.make_train_step(cfg, IMGSZ, tx)
    state, m = step(state, *jtrainer.shard_batch(mesh, *batch))
    return {k: float(v) for k, v in m.items()}, jax.device_get(state.params), cfg


def test_dp2_tp2_train_step_equals_one_process_and_jax(batch, tmp_path):
    mesh = make_mesh(4, tp=2, devices=CPU4)
    ranks = tranks.launch(torch_mesh_ranks.step_from_checkpoint, mesh,
                          (CKPT, IMGSZ, LR, *batch), rundir=str(tmp_path),
                          timeout=240, pg_timeout=60, threads=1)
    assert [r["threads"] for r in ranks] == [1] * 4
    # each tp rank holds half of down4's 256 output channels, the stem whole
    assert ranks[1]["shapes"]["backbone.down4.w"] == (128, 128, 3, 3)
    assert ranks[1]["shapes"]["backbone.down4.bn_mean"] == (128,)
    assert ranks[1]["shapes"]["backbone.stem.w"] == (16, 3, 3, 3)
    metrics = ranks[0]["metrics"]
    assert all(r["metrics"] == metrics for r in ranks)  # the global batch's
    assert metrics["num_fg"] > 0
    one, one_sd, one_grads = _port_one_process(batch)
    jm, jparams, jcfg = _jax_mesh_step(batch)
    for k, v in one.items():
        assert v == pytest.approx(metrics[k], rel=1e-6), k
        assert jm[k] == pytest.approx(metrics[k], rel=1e-4), k
    grads = ranks[0]["grads"]
    assert set(grads) == set(one_grads)
    for k, g in one_grads.items():
        assert np.abs(grads[k] - g).max() <= 1e-4 * np.linalg.norm(g), k
    start = {k: v.numpy() for k, v in porting.params_from_jax(
        porting.load_npz_checkpoint(CKPT)[0], jcfg).items()}
    jax_sd = {k: v.numpy() for k, v in porting.params_from_jax(
        jparams, jcfg).items()}
    got = ranks[0]["state"]
    for k, g in one_grads.items():
        sure = (np.abs(g) > 1e-6) & (np.abs(g) > 1e-3 * np.linalg.norm(g))
        assert not sure.any() or np.abs(got[k] - start[k])[sure].min() > 0, k
        np.testing.assert_allclose(got[k][sure], one_sd[k][sure], atol=1e-6,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k][sure], jax_sd[k][sure], atol=1e-6,
                                   rtol=0, err_msg=k)


def test_a_failing_rank_fails_the_run(tmp_path):
    """Rank 1 raises while the others wait in a barrier it never joins:
    the launch raises with its traceback and ends every process."""
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        tranks.launch(torch_mesh_ranks.fail_on_rank, make_mesh(2, devices=CPU4),
                      (1,), rundir=str(tmp_path), timeout=60, pg_timeout=30,
                      threads=1)
