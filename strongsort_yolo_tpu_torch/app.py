"""Application layer: the per-source video loop and the multi-source runner.

Counterpart of ``strongsort_yolo_tpu/app.py``, the reference's
``process_video`` and launcher (``yolo_multi_model.py:244-354``):

- outputs ``output/{name}_output.mp4`` (15 fps default) and
  ``output/{name}_labels.txt`` per stream;
- ``--count`` without ``--track`` prints the reference's hint and stops;
- count overlay, FPS overlay, trajectory trails, optional live window
  with 'q' quit;
- multi-source: same-resolution streams run in lockstep as the leading
  axis of one :class:`~strongsort_yolo_tpu_torch.pipeline.BatchedPipeline`
  (one weight set, one tick for all), with per-stream reader threads;
  mixed resolutions form groups, run one after another;
- one-tick overlap: tick t is dispatched (``track_async`` /
  ``step_async``), then tick t - 1 is materialized, drawn and encoded
  while the card computes;
- per-stream error isolation, resume from a per-stream checkpoint, a
  JSON-lines event log, duplicate stream names suffixed.

Where the port differs from the JAX app:

- ``AppConfig.device``: the pipeline runs on the CUDA device unless the
  caller asks for the CPU (``device="cpu"``); without a card and without
  that, :func:`run` raises.
- Media: files decode through the native libav shim, else cv2; videos
  are written by the native encoder, else cv2; frames are drawn by cv2,
  else the native C++ shim. :func:`run` fails before the first frame
  where ``show`` needs cv2, ``save`` an encoder or the drawing a
  backend that this machine lacks (``media.media_status`` tells).
- The single-stream track state has a leading axis of 1; a checkpoint
  holds one stream in that form, so a stream stopped in a sequential run
  resumes in a batched one and the other way round.
- ``StreamStats.stage_times`` adds 'decode'; the batched loop also
  times each tick's 'decode' (waiting for the readers), 'stack' (the
  ``np.stack`` of the S frames), 'dispatch' (``step_async``) and
  'infer_track' (``materialize``), per tick of the group, the same
  figures in each of its streams.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import threading
import time

import numpy as np

from strongsort_yolo_tpu_torch.config import (
    DetectorConfig,
    TrackerConfig,
)
from strongsort_yolo_tpu_torch.media.annotator import make_annotator
from strongsort_yolo_tpu_torch.media.native_decoder import (
    NativeVideoReader,
    NativeVideoWriter,
    encoder_available,
    encoder_error,
)
from strongsort_yolo_tpu_torch.media.video import VideoReader, VideoWriter
from strongsort_yolo_tpu_torch.pipeline import Pipeline
from strongsort_yolo_tpu_torch.track.state import TrackState
from strongsort_yolo_tpu_torch.utils.checkpoint import restore_state, save_state
from strongsort_yolo_tpu_torch.utils.counting import LineCrossCounter, StreamingCounter
from strongsort_yolo_tpu_torch.utils.fps import FpsMeter
from strongsort_yolo_tpu_torch.utils.labels import LabelWriter
from strongsort_yolo_tpu_torch.utils.logging import EventLogger
from strongsort_yolo_tpu_torch.utils.profiling import StageTimers
from strongsort_yolo_tpu_torch.utils.trajectories import TrajectoryMemory


@dataclasses.dataclass
class AppConfig:
    sources: tuple[str, ...] = ("0",)
    track: bool = False
    count: bool = False
    weights: str = "yolov8n"
    tracker: str | TrackerConfig = "botsort.yaml"  # name, YAML path or
    # config object
    reid_weights: str | None = None  # OSNet variant name, .npz or .pt path
    conf: float = 0.3
    iou: float = 0.4
    max_det: int = 1000
    classes: tuple[int, ...] | None = None
    imgsz: int = 640
    output_dir: str = "output"
    out_fps: float = 15.0  # the reference writes 15 fps regardless
    show: bool = False  # live window (needs cv2)
    save: bool = True
    compat_labels: bool = False  # frame-id-0 + append mode (F9 quirks)
    half: bool = True
    max_frames: int | None = None
    seed: int = 0
    multi_mode: str = "batched"  # "batched": lockstep device batch for
    # same-resolution sources; "sequential": one source after another
    log_events: str | None = None  # JSON-lines event log
    resume: bool = False  # restore tracker state + frame position from
    # the per-stream checkpoint and continue
    tracker_max_dets: int = 128  # dets reaching association
    reid_topk: int = 128  # dets embedded per frame (ReID trackers); the
    # crop batch is sized from each tick's real detection counts
    reid_cadence: int = 1  # StrongSORT, batched: stream s embeds on ticks
    # where (s + tick) % cadence == 0
    quant: str | None = None  # "int8": PTQ of the detector conv stack
    # (ops/quant.py); activation scales calibrate on the first frame
    checkpoint_every: int = 0  # save the tracker state every N frames
    # (0: only with resume, which defaults the cadence to 25)
    count_line: tuple[float, float, float, float] | None = None
    # directional line-cross counting (x1,y1,x2,y2 in source pixels);
    # needs track
    device: str | None = None  # None: the CUDA device (raises without
    # one); "cpu" runs the kernels' plain versions


@dataclasses.dataclass
class StreamStats:
    source: str
    frames: int = 0
    mean_fps: float = 0.0
    counts: dict | None = None
    line_counts: dict | None = None  # {"in": {...}, "out": {...}}
    output_video: str | None = None
    labels_file: str | None = None
    errors: int = 0  # frames skipped on processing errors
    failed: str | None = None  # stream-fatal error, if any
    stage_times: dict | None = None  # StageTimers.summary()
    dropped_births: int = 0  # births lost to track-slot overflow
    truncated_dets: int = 0  # valid dets that never reached association


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def check_media(cfg: AppConfig) -> None:
    """Fail before the first frame where this machine lacks what ``cfg``
    asks of the media layer: cv2 for ``show``, an encoder (native or
    cv2) for ``save``, a drawing backend (cv2 or the native shim)."""
    if cfg.show and not _has_cv2():
        raise RuntimeError("show=True needs OpenCV (cv2) for its window, "
                           "and cv2 is not installed")
    if cfg.save and not encoder_available() and not _has_cv2():
        raise RuntimeError(
            "save=True needs a video encoder: the native libav encoder did "
            f"not load ({encoder_error()}) and cv2 is not installed; pass "
            "save=False (--no-save)")
    make_annotator({})  # raises where neither cv2 nor the shim works


def _stream_name(source: str, used: set[str]) -> str:
    base = os.path.splitext(os.path.basename(str(source)))[0] or str(source)
    name = base
    i = 1
    while name in used:
        name = f"{base}_{i}"
        i += 1
    used.add(name)
    return name


def open_source(source):
    """-> (reader, width, height), or (None, 0, 0) with the reference's
    message where the source does not open. Files try the native decoder
    first (C decode on the reader thread), then cv2; cameras need cv2."""
    if not isinstance(source, str):  # synthetic sources
        return source, source.w, source.h
    if os.path.exists(source):
        reader = NativeVideoReader(source)
        if reader.ok:
            return reader, reader.width, reader.height
    try:
        reader = VideoReader(source)
    except ImportError:
        reader = None
    if reader is None or not reader.ok:
        print(f"Error: Could not open video file {source}.")
        return None, 0, 0
    return reader, reader.width, reader.height


def _ckpt_path(cfg: AppConfig, name: str) -> str:
    return os.path.abspath(os.path.join(cfg.output_dir, f"{name}_ckpt"))


def _ckpt_every(cfg: AppConfig) -> int:
    if cfg.checkpoint_every > 0:
        return cfg.checkpoint_every
    return 25 if cfg.resume else 0


def _try_restore(cfg: AppConfig, name: str, template: TrackState):
    """-> (one stream's TrackState, last frame_id) from the stream's
    checkpoint, or None when absent or resume is off."""
    path = _ckpt_path(cfg, name)
    if not cfg.resume or not os.path.isdir(path):
        return None
    return restore_state(path, template)


def _save_ckpt(cfg: AppConfig, name: str, track_state: TrackState,
               frame_id: int) -> None:
    save_state(_ckpt_path(cfg, name), track_state, frame_id)


class _StreamCtx:
    """One stream's host-side state: annotator, analytics, writers,
    stats — shared by the sequential and batched loops."""

    def __init__(
        self, cfg: AppConfig, source, name: str, names, width, height,
        *, start_frame: int = 0, events=None,
    ):
        self.cfg = cfg
        self.source = source
        self.name = name
        self.start_frame = start_frame
        self.events = events
        self.stats = StreamStats(source=str(source))
        self.annotator = make_annotator(names, seed=cfg.seed)
        self.trails = TrajectoryMemory()
        self.counter = StreamingCounter(names)
        self.line_counter = (
            LineCrossCounter(names, cfg.count_line)
            if cfg.count_line is not None and cfg.track
            else None
        )
        self.fps = FpsMeter()
        self.timers = StageTimers()
        self.writer = None
        self.label_writer = None
        self.stop = False  # set by 'q' in show mode
        if cfg.save:
            os.makedirs(cfg.output_dir, exist_ok=True)
            out_path = os.path.join(cfg.output_dir, f"{name}_output.mp4")
            # the native libav mp4 encoder (the reference's mp4v), cv2
            # where it does not load
            self.writer = (
                NativeVideoWriter(out_path, width, height, cfg.out_fps)
                if encoder_available()
                else None
            )
            if self.writer is None or not self.writer.ok:
                self.writer = VideoWriter(out_path, width, height, cfg.out_fps)
            self.stats.output_video = out_path
            labels_path = os.path.join(cfg.output_dir, f"{name}_labels.txt")
            self.label_writer = LabelWriter(
                labels_path, compat=cfg.compat_labels, append=start_frame > 0
            )
            self.stats.labels_file = labels_path
        if events:
            events.log(
                "stream_start", stream=name, source=str(source),
                start_frame=start_frame,
            )
        self._t0 = time.time()

    def postprocess(self, frame: np.ndarray, results, frame_id: int):
        """Analytics + draw + encode for one frame (host work)."""
        cfg = self.cfg
        with self.timers.stage("analytics"):
            if cfg.track:
                self.trails.update(results.boxes)
                if self.label_writer:
                    self.label_writer.write_frame(frame_id, results.boxes)
                if cfg.count:
                    self.counter.update(results.boxes)
                if self.line_counter is not None:
                    self.line_counter.update(results.boxes)

        with self.timers.stage("draw"):
            frame = self.annotator.draw_results(frame, results)
            if cfg.track:
                self.annotator.draw_trails(frame, self.trails)
            if cfg.track and cfg.count:
                frame = self.annotator.draw_counts(frame, self.counter.counts())
            if self.line_counter is not None:
                self.annotator.draw_count_line(
                    frame, self.cfg.count_line, self.line_counter.totals()
                )
            self.annotator.draw_fps(frame, self.fps.tick())

        with self.timers.stage("encode"):
            if self.writer:
                self.writer.write(frame)
        if cfg.show:
            import cv2

            cv2.imshow(f"yolo_{self.source}", frame)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                self.stop = True

    def finish(self, frames: int, track_state: TrackState | None = None,
               stream_idx: int = 0, group_timers: StageTimers | None = None):
        """track_state: the final state of this stream's pipeline (row
        ``stream_idx``), source of the device-side drop and truncation
        counters, read once here; ``group_timers``: the batched loop's
        per-tick stages, added to this stream's."""
        elapsed = max(time.time() - self._t0, 1e-9)
        self.stats.frames = frames
        self.stats.mean_fps = frames / elapsed
        self.stats.counts = self.counter.counts() if self.cfg.count else None
        if self.line_counter is not None:
            self.stats.line_counts = self.line_counter.counts()
        self.stats.stage_times = self.timers.summary()
        if group_timers is not None:
            self.stats.stage_times.update(group_timers.summary())
        if track_state is not None:
            db = track_state.dropped_births[stream_idx].cpu()
            td = track_state.truncated_dets[stream_idx].cpu()
            self.stats.dropped_births = int(db)
            self.stats.truncated_dets = int(td)
            if (self.stats.dropped_births or self.stats.truncated_dets):
                print(
                    f"[WARN] {self.name}: {self.stats.dropped_births} "
                    f"births dropped (track_slots), "
                    f"{self.stats.truncated_dets} detections truncated "
                    f"(tracker_max_dets) — raise the respective limit "
                    f"for crowded scenes"
                )
        if self.events:
            self.events.log(
                "stream_end", stream=self.name, frames=frames,
                mean_fps=round(self.stats.mean_fps, 2),
                errors=self.stats.errors, counts=self.stats.counts,
                line_counts=self.stats.line_counts,
                dropped_births=self.stats.dropped_births,
                truncated_dets=self.stats.truncated_dets,
            )
        if self.writer:
            self.writer.release()
        if self.label_writer:
            self.label_writer.close()
        if self.cfg.show:
            import cv2

            cv2.destroyAllWindows()
        return self.stats


def _frame_error(ctx: _StreamCtx, events, frame_id, e: Exception) -> None:
    ctx.stats.errors += 1
    if events:
        events.log("frame_error", stream=ctx.name, frame_id=int(frame_id),
                   error=str(e))
    print(f"[WARN] {ctx.source} frame {frame_id} skipped: {e}")


def process_video(
    cfg: AppConfig,
    source,
    name: str,
    pipeline: Pipeline,
    events=None,
) -> StreamStats:
    """One stream's loop: read -> dispatch -> overlay -> write, with
    one-tick overlap in track mode (frame t is dispatched before frame
    t - 1 is materialized, drawn and encoded)."""
    if cfg.count and not cfg.track:
        # the reference's behavior (yolo_multi_model.py:280-282)
        print("[INFO] count works only when objects are tracking.. so use: --track --count")
        return StreamStats(source=str(source))

    reader, width, height = open_source(source)
    if reader is None:
        return StreamStats(source=str(source))

    pipeline.reset()
    start_frame = 0
    restored = _try_restore(cfg, name, pipeline.track_state) if cfg.track else None
    if restored is not None:
        pipeline.track_state, start_frame = restored
        if events:
            events.log("resume", stream=name, frame_id=start_frame)
    ctx = _StreamCtx(
        cfg, source, name, pipeline.names, width, height,
        start_frame=start_frame, events=events,
    )
    ckpt_every = _ckpt_every(cfg) if cfg.track else 0
    frame_id = 0
    pending = None  # (frame, frame_id, handle)
    calibrated = cfg.quant != "int8"

    def flush(p):
        pframe, pid, phandle = p
        try:
            with ctx.timers.stage("infer_track"):
                results = pipeline.materialize(phandle)
        except Exception as e:
            _frame_error(ctx, events, pid, e)
        else:
            ctx.postprocess(pframe, results, pid)

    frames = iter(reader)
    try:
        while True:
            with ctx.timers.stage("decode"):
                frame = next(frames, None)
            if frame is None:
                break
            frame_id += 1
            if frame_id <= start_frame:
                continue  # already processed before the restart
            if cfg.max_frames and frame_id > cfg.max_frames:
                frame_id -= 1
                break
            if not calibrated:
                # static int8 activation scales from the first real frame
                n_cal = pipeline.calibrate_int8([frame])
                print(f"[INFO] int8: calibrated {n_cal} convs")
                calibrated = True
            try:
                if cfg.track:
                    with ctx.timers.stage("dispatch"):
                        handle = pipeline.track_async(frame)
                    if ckpt_every and frame_id % ckpt_every == 0:
                        _save_ckpt(cfg, name, pipeline.track_state, frame_id)
                        if events:
                            events.log("checkpoint", stream=name, frame_id=frame_id)
            except Exception as e:  # corrupt frame: skip, keep the stream
                _frame_error(ctx, events, frame_id, e)
                continue

            if pending is not None:
                flush(pending)
                pending = None

            if cfg.track:
                pending = (frame, frame_id, handle)
            else:
                with ctx.timers.stage("infer_track"):
                    results = pipeline(frame, track=False)
                ctx.postprocess(frame, results, frame_id)
            if ctx.stop:
                break
        if pending is not None:  # the last frame in flight
            flush(pending)
    finally:
        if hasattr(reader, "release"):
            reader.release()
        stats = ctx.finish(
            frame_id, track_state=pipeline.track_state if cfg.track else None
        )
    return stats


# ---------------------------------------------------------------------------
# Batched concurrent multi-source (one BatchedPipeline tick for all streams)
# ---------------------------------------------------------------------------


def _reader_thread(reader, q, max_frames, skip: int = 0):
    n = 0
    try:
        for frame in reader:
            n += 1
            if n <= skip:
                continue  # already processed before a restart (resume)
            if max_frames and n > max_frames:
                break
            q.put(frame)
    finally:
        q.put(None)  # EOF sentinel
        if hasattr(reader, "release"):
            reader.release()


def _run_group_batched(
    cfg: AppConfig, pipeline: Pipeline, group, events=None
) -> list[StreamStats]:
    """Lockstep loop over same-resolution streams: one BatchedPipeline
    tick per frame index, per-stream reader threads, per-stream host
    postprocessing with error isolation."""
    S = len(group)
    _, _, _, width, height = group[0]
    bp = pipeline.track_batch_prepare(S, (height, width))
    starts = []
    for s, (source, name, _, _, _) in enumerate(group):
        restored = _try_restore(cfg, name, pipeline.track_state)
        if restored is not None:
            state_s, start = restored
            for batched, one in zip(bp.states, state_s):
                batched[s:s + 1].copy_(one)
            if events:
                events.log("resume", stream=name, frame_id=start)
            starts.append(start)
        else:
            starts.append(0)
    ctxs = [
        _StreamCtx(
            cfg, source, name, pipeline.names, width, height,
            start_frame=start, events=events,
        )
        for (source, name, _, width, height), start in zip(group, starts)
    ]
    queues = [queue_mod.Queue(maxsize=4) for _ in range(S)]
    threads = [
        threading.Thread(
            target=_reader_thread,
            args=(reader, q, cfg.max_frames, start), daemon=True,
        )
        for (_, _, reader, _, _), q, start in zip(group, queues, starts)
    ]
    for t in threads:
        t.start()

    timers = StageTimers()  # per tick of the group
    ckpt_every = _ckpt_every(cfg)
    live = np.ones(S, bool)
    frame_ids = np.asarray(starts, np.int64)
    last = [np.zeros((height, width, 3), np.uint8) for _ in range(S)]
    pending = None  # (frames list, mask, ids, handle)

    def flush(p):
        frames, mask, ids, handle = p
        with timers.stage("infer_track"):
            results = bp.materialize(handle)
        for s in range(S):
            if not mask[s]:
                continue
            try:
                ctxs[s].postprocess(frames[s], results[s], int(ids[s]))
            except Exception as e:
                _frame_error(ctxs[s], events, ids[s], e)
            if ctxs[s].stop:
                live[s] = False

    tick = 0
    while live.any():
        frames = []
        mask = live.copy()
        with timers.stage("decode"):
            for s in range(S):
                if live[s]:
                    f = queues[s].get()
                    if f is None:
                        live[s] = False
                        mask[s] = False
                        f = last[s]
                    else:
                        last[s] = f
                        frame_ids[s] += 1
                else:
                    f = last[s]
                frames.append(f)
        if mask.any():
            if tick == 0 and cfg.quant == "int8":
                # static activation scales from the first real frames
                n_cal = pipeline.calibrate_int8(
                    [frames[s] for s in range(S) if mask[s]][:2])
                bp.refresh_steps()
                print(f"[INFO] int8: calibrated {n_cal} convs")
            # dispatch tick t, then materialize + draw tick t - 1 while
            # the card computes
            with timers.stage("stack"):
                stacked = np.stack(frames)
            with timers.stage("dispatch"):
                handle = bp.step_async(stacked)
            if pending is not None:
                flush(pending)
            pending = (frames, mask, frame_ids.copy(), handle)
            tick += 1
            if ckpt_every and tick % ckpt_every == 0:
                bp.sync()  # every dispatched tick done before .states is read
                for s in range(S):
                    if mask[s]:
                        _save_ckpt(
                            cfg, ctxs[s].name,
                            TrackState(*(f[s:s + 1] for f in bp.states)),
                            int(frame_ids[s]),
                        )
                if events:
                    events.log("checkpoint", tick=tick)
    if pending is not None:
        flush(pending)

    for t in threads:
        t.join(timeout=5.0)
    bp.sync()
    return [
        ctx.finish(int(n), track_state=bp.states, stream_idx=s,
                   group_timers=timers)
        for s, (ctx, n) in enumerate(zip(ctxs, frame_ids))
    ]


def make_pipeline(cfg: AppConfig) -> Pipeline:
    """The Pipeline that :func:`run` builds for ``cfg`` and shares among
    its streams: ``cfg``'s detector and tracker."""
    det_cfg = DetectorConfig(
        weights=cfg.weights,
        imgsz=cfg.imgsz,
        conf=cfg.conf,
        iou=cfg.iou,
        max_det=cfg.max_det,
        classes=cfg.classes,
        half=cfg.half,
        quant=cfg.quant,
    )
    return Pipeline(
        det_cfg, tracker=cfg.tracker, seed=cfg.seed,
        reid_weights=cfg.reid_weights,
        tracker_max_dets=cfg.tracker_max_dets,
        reid_topk=cfg.reid_topk,
        reid_cadence=cfg.reid_cadence,
        device=cfg.device,
    )


def run(cfg: AppConfig, sources=None,
        pipeline: Pipeline | None = None) -> list[StreamStats]:
    """Multi-source entry. One weight set shared by all streams (the
    reference forks a process, and loads the model, per source).

    With ``multi_mode="batched"`` (default) and tracking, same-resolution
    sources run concurrently as one BatchedPipeline; mixed resolutions
    form groups, each run batched, one after another. ``sources``
    replaces ``cfg.sources`` (paths, camera index strings, or sources
    with ``w``, ``h`` and frame iteration such as
    ``media.video.SyntheticSource``). ``pipeline``, from
    :func:`make_pipeline` of a config with the same detector and
    tracker, replaces the one ``run`` would build, so that runs share its
    weights and its warm caches."""
    check_media(cfg)
    base = pipeline if pipeline is not None else make_pipeline(cfg)
    sources = sources if sources is not None else list(cfg.sources)
    events = EventLogger(cfg.log_events) if cfg.log_events else None
    used: set[str] = set()
    named = [
        (src, _stream_name(src if isinstance(src, str) else "synthetic", used))
        for src in sources
    ]

    try:
        use_batched = (
            cfg.multi_mode == "batched" and cfg.track and len(sources) > 1
        )
        if not use_batched:
            stats = []
            for source, name in named:
                # one stream's failure must not stop the others (the
                # reference got this from its process per source)
                try:
                    stats.append(process_video(cfg, source, name, base, events))
                except Exception as e:
                    print(f"[ERROR] stream {source} failed: {e}")
                    if events:
                        events.log("stream_failed", stream=name, error=str(e))
                    stats.append(StreamStats(source=str(source), failed=str(e)))
            return stats

        # open everything, group by resolution
        stats_by_idx: dict[int, StreamStats] = {}
        groups: dict[tuple[int, int], list] = {}
        order: dict[tuple[int, int], list[int]] = {}
        for i, (source, name) in enumerate(named):
            reader, w, h = open_source(source)
            if reader is None:
                stats_by_idx[i] = StreamStats(source=str(source))
                continue
            groups.setdefault((w, h), []).append((source, name, reader, w, h))
            order.setdefault((w, h), []).append(i)

        for key, group in groups.items():
            try:
                gstats = _run_group_batched(cfg, base, group, events)
            except Exception as e:
                print(f"[ERROR] stream group {key} failed: {e}")
                if events:
                    events.log("group_failed", group=str(key), error=str(e))
                gstats = [
                    StreamStats(source=str(src), failed=str(e))
                    for src, *_ in group
                ]
            for i, st in zip(order[key], gstats):
                stats_by_idx[i] = st
        return [stats_by_idx[i] for i in range(len(named))]
    finally:
        if events:
            events.close()
