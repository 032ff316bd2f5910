"""The comparison that decides ``correct``.

For a sample of the window's ticks (drawn from the seed) and the run's
first tick, the reference recomputes, stage by stage, what the program
produced from the same frames, at the precision the configuration
states (the detector and OSNet in bfloat16, the rest in float32). A
random network is chaotic under rounding: a score a hair across the
threshold, or an IoU across the NMS threshold, changes which boxes
survive and so every later choice. So each stage is held against the
reference on the program's own inputs to it (its state, its candidates,
its anchors, its boxes):

- the detector (K1 letterbox, the model, the decode): the reference's
  score at each of the program's detections' anchors and classes
  (``det_score``, the worst gap), the share of detections whose
  score or box is far from the reference's (``det_far``), and its
  recall: the share of the reference's candidates well above the
  threshold that are missing from the program's (``det_missed``),
  which a raised threshold, a lost row or a class left out of the
  decode moves;
- NMS (K2): the reference's greedy keep mask of the program's own
  ranked candidates against the program's, and the program's detection
  rows against its kept candidates (``nms_mismatch``);
- ReID (K4 crops, K6 OSNet stages): the reference's crops and
  embeddings of the program's detection boxes against the program's:
  the median of 1 - cosine (``reid_cos_p50``) over the median that the
  stated precision's rounding alone makes, the reference at that
  precision against itself one precision up (``reid_gap_ratio``): a
  seed whose random OSNet is ill-conditioned reads ten times the
  others' ``reid_cos_p50``, and its own rounding moves it about as far;
- camera motion (K5): the reference's warps from the previous and the
  current frames against the program's (``gmc_px``, at the frame's
  corners);
- the tracker (K3 assignments, Kalman): the reference's plain tracker
  (``reference/tracker.py``: a list of tracks a stream) stepped on the
  program's detections, embeddings and warps, from the program's state
  before the tick (at the run's first tick, from no tracks), against
  the program's drawn rows (``trk_mismatch``) and its live tracks
  after the tick (``state_mismatch``), track by track by id.

Each number is the worst, or the share or median, over the sampled
ticks; ``det_box_px_p50`` and ``reid_cos`` are read and not compared
(PERF.md gives why). With ``control`` the reference one
precision below (int8 round trips in the detector and OSNet, bfloat16
candidate boxes in NMS, bfloat16 in the LK, the tracker's state and
inputs and results rounded to bfloat16) takes the program's place on
the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from harness import scenes
from reference import detect as ref_detect
from reference import lk
from reference.crops import crops, pyramid
from reference.nn import Opts
from reference import tracker

DT = np.float32  # the tracker's precision, as the configurations state it
TRACK_PX = 1.0  # a track row or slot agrees when its box is within this
# a detection is far from the reference's at its anchor when its score
# differs by more than FAR_SCORE or a box side by more than FAR_PX
FAR_SCORE, FAR_PX = 0.1, 16.0
# the recall's candidates: a score this far above the threshold, within a
# frame's top MISS_RANK anchors (the program keeps its top 512)
MISS_MARGIN, MISS_RANK = 0.02, 500


class Worst:
    """Running worst of each number, and the shares' sums."""

    def __init__(self):
        self.max: dict[str, float] = {}
        self.share: dict[str, list[float]] = {}
        self.values: dict[str, list] = {}

    def top(self, name: str, v: float) -> None:
        self.max[name] = max(self.max.get(name, 0.0), float(v))

    def spread(self, name: str, values) -> None:
        """Collect values whose median is a number."""
        self.values.setdefault(name, []).append(np.asarray(values, np.float64).ravel())

    def count(self, name: str, bad: float, total: float) -> None:
        s = self.share.setdefault(name, [0.0, 0.0])
        s[0] += bad
        s[1] += total

    def numbers(self) -> dict[str, float]:
        out = dict(self.max)
        for name, (bad, total) in self.share.items():
            out[name] = bad / max(total, 1.0)
        for name, parts in self.values.items():
            v = np.concatenate(parts)
            if len(v):
                out[name + "_p50"] = float(np.median(v))
        return out


def _host(t):
    return t.detach().float().cpu().numpy()


class Reference:
    """The reference models of a configuration and their weights."""

    def __init__(self, cfg: dict, det_model, P_det, reid_model, P_reid):
        self.cfg = cfg
        self.det_model, self.P_det = det_model, P_det
        self.reid_model, self.P_reid = reid_model, P_reid
        t = dict(cfg["tracker"])
        kind = t.pop("tracker_type")
        if kind == "strongsort":
            self.tracker_cfg = tracker.StrongSortConfig(**t)
            self.step = tracker.strongsort_step
        else:
            if t.get("with_reid"):
                raise NotImplementedError("the reference's BoT-SORT has no ReID")
            self.tracker_cfg = tracker.ByteTrackConfig(tracker_type=kind, **t)
            self.step = tracker.bytetrack_step
        self.flow = t.get("gmc_method") == "flow_tpu"
        # the detector and the ReID net run at the precision the
        # configuration states; the control one step below it
        self.dtype = getattr(torch, cfg["detector"]["dtype"])
        # the precision above it, against which the rounding of the stated
        # one is read
        self.wide = torch.float64 if self.dtype == torch.float32 else torch.float32

    def per_anchor(self, frames: torch.Tensor, int8: bool):
        """The detector over all the tick's frames in one batch, as the
        program runs it."""
        return ref_detect.per_anchor(self.det_model, self.P_det, frames,
                                     self.cfg["detector"],
                                     Opts(int8=int8, dtype=self.dtype))

    def embeddings(self, frames, frame_of, boxes, int8: bool, dtype=None):
        dtype = dtype or self.dtype
        levels = pyramid(frames, dtype)
        out = []
        for i in range(0, len(boxes), 512):
            c = crops(levels, frames.shape[1:3], frame_of[i:i + 512],
                      boxes[i:i + 512])
            out.append(self.reid_model(self.P_reid, c, Opts(int8=int8, dtype=dtype)))
        return torch.cat(out) if out else boxes.new_zeros((0, self.reid_model.feat_dim))


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / torch.clamp(a.norm(dim=-1) * b.norm(dim=-1), min=1e-30)


def ref_candidates(best: torch.Tensor, conf: float) -> torch.Tensor:
    """(S, A) bool: anchors whose best score clears ``conf`` by
    ``MISS_MARGIN`` and ranks within the frame's top ``MISS_RANK``: ones
    no rounding of a sound program can drop from its candidates."""
    k = min(MISS_RANK, best.shape[1])
    kth = torch.topk(best, k, dim=1).values[:, -1:]
    return (best >= conf + MISS_MARGIN) & (best >= kth)


def _bf16(x):
    """An array rounded to bfloat16, as float64 (the control's tracker
    then works in float64 on bfloat16 values)."""
    if x is None:
        return None
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


def streams(state, lower: bool) -> list:
    """The program's slot state as the reference's plain streams: the
    live slots, in slot order, as tracks (``lower``: the floats rounded
    to bfloat16, the control's state)."""
    r = _bf16 if lower else (lambda x: x)
    h = {name: _host(getattr(state, name)) if name in ("mean", "cov", "score", "feat")
         else getattr(state, name).cpu().numpy()
         for name in ("mean", "cov", "track_id", "status", "activated", "score", "cls",
                      "feat", "end_frame", "hits", "next_id", "frame_id")}
    out = []
    for f in range(len(h["next_id"])):
        tracks = [tracker.Track(int(h["track_id"][f, i]), int(h["status"][f, i]),
                                bool(h["activated"][f, i]),
                                r(h["mean"][f, i].astype(DT)),
                                r(h["cov"][f, i].astype(DT)),
                                float(h["score"][f, i]), int(h["cls"][f, i]),
                                r(h["feat"][f, i].astype(DT)),
                                int(h["end_frame"][f, i]), int(h["hits"][f, i]))
                  for i in np.flatnonzero(h["status"][f] != 0)]
        out.append(tracker.Stream(tracks, int(h["next_id"][f]), int(h["frame_id"][f])))
    return out


def state_of(state, f: int) -> dict:
    """{track id: (status, activated, centre)} of stream f's live slots."""
    status = state.status[f].cpu().numpy()
    live = np.flatnonzero(status != 0)
    ids = state.track_id[f].cpu().numpy()[live]
    act = state.activated[f].cpu().numpy()[live]
    xy = _host(state.mean[f, :, :2])[live].astype(DT)
    return {int(i): (int(s), bool(a), c) for i, s, a, c in zip(ids, status[live], act, xy)}


def run_tracker(ref, cap, k: int, s: int, inputs, lower: bool):
    """The reference's tracker step of every stream -> ([{id: drawn
    box}], [{id: (status, activated, centre)}]); ``lower``: the control,
    its state and inputs rounded to bfloat16, and its results."""
    r = _bf16 if lower else (lambda x: x)
    pre = ([tracker.Stream([]) for _ in range(s)] if k == 0
           else streams(cap["pre"], lower))
    boxes, scores, classes, valid, feats, warps = inputs
    boxes, scores, feats, warps = r(boxes), r(scores), r(feats), r(warps)
    rows, states = [], []
    for f, st in enumerate(pre):
        drawn = ref.step(st, boxes[f], scores[f], classes[f], valid[f] > 0.5,
                         None if feats is None else feats[f], ref.tracker_cfg,
                         ref.cfg["track_slots"], warp=None if warps is None else warps[f])
        rows.append({i: r(b) for i, b in drawn})
        states.append({t.id: (t.status, t.activated, r(t.mean[:2])) for t in st.tracks})
    return rows, states


def _round_bf16(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).float()
    return x


def compare(ref: Reference, caps: dict, ticks_host, ring: int, device,
            control: bool = False) -> dict[str, float]:
    """-> {number: worst value} over the captured ticks ``caps`` (tick
    -> capture; see ``loop.drive``)."""
    cfg = ref.cfg
    t_max = cfg["tracker_max_dets"]
    topk = min((cfg.get("reid") or {}).get("topk", t_max), t_max)
    w = Worst()
    with torch.no_grad():
        for k, cap in sorted(caps.items()):
            frames = torch.from_numpy(ticks_host[scenes.order(k, ring)]).to(device)
            s = frames.shape[0]
            det = cap["det"]
            valid = det.valid
            # the detector at the program's anchors: boxes and scores
            want_b, want_s = ref.per_anchor(frames, int8=False)
            if control:
                got_b, got_s = ref.per_anchor(frames, int8=True)
            idx = det.index.long()
            cls = det.classes.long()
            rb = torch.gather(want_b, 1, idx[..., None].expand(-1, -1, 4))
            rs = torch.gather(want_s, 1, idx[..., None].expand(-1, -1, want_s.shape[-1]))
            rs = torch.gather(rs, 2, cls[..., None])[..., 0]
            if control:
                pb = torch.gather(got_b, 1, idx[..., None].expand(-1, -1, 4))
                ps = torch.gather(got_s, 1, idx[..., None].expand(-1, -1, got_s.shape[-1]))
                ps = torch.gather(ps, 2, cls[..., None])[..., 0]
            else:
                pb, ps = det.boxes, det.scores
            if valid.any():
                box_gap = (pb - rb).abs().amax(-1)[valid]
                score_gap = (ps - rs).abs()[valid]
                w.top("det_score", float(score_gap.max()))
                far = (score_gap > FAR_SCORE) | (box_gap > FAR_PX)
                w.count("det_far", float(far.sum()), float(far.numel()))
                w.spread("det_box_px", box_gap.cpu().numpy())
            # recall: the reference's candidates well above the threshold
            # (within its top MISS_RANK) that are not among the program's
            shifted, conf, keep, iou_t, conf_t = cap["nms"]
            best = want_s.float().amax(-1)
            clear = ref_candidates(best, cfg["detector"]["conf"])
            if control:
                got_best = got_s.float().amax(-1)
                found = got_best >= conf_t
            else:
                ids, ok = cap["anchors"]
                a = best.shape[1]  # a column past the anchors takes the rest
                found = torch.zeros((best.shape[0], a + 1), dtype=torch.bool,
                                    device=best.device)
                found.scatter_(1, torch.where(ok, ids.long(), a), True)
                found = found[:, :a]
            w.count("det_missed", float((clear & ~found).sum()), float(clear.sum()))
            # NMS on the program's own candidates, and its rows against the kept ones
            want_k = ref_detect.keep_mask(shifted.float(), conf.float(), iou_t, conf_t)
            got_k = (ref_detect.keep_mask(_round_bf16(shifted.to(torch.bfloat16)),
                                          conf.float(), iou_t, conf_t)
                     if control else keep)
            rows_gap = 0.0 if control else float(
                (keep.sum(-1) - valid.sum(-1)).abs().sum())
            w.count("nms_mismatch", float((want_k != got_k).sum()) + rows_gap,
                    float((conf >= conf_t).sum()))
            # embeddings of the program's boxes
            rows = det.boxes[:, :t_max]
            feats = cap.get("feats")
            if ref.reid_model is not None and feats is not None:
                real = valid[:, :topk]
                frame_of, row = torch.nonzero(real, as_tuple=True)
                boxes = rows[frame_of, row]
                want = ref.embeddings(frames, frame_of, boxes, int8=False)
                got = (ref.embeddings(frames, frame_of, boxes, int8=True)
                       if control else feats[frame_of, row])
                if len(boxes):
                    wide = ref.embeddings(frames, frame_of, boxes, int8=False, dtype=ref.wide)
                    gap = 1 - cosine(want, got)
                    w.top("reid_cos", float(gap.max()))
                    w.spread("reid_cos", gap.cpu().numpy())
                    w.spread("reid_round", (1 - cosine(want, wide)).cpu().numpy())
            # camera motion
            warps = cap.get("warps")
            if ref.flow and warps is not None and k > 0:
                prev = torch.from_numpy(
                    ticks_host[scenes.order(k - 1, ring)]).to(device)
                want = lk.warps(prev, frames)
                got = (lk.warps(prev, frames, torch.bfloat16) if control
                       else warps.float())
                h, wd = frames.shape[1:3]
                corners = torch.tensor([[0, 0, 1], [wd, 0, 1], [0, h, 1], [wd, h, 1]],
                                       dtype=torch.float32, device=device)
                gap = (corners @ want.transpose(1, 2) - corners @ got.transpose(1, 2))
                w.top("gmc_px", float(gap.abs().max()))
            # the tracker step, from the program's state before the tick
            # (the first tick: from no tracks), compared track by track by id
            inputs = [_host(x[:, :t_max]).astype(DT)
                      for x in (rows, det.scores, det.classes, valid)]
            inputs.append(None if feats is None else _host(feats).astype(DT))
            inputs.append(_host(warps).astype(DT)
                          if cfg["tracker"].get("gmc_method", "none") != "none" else None)
            want = run_tracker(ref, cap, k, s, inputs, lower=False)
            if control:
                got = run_tracker(ref, cap, k, s, inputs, lower=True)
            else:
                got = ([{int(i): np.asarray(b, np.float64)
                         for i, b in zip(r.boxes.id, r.boxes.xyxy)} for r in cap["results"]],
                       [state_of(cap["post"], f) for f in range(s)])
            for f in range(s):
                (rr, rs), (gr, gs) = (want[0][f], want[1][f]), (got[0][f], got[1][f])
                agree = sum(1 for i in rr.keys() & gr.keys()
                            if np.abs(rr[i] - gr[i]).max() <= TRACK_PX)
                w.count("trk_mismatch", len(rr) + len(gr) - 2 * agree,
                        len(rr) + len(gr) - agree)
                same = sum(1 for i in rs.keys() & gs.keys()
                           if rs[i][:2] == gs[i][:2]
                           and np.abs(rs[i][2] - gs[i][2]).max() <= TRACK_PX)
                live = len(rs.keys() | gs.keys())
                w.count("state_mismatch", live - same, live)
    out = w.numbers()
    if "reid_cos_p50" in out:  # the median gap in units of the stated precision's rounding
        out["reid_gap_ratio"] = out["reid_cos_p50"] / max(out["reid_round_p50"], 1e-30)
    return out
