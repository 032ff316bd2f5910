"""Sequence-level StrongSORT quality rows (BASELINE.md).

Counterpart of ``strongsort_yolo_tpu/tools/eval_sequence.py``: runs the
fully-trained pipeline — trained detector
(assets/yolov8n_synth160.npz) + trained OSNet ReID
(assets/osnet_x0_25_synth.npz) + StrongSORT — over the long
occlusion-relay benchmark clip (media/video.OcclusionRelayClip: every
bounce period is an engineered identity-swap opportunity where
motion-only association provably prefers the wrong pairing), and
reports MOTA / IDF1 / IDsw for:

  - strongsort                (λ=0.98 appearance blend, paper default)
  - strongsort λ=0            (appearance term removed, same gating)
  - each of the above + StrongSORT++ offline pass (learned AFLink
    linking + GSI smoothing, track/postprocess.strongsort_pp)

Usage:
  python -m strongsort_yolo_tpu_torch.tools.eval_sequence
      [--cycles 2] [--pan 0] [--gmc none|flow_tpu] [--json]
      [--device cuda]

--pan N adds a global camera pan of amplitude N px (exercises GMC on
real frames; use with --gmc flow_tpu for the device estimator).
--device cpu runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os

ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
DET_CKPT = os.path.join(ASSETS, "yolov8n_synth160.npz")
REID_CKPT = os.path.join(ASSETS, "osnet_x0_25_synth.npz")


def arm_pipeline(*, lam: float, gmc: str = "none", reid_ckpt=REID_CKPT,
                 cadence: int = 0, device="cuda"):
    """The Pipeline of one arm: the trained synth160 detector in float32
    (``half=False``, as in the JAX tool) and StrongSORT with appearance
    weight ``lam`` (λ=0 opens the cosine gate)."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    extra = {} if lam > 0 else dict(max_cosine_distance=1.0)
    tracker = StrongSortConfig(
        gmc_method=gmc, max_age=60, lambda_appearance=lam, **extra
    )
    return Pipeline(
        DetectorConfig(weights=DET_CKPT, imgsz=160, conf=0.3, iou=0.4,
                       max_det=16, half=False),
        tracker=tracker, track_slots=16, tracker_max_dets=16,
        reid_weights=reid_ckpt, reid_cadence=max(cadence, 1),
        device=device,
    )


def run_arm(clip, *, lam: float, gmc: str = "none", reid_ckpt=REID_CKPT,
            cadence: int = 0, device="cuda"):
    """-> (metrics dict, records list, (gt_frames, hyp_frames)).

    cadence: 0 = single-stream ``pipe.track`` path (the classic rows);
    >= 1 = the batched serving path (S=1 BatchedPipeline,
    auto_topk) with that appearance-refresh cadence — the quality
    harness for ``reid_cadence`` (1 is the exact control)."""
    from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot

    pipe = arm_pipeline(lam=lam, gmc=gmc, reid_ckpt=reid_ckpt,
                        cadence=cadence, device=device)
    bp = None
    if cadence >= 1:
        bp = pipe.track_batch_prepare(1, (clip.h, clip.w), auto_topk=True)
    gt_vis, gt_occ, hyp_frames, records = [], [], [], []
    for t, frame in enumerate(clip):
        r = bp.step(frame[None])[0] if bp is not None else pipe.track(frame)
        # two GT protocols from one run: visible-only (CLEAR-style
        # filtered GT) and MOT17-style annotated-through-occlusion
        gt_vis.append([tuple(g) for g in clip.truth(t)])
        gt_occ.append([tuple(g) for g in clip.truth(t, include_hidden=True)])
        hyp = [(int(r.boxes.id[i]), *(float(v) for v in r.boxes.xyxy[i]))
               for i in range(len(r.boxes))]
        hyp_frames.append(hyp)
        records.extend((t, tid, x1, y1, x2, y2) for tid, x1, y1, x2, y2 in hyp)
    return (
        {"vis": evaluate_mot(gt_vis, hyp_frames),
         "occ": evaluate_mot(gt_occ, hyp_frames)},
        records,
        (gt_vis, gt_occ, hyp_frames),
    )


def eval_pp(records, gts, device="cuda"):
    """StrongSORT++ offline pass on the records (the AFLink forward on
    ``device``) -> metrics per protocol."""
    from strongsort_yolo_tpu_torch.track.postprocess import strongsort_pp
    from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot

    gt_vis, gt_occ = gts
    linked = strongsort_pp(records, aflink=True, device=device)
    hyp_frames = [[] for _ in gt_vis]
    for frame, tid, x1, y1, x2, y2, *rest in linked:
        if 0 <= frame < len(hyp_frames):
            hyp_frames[frame].append((tid, x1, y1, x2, y2))
    return {"vis": evaluate_mot(gt_vis, hyp_frames),
            "occ": evaluate_mot(gt_occ, hyp_frames)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--pan", type=float, default=0.0)
    ap.add_argument("--gmc", default="none")
    ap.add_argument("--lk-iters", default=None, metavar="a,b,c",
                    help="override track/gmc_flow._ITERS_BY_LEVEL, the "
                    "Gauss-Newton steps per level, finest first (the "
                    "shipped '2,5,8')")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--cadence", type=int, nargs="+", default=None,
                    metavar="K",
                    help="ALSO run reid_cadence arms through the "
                    "batched serving path (S=1, auto_topk); pass 1 as "
                    "the exact control, e.g. --cadence 1 2 4")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.lk_iters:
        from strongsort_yolo_tpu_torch.track import gmc_flow

        gmc_flow._ITERS_BY_LEVEL = tuple(
            int(v) for v in args.lk_iters.split(",")
        )

    from strongsort_yolo_tpu_torch.media.video import OcclusionRelayClip

    def fresh_clip():
        return OcclusionRelayClip(cycles=args.cycles, pan_amp=args.pan)

    rows = {}
    for name, lam in [("strongsort", 0.98), ("strongsort_lambda0", 0.0)]:
        clip = fresh_clip()
        m, records, (gt_vis, gt_occ, _hyp) = run_arm(
            clip, lam=lam, gmc=args.gmc, device=args.device
        )
        rows[name] = m
        rows[name + "_pp_aflink_gsi"] = eval_pp(records, (gt_vis, gt_occ),
                                                device=args.device)
    for k in args.cadence or []:
        clip = fresh_clip()
        m, _records, _g = run_arm(clip, lam=0.98, gmc=args.gmc, cadence=k,
                                  device=args.device)
        rows[f"strongsort_cadence{k}"] = m

    if args.json:
        print(json.dumps({
            k: {p: {kk: round(float(vv), 4) for kk, vv in m.items()}
                for p, m in v.items()}
            for k, v in rows.items()
        }))
    else:
        clip = fresh_clip()
        print(f"OcclusionRelayClip cycles={args.cycles} "
              f"frames={clip.num_frames} pan={args.pan} gmc={args.gmc}")
        print(f"{'config':30s} {'proto':>5s} {'MOTA':>7s} {'IDF1':>7s} "
              f"{'IDsw':>5s} {'FP':>4s} {'FN':>4s}")
        for k, v in rows.items():
            for p, m in v.items():
                print(f"{k:30s} {p:>5s} {m['mota']:7.3f} {m['idf1']:7.3f} "
                      f"{m['idsw']:5d} {m['fp']:4d} {m['fn']:4d}")
    return rows


if __name__ == "__main__":
    main()
