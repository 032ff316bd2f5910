"""MOT evaluation CLI: MOTA / IDF1 of a tracker on MOTChallenge-layout
sequences, one JSON line per sequence (and an OVERALL line for more
than one).

Counterpart of ``strongsort_yolo_tpu/tools/eval_mot.py``, same flags and
output, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions). Two protocols:
- ``--public``: feed the sequence's det/det.txt through the tracker step
  (detector-independent comparison, the standard MOTChallenge custom);
- default: run the full detect+track ``Pipeline`` on the frames, the
  tracker's camera-motion method as it is (BoT-SORT's default
  ``sparseOptFlow`` on the host, as the JAX tool runs it).

Usage:
    python -m strongsort_yolo_tpu_torch.tools.eval_mot SEQ_DIR [SEQ_DIR...]
        [--tracker botsort.yaml] [--weights yolov8n] [--public]
        [--strongsort-pp] [--aflink] [--out results_dir] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def public_tracker(tracker: str, device):
    """-> (step, initial state) of ``tracker`` for the public protocol:
    one stream, 128 slots, on ``device``. The protocol has no frames, so
    no appearance: StrongSORT runs motion-only (NSA KF + chi2-gated
    global assignment, no cascade), λ=0 and the cosine gate open, on
    zero features of width 512, as in the JAX tool."""
    from strongsort_yolo_tpu_torch.config import load_tracker_config
    from strongsort_yolo_tpu_torch.track.bytetrack import bytetrack_step
    from strongsort_yolo_tpu_torch.track.state import init_track_state
    from strongsort_yolo_tpu_torch.track.strongsort import (
        StrongSortConfig, strongsort_step,
    )

    tcfg = load_tracker_config(tracker)
    if isinstance(tcfg, StrongSortConfig):
        tcfg = dataclasses.replace(
            tcfg, lambda_appearance=0.0, max_cosine_distance=1.0
        )
        fd = 512

        def step(st, b, s, c, v):
            feats = torch.zeros((*b.shape[:2], fd), dtype=torch.float32,
                                device=b.device)
            return strongsort_step(st, b, s, c, v, feats, tcfg)

        return step, init_track_state(1, 128, device, feat_dim=fd)

    def step(st, b, s, c, v):
        return bytetrack_step(st, b, s, c, v, tcfg)

    return step, init_track_state(1, 128, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sequences", nargs="+", help="MOT sequence dirs")
    ap.add_argument("--tracker", default="botsort.yaml")
    ap.add_argument("--weights", default="yolov8n")
    ap.add_argument("--public", action="store_true",
                    help="use det/det.txt instead of the detector")
    ap.add_argument("--conf", type=float, default=0.1)
    ap.add_argument("--strongsort-pp", action="store_true",
                    help="offline GSI + tracklet linking pass")
    ap.add_argument("--aflink", action="store_true",
                    help="learned AFLink tracklet linker (shipped "
                    "assets/aflink_synth.npz) instead of the motion "
                    "heuristic; implies nothing without --strongsort-pp")
    ap.add_argument("--out", default=None, help="write MOT results txts")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from strongsort_yolo_tpu_torch.data.mot import (
        MotSequence, evaluate_sequence, save_mot_results,
        track_sequence_public,
    )

    device = torch.device(args.device)
    totals = []
    for seq_dir in args.sequences:
        seq = MotSequence(seq_dir)
        if args.public:
            step, state0 = public_tracker(args.tracker, device)
            hyp = track_sequence_public(
                seq, step, state0, conf_thresh=args.conf
            )
        else:
            from strongsort_yolo_tpu_torch.config import DetectorConfig
            from strongsort_yolo_tpu_torch.pipeline import Pipeline

            pipe = Pipeline(
                DetectorConfig(weights=args.weights, conf=args.conf),
                tracker=args.tracker, device=device,
            )
            hyp = []
            for frame in seq.frames():
                r = pipe.track(frame)
                hyp.append(
                    [
                        (int(r.boxes.id[i]), *r.boxes.xyxy[i])
                        for i in range(len(r.boxes))
                    ]
                )
        if args.strongsort_pp:
            from strongsort_yolo_tpu_torch.track.postprocess import strongsort_pp

            recs = [
                (f, tid, x1, y1, x2, y2)
                for f, rows in enumerate(hyp)
                for tid, x1, y1, x2, y2 in rows
            ]
            out = strongsort_pp(recs, aflink=args.aflink, device=device)
            hyp = [[] for _ in range(len(hyp))]
            for f, tid, x1, y1, x2, y2 in out:
                if 0 <= f < len(hyp):
                    hyp[f].append((tid, x1, y1, x2, y2))
        if args.out:
            save_mot_results(f"{args.out}/{seq.name}.txt", hyp)
        m = evaluate_sequence(seq, hyp)
        m["seq"] = seq.name
        totals.append(m)
        print(json.dumps(m))
    if len(totals) > 1:
        gt = sum(m["gt"] for m in totals)
        mota = 1.0 - sum(m["fp"] + m["fn"] + m["idsw"] for m in totals) / max(gt, 1)
        print(json.dumps({"seq": "OVERALL", "mota": mota,
                          "idf1_mean": float(np.mean([m["idf1"] for m in totals]))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
