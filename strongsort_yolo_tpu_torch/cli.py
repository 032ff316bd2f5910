"""Command line of the port: the reference's
``python yolo_multi_model.py --source <s>... [--track] [--count]`` with
the JAX package's extensions (``strongsort_yolo_tpu/cli.py``), plus
``--device``.

    python -m strongsort_yolo_tpu_torch.cli --source a.mp4 b.mp4 --track --count

It runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from strongsort_yolo_tpu_torch.app import AppConfig, run


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="strongsort-yolo-tpu-torch",
        description="Process video with YOLO on an NVIDIA GPU "
        "(detect/segment/pose + track + count).",
    )
    parser.add_argument(
        "--source", nargs="+", type=str, default=["0"],
        help="Input video file paths or camera indices (cameras need cv2)",
    )
    parser.add_argument("--track", action="store_true", help="if track objects")
    parser.add_argument("--count", action="store_true", help="if count objects")
    parser.add_argument(
        "--count-line", type=str, default=None, metavar="x1,y1,x2,y2",
        help="directional line-cross counting: tally per-class in/out "
        "crossings of track centroids over the directed line A->B "
        "(in = ends left of A->B); draws the line + totals; needs --track",
    )
    parser.add_argument(
        "--weights", type=str, default="yolov8n",
        help="model name (yolov8n, yolov8n-seg, yolo11n-pose, yolov5s, "
        "yolov7, ...) or an .npz / ultralytics .pt path",
    )
    parser.add_argument(
        "--tracker", type=str, default="botsort.yaml",
        help="tracker config name or YAML path (botsort.yaml, "
        "bytetrack.yaml, strongsort.yaml, botsort-reid.yaml); the GMC "
        "methods of botsort.yaml (sparseOptFlow) and strongsort.yaml (ecc) "
        "run on the host with OpenCV",
    )
    parser.add_argument(
        "--reid-weights", type=str, default=None,
        help="ReID embedder: OSNet variant name (osnet_x0_25, ...), an "
        "OSNet .npz or a torchreid .pt/.pth checkpoint path "
        "(StrongSORT / BoT-SORT ReID)",
    )
    parser.add_argument("--conf", type=float, default=0.3, help="NMS confidence threshold")
    parser.add_argument("--iou", type=float, default=0.4, help="NMS IoU threshold")
    parser.add_argument("--max-det", type=int, default=1000, help="max detections per image")
    parser.add_argument(
        "--tracker-max-dets", type=int, default=128,
        help="detections fed to association (raise for crowded scenes)",
    )
    parser.add_argument(
        "--reid-topk", type=str, default="auto",
        help="detections embedded per frame by the ReID model "
        "(StrongSORT / BoT-SORT with ReID). 'auto' (the default) embeds "
        "up to 128; the port sizes each tick's crop batch from the real "
        "detection counts of all streams, so 'auto' and an integer differ "
        "only in that cap",
    )
    parser.add_argument(
        "--reid-refresh-every", type=int, default=1,
        help="appearance refresh cadence (StrongSORT, batched "
        "multi-source): each stream's detections are embedded every Nth "
        "tick (staggered across streams); skip frames associate "
        "motion-only. 1 = every frame (exact)",
    )
    parser.add_argument(
        "--classes", nargs="+", type=int, default=None, help="class id filter"
    )
    parser.add_argument("--imgsz", type=int, default=640, help="inference size")
    parser.add_argument("--output", type=str, default="output", help="output directory")
    parser.add_argument("--show", action="store_true",
                        help="live display window (needs cv2)")
    parser.add_argument("--no-save", action="store_true", help="skip writing outputs")
    parser.add_argument(
        "--compat-labels", action="store_true",
        help="reference-exact label files (frame id 0, append across runs)",
    )
    parser.add_argument("--no-half", action="store_true", help="float32 compute")
    parser.add_argument(
        "--quant", choices=("int8",), default=None,
        help="post-training quantization of the detector conv stack "
        "(per-channel int8 weights, static activation scales calibrated "
        "on the first frame), as the JAX package's int8 mode computes it; "
        "on the H100 no faster than bf16 yet: its int8 conv kernel is a "
        "first, simple one",
    )
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument(
        "--log-events", type=str, default=None,
        help="write a JSON-lines event log (stream_start/frame_error/"
        "checkpoint/stream_end) to this path",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="restore tracker state + frame position from the stream "
        "checkpoint in the output dir and continue (keeps track ids)",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save tracker state every N frames (0 = 25 when --resume)",
    )
    parser.add_argument(
        "--multi-mode", choices=("batched", "sequential"), default="batched",
        help="multi-source execution: 'batched' runs same-resolution "
        "sources concurrently as one batch on the card; 'sequential' runs "
        "one source at a time",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device (default: the CUDA device; 'cpu' runs the "
        "kernels' plain versions)",
    )
    return parser


def _parse_line(spec: str | None):
    if spec is None:
        return None
    parts = [p for p in spec.replace(",", " ").split() if p]
    if len(parts) != 4:
        raise SystemExit(
            f"--count-line expects x1,y1,x2,y2 (got {spec!r})"
        )
    return tuple(float(p) for p in parts)


def parse_config(argv=None) -> AppConfig:
    """The command line -> the AppConfig that :func:`main` runs."""
    args = build_parser().parse_args(argv)
    return AppConfig(
        sources=tuple(args.source),
        track=args.track,
        count=args.count,
        count_line=_parse_line(args.count_line),
        weights=args.weights,
        tracker=args.tracker,
        reid_weights=args.reid_weights,
        conf=args.conf,
        iou=args.iou,
        max_det=args.max_det,
        classes=None if args.classes is None else tuple(args.classes),
        imgsz=args.imgsz,
        output_dir=args.output,
        show=args.show,
        save=not args.no_save,
        compat_labels=args.compat_labels,
        half=not args.no_half,
        quant=args.quant,
        max_frames=args.max_frames,
        multi_mode=args.multi_mode,
        log_events=args.log_events,
        resume=args.resume,
        checkpoint_every=args.checkpoint_every,
        tracker_max_dets=args.tracker_max_dets,
        reid_topk=128 if args.reid_topk == "auto" else int(args.reid_topk),
        reid_cadence=args.reid_refresh_every,
        device=args.device,
    )


def report(stats) -> None:
    """One line per stream of :func:`run`'s StreamStats: frames, frames/s,
    counts and line counts."""
    for s in stats:
        line = f"[{s.source}] frames={s.frames} fps={s.mean_fps:.2f}"
        if s.counts is not None:
            line += f" counts={s.counts}"
        if s.line_counts is not None:
            line += f" line_counts={s.line_counts}"
        print(line)


def main(argv=None) -> int:
    report(run(parse_config(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
