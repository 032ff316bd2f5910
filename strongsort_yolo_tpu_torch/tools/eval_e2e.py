"""Serve trained synth160 detectors as ``tests/test_trained_e2e.py`` serves
the shipped one, after training that detector's recipe from given seeds.

    python -m strongsort_yolo_tpu_torch.tools.eval_e2e CKPT.npz [...] \\
        [--device cuda]
    python -m strongsort_yolo_tpu_torch.tools.eval_e2e --train-seeds 0 1 2 \\
        --out DIR [--jobs 3] [--device cuda]

Each checkpoint drives a ByteTrack ``Pipeline`` at imgsz 160 over 30
``SyntheticDetSource`` frames (320 x 320, 3 objects, seed 1), and then
the class test (a class-2 rectangle found with its box within 15 px).
One line per checkpoint: MOTA, IDF1, IDsw and the class test.
``--train-seeds`` first runs ``tools/train`` with the recipe of
``assets/yolov8n_synth160.npz`` (:data:`RECIPE`) from ``init_model``
seeded with each seed (``--jobs`` trainers at once), and saves
``DIR/seed{s}.npz``. One training run is one draw of the recipe: the
served results spread with the seed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# tools/train's flags for the shipped synth160 detector
RECIPE = ("--synthetic", "--steps", "600", "--imgsz", "160", "--nc", "3",
          "--lr", "1e-3")


def e2e_pipeline(weights: str, device: str):
    """The Pipeline of tests/test_trained_e2e.py on ``device``."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline

    return Pipeline(
        DetectorConfig(weights=weights, imgsz=160, conf=0.3, iou=0.4,
                       max_det=16, half=False),
        tracker="bytetrack.yaml", track_slots=16, tracker_max_dets=16,
        device=device)


def track_clip(pipe) -> tuple[dict, list]:
    """MOT metrics of ``pipe`` on the test's 30 frames, and its (ids,
    boxes, classes) per frame."""
    from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource
    from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot

    src = SyntheticDetSource(num_frames=30, size=(320, 320), num_objects=3,
                             seed=1)
    pipe.reset()
    gt, hyp, rows = [], [], []
    for t, frame in enumerate(src):
        r = pipe.track(frame)
        gt.append([tuple(g) for g in src.truth(t)])
        hyp.append([(int(r.boxes.id[i]), *r.boxes.xyxy[i])
                    for i in range(len(r.boxes))])
        rows.append((np.asarray(r.boxes.id), np.asarray(r.boxes.xyxy),
                     np.asarray(r.boxes.cls)))
    return evaluate_mot(gt, hyp), rows


def class_test(pipe) -> tuple[bool, str]:
    """tests/test_trained_e2e.py::test_trained_model_detects_classes."""
    frame = (np.random.default_rng(0).uniform(0, 0.3, (320, 320, 3)) * 255
             ).astype(np.uint8)
    frame[80:180, 100:200] = int((0.5 + 0.16 * 2) * 255)  # class 2
    r = pipe.predict(frame)
    if len(r.boxes) < 1:
        return False, "no box"
    best = int(np.argmax(r.boxes.conf))
    x1, y1, x2, y2 = r.boxes.xyxy[best]
    ok = (int(r.boxes.cls[best]) == 2 and abs(x1 - 100) < 15
          and abs(y1 - 80) < 15 and abs(x2 - 200) < 15 and abs(y2 - 180) < 15)
    return ok, (f"class {int(r.boxes.cls[best])}, box "
                f"({x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f})")


def evaluate(weights: str, device: str) -> dict:
    """-> {"mota", "idf1", "idsw", "class_test", "class_msg", "classes"}
    of the checkpoint ``weights`` served on ``device`` (float32 without
    TF32)."""
    from strongsort_yolo_tpu_torch.track.aflink import no_tf32

    with no_tf32():
        pipe = e2e_pipeline(weights, device)
        m, rows = track_clip(pipe)
        ok, msg = class_test(pipe)
    return {"mota": float(m["mota"]), "idf1": float(m["idf1"]),
            "idsw": int(m["idsw"]), "class_test": ok, "class_msg": msg,
            "classes": sorted({int(c) for _, _, cls in rows for c in cls})}


def train_recipe(seed: int, path: str, device: str) -> dict:
    """``tools/train`` with :data:`RECIPE` from ``init_model`` seeded with
    ``seed``, saved to ``path`` -> its result dict."""
    from strongsort_yolo_tpu_torch.tools import train

    return train.main([*RECIPE, "--seed", str(seed), "--save", path,
                       "--device", device, "--log-every", "100"])


def train_seeds(seeds, out: str, device: str, jobs: int = 1) -> list[dict]:
    """:func:`train_recipe` from each seed into ``out/seed{s}.npz``, in
    ``jobs`` processes at once (each trainer is bound by its own host
    thread, so several share one card) -> their result dicts in order."""
    os.makedirs(out, exist_ok=True)
    argv = [(s, os.path.join(out, f"seed{s}.npz"), device) for s in seeds]
    if jobs <= 1:
        return [train_recipe(*a) for a in argv]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(jobs, multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(train_recipe, *zip(*argv)))


def main(argv=None) -> list[dict]:
    """-> one :func:`evaluate` dict per checkpoint, with its "weights"."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoints", nargs="*")
    ap.add_argument("--train-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--jobs", type=int, default=1,
                    help="trainers run at once")
    ap.add_argument("--out", default="build",
                    help="directory of the trained checkpoints")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    train_seeds(args.train_seeds, args.out, args.device, args.jobs)
    paths = [*args.checkpoints, *(os.path.join(args.out, f"seed{s}.npz")
                                  for s in args.train_seeds)]
    results = []
    for path in paths:
        res = {"weights": path, **evaluate(path, args.device)}
        print(f"{path}: MOTA {res['mota']:.4f} IDF1 {res['idf1']:.4f} IDsw "
              f"{res['idsw']}, class test {res['class_test']} "
              f"({res['class_msg']})", flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
