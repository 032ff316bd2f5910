"""Synchronizing ops per tick of ``BatchedPipeline.step`` on one card.

    python strongsort_yolo_tpu_torch/tools/sync_count.py [CHECKOUT]

Runs paths a (BoT-SORT, gmc none), b-fused (StrongSORT + fused
OSNet-x0_25), c (BoT-SORT flow_tpu on a panned scene) and e (yolov8n-seg)
of ``chip_smoke.py`` at S=8 1080p, two ticks to warm up, then three
ticks under ``torch.cuda.set_sync_debug_mode("warn")``, and prints per
path the synchronizing ops per tick (a ``.cpu()``, ``.item()``, a copy
from pageable memory, ...) and their call sites in the checkout. Host
waits on CUDA events are not such ops. CHECKOUT (default: the checkout
holding this file) is the root of any checkout of the repo, an older one
too: its own ``chip_smoke.py`` and package are imported, so run it as a
file, once per checkout, never with ``-m``.
"""

import collections
import os
import sys
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))


def count_syncs(run, root: str) -> collections.Counter:
    """Call ``run()`` under ``torch.cuda.set_sync_debug_mode("warn")`` ->
    how often each call site under ``root`` (its innermost three frames
    there) issued a synchronizing op."""
    import torch

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if f.filename.startswith(root)
                 and os.path.basename(f.filename) not in (
                     "chip_smoke.py", "sync_count.py")]
        sites[" <- ".join(f"{os.path.relpath(f.filename, root)}:{f.lineno} "
                          f"{f.name}" for f in reversed(stack[-3:]))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def main(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    if not torch.cuda.is_available():
        sys.exit("sync_count: no CUDA device")

    print(f"{cs.card_line()}; torch {torch.__version__}; checkout {root}",
          flush=True)
    h, w, ticks_n = 1080, 1920, 5
    botsort = ByteTrackConfig(tracker_type="botsort", gmc_method="none")
    scene = cs.panned_scene(h, w)
    for label, tracker, kw, pool in (
            ("a", botsort, {}, cs.make_frames(h, w)),
            ("b-fused", StrongSortConfig(gmc_method="none"), dict(fused=True),
             cs.make_frames(h, w, seed=1)),
            ("c", ByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu"),
             {}, [scene]),
            ("e", botsort, dict(model="yolov8n-seg"),
             cs.make_frames(h, w, seed=2))):
        pipe = cs._main_pipeline(tracker, pool, **kw)
        if label == "c":
            ticks = [np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                               for dx, dy in cs.PANS]) for t in range(ticks_n)]
        else:
            ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(8)])
                     for t in range(ticks_n)]
        bp = BatchedPipeline(pipe, 8, (h, w))
        for t in range(2):
            bp.step(ticks[t])
        sites = count_syncs(lambda: [bp.step(f) for f in ticks[2:]], root)
        n = ticks_n - 2
        print(f"path {label}: {sum(sites.values()) / n:.1f} synchronizing ops "
              f"per tick at {len(sites)} sites", flush=True)
        for site, count in sites.most_common():
            print(f"   {count / n:.1f}/tick {site}", flush=True)
        del bp, pipe
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                         else os.path.join(HERE, "..", "..")))
