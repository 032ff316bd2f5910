"""The JAX trainer's spread over its initial draw, the reference of the
bar that ``chip_smoke.py`` phase 7b holds the port's trainer to.

For each PRNG key, the loop of ``strongsort_yolo_tpu.tools.train`` (which
itself starts from key 0) with the recipe of
``assets/yolov8n_synth160.npz`` (``--synthetic --steps 600 --imgsz 160
--nc 3 --lr 1e-3``), its result saved as ``DIR/key{k}.npz`` and served
through the port's ``tools/eval_e2e`` on the CPU: one line per key with
MOTA, IDF1, IDsw and the class test. A script, not a test (ten keys take
tens of minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/jax_trainer_spread.py --keys 0 1 2 \\
        --out build/jax_keys
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--keys", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--out", default=os.path.join("build", "jax_keys"))
    args = ap.parse_args(argv)

    import jax

    from strongsort_yolo_tpu.models.porting import save_npz_checkpoint
    from strongsort_yolo_tpu.models.yolo import build_model
    from strongsort_yolo_tpu.tools.train import synthetic_batch
    from strongsort_yolo_tpu.train.trainer import (
        init_train_state, make_optimizer, make_train_step,
    )
    from strongsort_yolo_tpu_torch.tools.eval_e2e import evaluate

    cfg = dataclasses.replace(build_model("yolov8n"), nc=3)
    os.makedirs(args.out, exist_ok=True)
    for k in args.keys:
        tx = make_optimizer(1e-3)
        state = init_train_state(jax.random.PRNGKey(k), cfg, tx)
        step = make_train_step(cfg, 160, tx)
        rng = np.random.default_rng(0)
        for _ in range(600):
            state, m = step(state, *synthetic_batch(rng, 8, 160))
        path = os.path.join(args.out, f"key{k}.npz")
        save_npz_checkpoint(path, jax.device_get(state.params), cfg)
        r = evaluate(path, "cpu")
        print(f"key {k}: last loss {float(m['loss']):.4f}, MOTA "
              f"{r['mota']:.4f} IDF1 {r['idf1']:.4f} IDsw {r['idsw']}, class "
              f"test {r['class_test']} ({r['class_msg']})", flush=True)


if __name__ == "__main__":
    main()
