"""Rank functions that tests/test_torch_parallel.py runs through the port's
``parallel/ranks.launch``. Each rank imports the port only (no JAX), so
this module holds them apart from the test file."""

import torch
import torch.distributed as dist

from strongsort_yolo_tpu_torch.models import porting
from strongsort_yolo_tpu_torch.train import trainer


def step_from_checkpoint(mesh, ckpt, imgsz, lr, images, targets):
    """One train step over ``mesh`` from the ``ckpt`` .npz on the global
    batch -> this rank's metrics, and on rank 0 the whole updated
    state_dict (numpy)."""
    tree, cfg, _ = porting.load_npz_checkpoint(ckpt)
    model = porting.model_from_state_dict(porting.params_from_jax(tree, cfg), cfg)
    tx = trainer.make_optimizer(lr)
    state = trainer.train_state(model, tx, mesh)
    step = trainer.make_train_step(cfg, imgsz, tx)
    state, metrics = step(state, *trainer.shard_batch(mesh, images, targets))
    whole = state.ranks.state_dict(state.model)
    grads = state.ranks.grads(state.model)  # as clipped by the step
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "shapes": {k: tuple(v.shape) for k, v in state.model.state_dict().items()},
        "state": ({k: v.numpy() for k, v in whole.items()}
                  if dist.get_rank() == 0 else None),
        "grads": ({k: v.numpy() for k, v in grads.items()}
                  if dist.get_rank() == 0 else None),
        "threads": torch.get_num_threads(),
    }


def fail_on_rank(mesh, rank):
    """Raise on ``rank``; the others wait in a collective that it never
    joins."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    dist.barrier()
