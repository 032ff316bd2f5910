"""The train step: the detection loss's gradient, the global-norm clip and
AdamW, on one device.

Counterpart of ``strongsort_yolo_tpu/train/trainer.py`` without its mesh
(one card: ``--dp``/``--tp`` and ``shard_batch`` raise, ROADMAP A14b).
The JAX step differentiates every leaf of the parameter tree, the BN
statistics ``bn_mean`` and ``bn_var`` among them, and optax's ``adamw``
updates and decays every leaf. The port keeps those statistics as
buffers, so :func:`trained_tensors` hands them to the optimizer beside
the parameters; leaving them out moves the weights away from the JAX
step's after the first update.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from strongsort_yolo_tpu_torch.models.yolo import (
    YoloConfig, YoloModel, feat_hw, init_model, model_apply,
)
from strongsort_yolo_tpu_torch.ops.decode import make_anchors
from strongsort_yolo_tpu_torch.track.aflink import no_tf32
from strongsort_yolo_tpu_torch.train.loss import LossWeights, detection_loss
from strongsort_yolo_tpu_torch.utils.transfer import to_device

BN_STATS = ("bn_mean", "bn_var")


@contextlib.contextmanager
def exact_step():
    """float32 convolutions and matmuls without TF32, and cuDNN's
    deterministic algorithms (its default backward of a conv may add in
    any order): a step that repeats bit for bit from run to run, as the
    JAX step does."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with no_tf32():
            yield
    finally:
        cudnn.deterministic = saved


def trained_tensors(model: torch.nn.Module) -> list[torch.Tensor]:
    """The tensors the JAX trainer differentiates and updates: every
    parameter, and every BN statistic (a buffer here), set to require a
    gradient."""
    stats = [b for name, b in model.named_buffers()
             if name.rsplit(".", 1)[-1] in BN_STATS]
    for t in stats:
        t.requires_grad_(True)
    return list(model.parameters()) + stats


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(lr,
    weight_decay=...))``: where the global norm of the gradients is not
    below ``max_norm`` every gradient is scaled by ``max_norm / norm``
    (``clip_grad_norm_`` would add 1e-6 to the norm), then AdamW (β 0.9 /
    0.999, ε 1e-8) decays every tensor it is given. ``lr`` is a float or
    a schedule of the update count, which starts at 0."""

    lr: float | Callable[[int], float]
    weight_decay: float = 5e-4
    max_norm: float = 10.0

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, tensors: list[torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(tensors, lr=self.lr_at(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, count: int) -> None:
        """Clip the gradients held by ``opt``'s tensors, then take update
        ``count`` at the schedule's rate for it (no host sync)."""
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group in opt.param_groups:
            group["lr"] = self.lr_at(count)
        opt.step()


def make_optimizer(lr: float | Callable[[int], float] = 1e-3,
                   weight_decay: float = 5e-4) -> Optimizer:
    return Optimizer(lr, weight_decay)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1.0 + np.cos(np.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule


class TrainState(NamedTuple):
    model: YoloModel
    opt: torch.optim.AdamW
    step: int


def train_state(model: YoloModel, tx: Optimizer) -> TrainState:
    """A state that trains ``model`` (unfused) from its current weights."""
    if model.fused:
        raise ValueError("training takes the unfused model (BN kept apart)")
    return TrainState(model, tx.init(trained_tensors(model)), 0)


def init_train_state(key: int | torch.Generator, cfg: YoloConfig,
                     tx: Optimizer, device: torch.device | str = "cuda",
                     mesh=None) -> TrainState:
    """A random unfused model (``init_model`` from a seed or a generator)
    on ``device`` and its optimizer state."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training over a mesh is ROADMAP A14b; the port trains "
            "on one device")
    g = key if isinstance(key, torch.Generator) else (
        torch.Generator().manual_seed(int(key)))
    return train_state(init_model(cfg, g, device), tx)


def _tensor(v, device: torch.device) -> torch.Tensor:
    """A tensor, or a host array through ``utils.transfer.to_device`` (on
    the card without a wait, so the host queues the step behind the
    last)."""
    return v.to(device) if isinstance(v, torch.Tensor) else to_device(
        np.asarray(v), device)


def make_loss_fn(cfg: YoloConfig, imgsz: int,
                 loss_weights: LossWeights = LossWeights()):
    """-> ``loss_fn(model, images, targets) -> (loss, metrics)``: the JAX
    step's ``loss_fn``, under :func:`exact_step`. ``images`` (B, S, S, 3) in
    [0, 1], NHWC as the JAX step takes them, and the targets dict are
    numpy arrays or tensors; they go to the model's device."""
    hw = feat_hw((imgsz, imgsz), cfg.strides)
    grids: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def loss_fn(model: YoloModel, images, targets):
        dev = next(model.parameters()).device
        if dev not in grids:
            grids[dev] = make_anchors(hw, cfg.strides, device=dev)
        anchors, strides = grids[dev]
        x = _tensor(images, dev).float().permute(0, 3, 1, 2)
        targets = {k: _tensor(v, dev) for k, v in targets.items()}
        with exact_step():
            out = model_apply(model, x)
            return detection_loss(out, targets, anchors, strides, nc=cfg.nc,
                                  reg_max=cfg.reg_max, weights=loss_weights)

    return loss_fn


def make_train_step(cfg: YoloConfig, imgsz: int, tx: Optimizer, *,
                    compute_dtype: torch.dtype = torch.float32,
                    loss_weights: LossWeights = LossWeights()):
    """-> ``train_step(state, images, targets) -> (state, metrics)``: one
    update of ``state``'s model in place (the returned state counts it),
    metrics as 0-d tensors on the device (reading one waits for the
    step)."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype}: the port trains in float32; "
            "mixed precision is ROADMAP A14c")
    loss_fn = make_loss_fn(cfg, imgsz, loss_weights)

    def train_step(state: TrainState, images, targets):
        loss, metrics = loss_fn(state.model, images, targets)
        state.opt.zero_grad(set_to_none=True)
        with exact_step():
            loss.backward()
        tx.update(state.opt, state.step)
        return state._replace(step=state.step + 1), {
            k: v.detach() for k, v in metrics.items()}

    return train_step


def shard_batch(mesh, images, targets):
    """The JAX ``shard_batch``: placing a batch on a mesh's 'dp' axis."""
    raise NotImplementedError(
        "placing a batch on a mesh is ROADMAP A14b; the port trains on one "
        "device")
