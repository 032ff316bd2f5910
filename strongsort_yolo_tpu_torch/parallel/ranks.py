"""Training over a mesh: one process per mesh position, joined by
``torch.distributed``.

The JAX trainer places its parameters with tensor-parallel shardings and
its batch on 'dp', and XLA inserts the collectives. Here each rank holds
what its shard of those layouts holds and calls the collectives itself:

- dp: each rank takes a contiguous block of the global batch
  (``train/trainer.shard_batch``); the gradients are averaged over the
  dp group, since the JAX loss is a mean of per-image terms over the
  global batch, and the metrics (means over images, ``num_fg`` too) are
  averaged the same way.
- tp: every conv whose weight :func:`~.mesh.tp_spec_for` splits keeps
  this rank's slice of its output channels (weight, bias, BN scale,
  bias and statistics), computes those channels and gathers all of them
  over the tp group before the next layer reads them (:class:`TpShard`).
  Every tp rank then computes the same loss from the same activations.
  A split conv's input sums its gradient over tp in the backward (each
  rank's channels give only their part of it), so every rank holds the
  whole gradient of a gathered activation, and the gather's backward
  takes this rank's slice of it: the autograd all_gather of
  ``torch.distributed.nn`` would sum the tp copies, tp times the
  gradient. The clip's norm adds the squared norms of the split tensors
  over tp and counts the replicated ones once.

:func:`launch` starts the ranks: gloo on the CPU and where two ranks
share a card (NCCL refuses that), NCCL across distinct cards; the
rendezvous is a file in a directory the caller names. A rank that fails
fails the run, and a collective that does not complete within the
process group's timeout fails its rank.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from strongsort_yolo_tpu_torch.parallel.mesh import Mesh, make_param_shardings


def backend_for(mesh: Mesh) -> str:
    """'gloo' on CPU devices and where a card is named twice, 'nccl' when
    every position has a card of its own."""
    devices = mesh.flat()
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a training mesh takes CPU or CUDA devices: {mesh}")
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


class _GatherChannels(torch.autograd.Function):
    """All tp ranks' channel slices, concatenated in rank order; the
    backward keeps this rank's slice of the (identical) whole gradient."""

    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.lo, ctx.hi = index * y.shape[1], (index + 1) * y.shape[1]
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.lo:ctx.hi], None, None, None


class _SumGradOverTp(torch.autograd.Function):
    """The identity; its backward sums the gradient over the tp group: a
    split conv's rank gives its input only its own channels' part of the
    input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class TpShard:
    """A conv's share of a tp group: output channels [lo, hi) of its
    ``c_out``. A grouped conv (v11's depthwise convs) reads only the
    input channels of its groups, ``in_lo:in_hi``."""

    def __init__(self, group, index: int, size: int, c_out: int,
                 c_in_group: int, groups: int):
        per = c_out // size
        self.group, self.index, self.size = group, index, size
        self.lo, self.hi = index * per, (index + 1) * per
        self.in_lo = self.in_hi = None
        self.groups = groups
        if groups > 1:
            out_group = c_out // groups
            if per % out_group:
                raise ValueError(f"a tp share of {per} channels splits a "
                                 f"group of {out_group}")
            self.groups = per // out_group
            self.in_lo = self.lo // out_group * c_in_group
            self.in_hi = self.hi // out_group * c_in_group

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        x = _SumGradOverTp.apply(x, self.group)
        return x if self.in_lo is None else x[:, self.in_lo:self.in_hi]

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherChannels.apply(y, self.group, self.index, self.size)


class Ranks:
    """This process's place in a mesh run: its rank, its (dp, tp) indices,
    its device, its dp and tp groups, and the state_dict names of the
    tensors it holds a tp slice of (``sharded``, filled by
    :meth:`shard_model`). Every rank makes every group, in one order, so
    all ranks construct it at the same point."""

    def __init__(self, mesh: Mesh):
        if not dist.is_initialized() or dist.get_world_size() != mesh.size:
            raise RuntimeError(
                f"a mesh of {mesh.size} positions trains in {mesh.size} "
                "processes joined by torch.distributed (parallel/ranks.launch)")
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        self.mesh, self.dp, self.tp = mesh, dp, tp
        self.rank = dist.get_rank()
        self.dp_index, self.tp_index = divmod(self.rank, tp)
        self.device = mesh.flat()[self.rank]
        self.dp_group = self.tp_group = None
        for j in range(tp):  # ranks sharing a tp index: one dp group each
            g = dist.new_group([i * tp + j for i in range(dp)])
            if j == self.tp_index:
                self.dp_group = g
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if i == self.dp_index:
                self.tp_group = g
        self.sharded: set[str] = set()
        self._split_ids: set[int] = set()  # the split tensors themselves
        self._split = None  # global_norm's mask, made on its first call

    def shard_model(self, model: torch.nn.Module,
                    min_channels: int = 64) -> None:
        """Keep, in place, this rank's tp slice of every conv the rule
        splits (before the optimizer is made: its tensors are replaced)."""
        from strongsort_yolo_tpu_torch.models.common import Conv

        if self.tp == 1:
            return
        specs = make_param_shardings(model, self.mesh, min_channels=min_channels)
        for name, conv in model.named_modules():
            if not isinstance(conv, Conv) or specs[f"{name}.w"].replicated:
                continue
            shard = TpShard(self.tp_group, self.tp_index, self.tp,
                            conv.w.shape[0], conv.w.shape[1], conv.groups)
            for key, t in list(conv.named_parameters(recurse=False)) + list(
                    conv.named_buffers(recurse=False)):
                if specs[f"{name}.{key}"].replicated:
                    raise ValueError(f"{name}.{key}: split weight, whole {key}")
                part = t.detach()[shard.lo:shard.hi].clone()
                if isinstance(t, torch.nn.Parameter):
                    part = torch.nn.Parameter(part)
                setattr(conv, key, part)
                self.sharded.add(f"{name}.{key}")
                self._split_ids.add(id(part))
            conv.groups = shard.groups
            conv.tp = shard

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name in self.sharded:
            parts = [torch.empty_like(t) for _ in range(self.tp)]
            dist.all_gather(parts, t.detach().contiguous(), group=self.tp_group)
            t = torch.cat(parts, 0)
        return t.detach().cpu()

    def state_dict(self, model: torch.nn.Module) -> dict[str, torch.Tensor]:
        """The whole state_dict on the host: every split tensor gathered
        over the tp group (a collective: every rank calls it)."""
        return {n: self._whole(n, t) for n, t in model.state_dict().items()}

    def grads(self, model: torch.nn.Module) -> dict[str, torch.Tensor]:
        """The whole gradient of every trained tensor that holds one, by
        state_dict name, on the host (a collective, as :meth:`state_dict`)."""
        named = list(model.named_parameters()) + list(model.named_buffers())
        return {n: self._whole(n, t.grad) for n, t in named
                if t.grad is not None}

    def average_grads(self, tensors: list[torch.Tensor]) -> None:
        """Each gradient := its mean over the dp group (one all_reduce of
        all of them)."""
        if self.dp == 1:
            return
        grads = [t.grad for t in tensors if t.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.dp_group)
        flat /= self.dp
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def average(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Scalar metrics (means over this rank's images) -> their means
        over the global batch."""
        if self.dp == 1:
            return metrics
        vals = torch.stack([v.detach().float() for v in metrics.values()])
        dist.all_reduce(vals, group=self.dp_group)
        vals /= self.dp
        return dict(zip(metrics, vals.unbind()))

    def global_norm(self, tensors: list[torch.Tensor],
                    norms: torch.Tensor) -> torch.Tensor:
        """The norm of the whole gradient from the gradient norms of
        ``tensors`` (this rank's trained tensors, in a fixed order): the
        squares of the split ones summed over tp, the replicated ones'
        counted once."""
        if self._split is None:
            self._split = torch.tensor(
                [id(t) in self._split_ids for t in tensors]).to(norms.device)
        sq = norms.square()
        part = torch.where(self._split, sq, 0.0).sum()
        dist.all_reduce(part, group=self.tp_group)
        return torch.sqrt(part + torch.where(self._split, 0.0, sq).sum())


def _rank_main(fn, mesh, rank, init, backend, pg_timeout, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        device = mesh.flat()[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=mesh.size,
            timeout=datetime.timedelta(seconds=pg_timeout))
        result = fn(mesh, *args)
    except BaseException:
        # reported before the process group goes down with the process
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()
    out.put((rank, True, result))


def launch(fn: Callable, mesh: Mesh, args: tuple = (), *,
           rundir: str | None = None, timeout: float | None = None,
           pg_timeout: float = 300.0, threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` in one spawned process per mesh position,
    each joined to the others by ``torch.distributed`` (backend
    :func:`backend_for`; rendezvous through a file in ``rundir``, a new
    temporary directory by default) and on its device (the current CUDA
    device on a card). ``fn`` is a module-level function; its return
    value is pickled. -> the ranks' return values in rank order.
    Raises if a rank raises or dies, or when ``timeout`` seconds (if
    given) pass; every process is ended either way. ``pg_timeout`` bounds each
    collective; ``threads`` sets each rank's intra-op threads."""
    import multiprocessing

    with tempfile.TemporaryDirectory(dir=rundir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, mesh, r, init, backend_for(mesh), pg_timeout, threads,
                  args, out),
            daemon=True) for r in range(mesh.size)]
        results: dict[int, object] = {}
        deadline = time.monotonic() + (timeout or float("inf"))
        try:
            for p in procs:
                p.start()
            while len(results) < len(procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"mesh run: {len(results)} of {len(procs)} ranks "
                        f"done after {timeout} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead and out.empty():
                        raise RuntimeError(
                            f"mesh run: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    failed = {rank: value}
                    # the others' failures (a peer's closed connection
                    # often comes first): a moment to arrive
                    grace = time.monotonic() + 5.0
                    while time.monotonic() < grace:
                        try:
                            r, r_ok, v = out.get(timeout=0.5)
                        except queue.Empty:
                            continue
                        if not r_ok:
                            failed[r] = v
                    raise RuntimeError("mesh run: " + "\n".join(
                        f"rank {r} failed:\n{v}" for r, v in sorted(failed.items())))
                results[rank] = value
            for p in procs:
                p.join(min(max(deadline - time.monotonic(), 1.0), 60.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            out.close()
    return [results[r] for r in range(len(procs))]
