"""Meshes of devices and the sharding rule: the port's copy of
``strongsort_yolo_tpu/parallel/mesh.py``.

A :class:`Mesh` is a (dp, tp) grid of ``torch.device`` with the axis
names ("dp", "tp"). It describes a layout and holds no process or
communicator: serving (``Pipeline.track_batch_prepare(mesh=...)``,
:class:`~strongsort_yolo_tpu_torch.parallel.streams.StreamBatch`) steps
one block of streams per dp row in one process, and training
(``parallel/ranks.py``) starts one process per mesh position. A mesh may
name a device more than once: four blocks on ``["cpu"] * 4``, or two
ranks on one card.

A :class:`Sharding` is a mesh and a spec, one entry per leading
dimension of a tensor (None, or the axis that splits it), as JAX's
``NamedSharding(mesh, PartitionSpec(...))``; ``()`` replicates.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

AXES = ("dp", "tp")


class Mesh:
    """A (dp, tp) grid of devices; ``devices[i, j]`` is the device of dp
    row i, tp column j, and ``shape`` is JAX's ``dict(mesh.shape)``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> list[torch.device]:
        """The devices in rank order (row-major: rank = i * tp + j)."""
        return list(self.devices.ravel())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"

    def __reduce__(self):  # pickled by device names (spawned ranks)
        return _mesh_from_names, ([str(d) for d in self.flat()],
                                  self.shape["dp"], self.shape["tp"])


def _mesh_from_names(names: list[str], dp: int, tp: int) -> Mesh:
    return make_mesh(dp * tp, dp=dp, tp=tp, devices=names)


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              tp: int = 1,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """2-D ('dp', 'tp') mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device). ``devices`` may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devices)} given")
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(dp, tp))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``spec[d]`` names the mesh axis that splits dimension d of a tensor
    (None: whole); dimensions past the spec are whole."""

    mesh: Mesh
    spec: tuple[str | None, ...] = ()

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of the part of a ``shape`` tensor one device holds."""
        out = list(shape)
        for d, axis in enumerate(self.spec):
            if axis is not None:
                out[d] //= self.mesh.shape[axis]
        return tuple(out)


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch / stream) sharding over 'dp'."""
    return Sharding(mesh, ("dp",))


def tp_spec_for(shape: Sequence[int], tp: int,
                min_channels: int) -> tuple[str | None, ...]:
    """JAX's ``_tp_spec_for`` in the port's layout: a conv weight (OIHW,
    the output channel first where JAX's HWIO has it last) and a 1-D
    bias or BN vector split their output channels over 'tp' when those
    divide by tp and number at least ``min_channels``; anything else is
    replicated."""
    if len(shape) in (1, 4):
        cout = shape[0]
        if cout % tp == 0 and cout >= min_channels:
            return ("tp",) + (None,) * (len(shape) - 1)
    return ()


def make_param_shardings(params: Mapping[str, torch.Tensor] | torch.nn.Module,
                         mesh: Mesh, *,
                         min_channels: int = 64) -> dict[str, Sharding]:
    """name -> :class:`Sharding` of every tensor of a state_dict (or of a
    module's): output-channel splits over 'tp' by :func:`tp_spec_for`,
    everything replicated where tp is 1."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    tp = mesh.shape["tp"]
    return {
        name: Sharding(mesh, () if tp == 1 else
                       tp_spec_for(tuple(t.shape), tp, min_channels))
        for name, t in params.items()
    }
