"""Several devices: meshes, the sharding rule, streams split over devices,
training over ranks. Counterpart of ``strongsort_yolo_tpu/parallel``.

The JAX package shards array axes over a ``jax.sharding.Mesh`` and lets
XLA place the work and the collectives. The port keeps its two axes:

- dp: the stream axis in serving (``Pipeline.track_batch_prepare(mesh=)``,
  :class:`~.streams.StreamBatch`: one process, one block of streams per
  device, nothing exchanged) and the image batch in training;
- tp: the output channels of the wide conv weights in training
  (``parallel/ranks.py``: one process per mesh position over
  ``torch.distributed``).

``streams`` imports the pipeline, so this package exports the mesh
module only.
"""

from strongsort_yolo_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    make_param_shardings,
    replicate,
)

__all__ = ["Mesh", "Sharding", "batch_sharding", "make_mesh",
           "make_param_shardings", "replicate"]
