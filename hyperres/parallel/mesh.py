"""Device meshes and sharding helpers.

The reference has no distributed execution at all (SURVEY.md section
2.8); here parallelism is expressed the JAX way: a ``jax.sharding.Mesh``
+ named shardings, with XLA inserting the collectives. The natural axes
for this workload:
- ``data`` — tiles / scenes / pixel batches (embarrassingly parallel
  loops of the reference: tiles_helpers/utils.py:266-301, pair loops),
- ``band`` — the 285-band spectral axis (the reference's 32-band chunk
  loop, emit_proj.py:969-987, becomes a sharded axis).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the available devices. Default: 1-D 'data' mesh over all
    devices; pass shape=(dp, bp) + axis_names=("data", "band") for 2-D."""
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),)
    arr = np.array(devs[:int(np.prod(shape))]).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Place an array with its leading dim sharded over ``axis``."""
    spec = [None] * np.ndim(x)
    spec[0] = axis
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))
