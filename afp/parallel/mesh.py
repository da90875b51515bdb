"""Device-mesh construction helpers (SURVEY.md §2.4, §5.8).

The scaling model: concurrent audio streams are embarrassingly parallel →
**stream-axis data parallelism** is the primary mesh axis (`'streams'`); an
optional `'time'` axis supports halo-exchange context parallelism over a
single long signal (§5.7).  Collectives are XLA's, under `shard_map` (NCCL
over NVLink between the cards of one host).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "P", "NamedSharding", "Mesh"]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("streams",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first `n_devices` devices.

    1-D by default (pure stream DP).  Pass ``axis_names=('streams', 'time')``
    and a `shape` for a 2-D stream×time mesh.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))

