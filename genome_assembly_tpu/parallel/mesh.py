"""Device mesh helpers.

The scaling design (SURVEY.md section 2.2): read batches are data-parallel
across the mesh's ``shards`` axis; the count table is partitioned by
minimizer ownership, with records routed via ``all_to_all`` over the interconnect.  A
single 1-D axis covers both roles -- reads sharded by batch row, table
sharded by ``owner(minimizer)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (SHARD_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (read-batch) axis across the mesh."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
