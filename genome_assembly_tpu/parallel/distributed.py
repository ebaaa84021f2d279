"""Multi-host runtime: initialization, input sharding, failure handling.

Single-host multi-device needs none of this (a Mesh over local devices is
enough); N >= 2 hosts coordinate through ``jax.distributed``:

- ``init_multi_host`` wraps ``jax.distributed.initialize``.  The JAX
  runtime's heartbeat mechanism detects failed hosts: surviving processes
  raise within the missed-heartbeat window instead of hanging on
  collectives -- that is the failure-detection layer (SURVEY.md 5.3).
- Elastic recovery leans on the pipeline's phase structure: counting is
  restartable per read-batch (per-batch tables with cutoff=-1 merge
  idempotently -- utils/checkpoint.py serializes them at any boundary), so
  a restarted job re-reads only the batches whose checkpoints are missing
  and re-merges.  Extension restarts from the post-prune checkpoint.
- ``host_read_slice`` gives each host its contiguous slice of the read
  set so the global batch is sharded host-first, then device-first within
  a host (per-host input sharding; DCN only sees the all_to_all routing
  step, which XLA schedules over the intra-host fabric first).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax


def init_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed (no-op when single-process).

    Arguments default to JAX's own environment discovery; the process
    count to GA_NUM_PROCESSES (1).
    Returns (process_id, num_processes).
    """
    if num_processes is None:
        num_processes = int(os.environ.get("GA_NUM_PROCESSES", "1"))
    if num_processes > 1 or coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def host_read_slice(n_reads: int) -> Tuple[int, int]:
    """[start, stop) of this host's slice of a global read set."""
    p, n = jax.process_index(), jax.process_count()
    per = (n_reads + n - 1) // n
    start = p * per
    return start, min(n_reads, start + per)


def global_mesh(axis: str = "shards"):
    """1-D mesh over ALL processes' devices (intra- and inter-host)."""
    import numpy as np

    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))
