"""Ragged all-to-all record routing (skew-proof minimizer exchange).

The padded routing in parallel/shard_count.py reserves a fixed
[n_shards, cap] block per (source, destination) pair, so the worst
(source, destination) load sets everyone's memory and wire bytes.  Real
minimizer distributions are skewed (33 bins held 102k records on reads.txt,
SURVEY.md section 7), forcing large slack factors.

Here each destination instead has ONE capacity budget; senders transmit
exactly their real record counts with ``lax.ragged_all_to_all``.  Wire
traffic equals actual bytes, and capacity is a per-destination total --
robust to per-pair skew, only bounded by true receiver load.

Capacity discipline: every shard all-gathers the send-size matrix, then
grants are assigned greedily by sender rank with a closed form
(granted[s] = clip(cap - excl_cumsum(sizes)[s], 0, sizes[s]) -- once the
budget is exhausted later senders get nothing), so all parties agree on
offsets without extra rounds, nothing is ever written out of bounds, and
the dropped-record count is reported exactly.

XLA:GPU implements ragged-all-to-all, so a mesh of GPUs takes the native
collective.  XLA:CPU does not (ThunkEmitter UNIMPLEMENTED), so on CPU
meshes -- the unit-test environment -- a dense emulation with identical
semantics runs instead (``has_native`` makes the choice).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from genome_assembly_tpu.common import SENTINEL


def _emulated_ragged_a2a(
    operand, output, input_offsets, send_sizes, output_offsets, recv_sizes,
    axis_name,
):
    """Reference semantics of lax.ragged_all_to_all on a dense all_to_all.

    O(n_shards * n) scratch -- the CPU-mesh path.
    """
    n_shards = lax.psum(1, axis_name)
    n = operand.shape[0]
    cap_out = output.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    src_pos = input_offsets[:, None].astype(jnp.int32) + idx[None, :]
    mask = idx[None, :] < send_sizes[:, None]
    rows = operand[jnp.clip(src_pos, 0, n - 1)]
    if operand.ndim > 1:
        blocks = jnp.where(mask[..., None], rows, 0)
    else:
        blocks = jnp.where(mask, rows, 0)
    recv = lax.all_to_all(blocks, axis_name, split_axis=0, concat_axis=0, tiled=True)
    # each sender told us where its block lands in our output
    off_from = lax.all_to_all(
        output_offsets.astype(jnp.int32), axis_name, 0, 0, tiled=True
    )
    pos = jnp.where(
        idx[None, :] < recv_sizes[:, None].astype(jnp.int32),
        off_from[:, None] + idx[None, :],
        cap_out,
    ).reshape(-1)
    flat = recv.reshape((n_shards * n,) + recv.shape[2:])
    return output.at[pos].set(flat, mode="drop")


def has_native(mesh) -> bool:
    """Whether ``mesh``'s devices run lax.ragged_all_to_all natively.

    Keyed on the MESH's platform, not jax.default_backend(): a CPU mesh on
    a GPU host must take the emulation."""
    return mesh.devices.flat[0].platform == "gpu"


def ragged_a2a(
    operand, output, input_offsets, send_sizes, output_offsets, recv_sizes,
    axis_name, *, use_native: bool,
):
    """lax.ragged_all_to_all, or its dense emulation on backends without it.

    use_native must be ``has_native(mesh)`` for the mesh the collective
    runs over: XLA:CPU has no ragged-all-to-all."""
    if use_native:
        return lax.ragged_all_to_all(
            operand,
            output,
            input_offsets,
            send_sizes,
            output_offsets,
            recv_sizes,
            axis_name=axis_name,
        )
    return _emulated_ragged_a2a(
        operand, output, input_offsets, send_sizes, output_offsets, recv_sizes,
        axis_name,
    )


def route_records_ragged(
    owner_sorted, payload, *, n_shards, cap_total, axis_name, use_native
):
    """Route owner-sorted records to their owners with exact sizes.

    owner_sorted: [n] uint32 ascending owner per record (n_shards = parked
    invalid rows, at the end).  payload: [n, L] uint32 rows in the same
    order (sentinel in lane 0 for invalid rows).

    Returns (received [cap_total, L] sentinel-padded, dropped) where
    dropped counts this shard's records denied by receiver capacity.
    """
    targets = jnp.arange(n_shards, dtype=owner_sorted.dtype)
    start = jnp.searchsorted(owner_sorted, targets, side="left").astype(jnp.int32)
    end = jnp.searchsorted(owner_sorted, targets, side="right").astype(jnp.int32)
    sizes = end - start  # [n_dst] true send sizes

    mat = lax.all_gather(sizes, axis_name)  # [n_src, n_dst]
    me = lax.axis_index(axis_name)
    excl = jnp.cumsum(mat, axis=0) - mat
    granted = jnp.clip(cap_total - excl, 0, mat)  # [n_src, n_dst]
    out_off = jnp.cumsum(granted, axis=0) - granted
    my_granted = granted[me]
    dropped = jnp.sum(sizes - my_granted)

    out_buf = jnp.full((cap_total,) + payload.shape[1:], SENTINEL, payload.dtype)
    received = ragged_a2a(
        payload,
        out_buf,
        start,
        my_granted,
        out_off[me],
        granted[:, me],
        axis_name,
        use_native=use_native,
    )
    return received, dropped
