"""Sequence parallelism: k-1-base halo exchange for long sequences.

The reference caps reads at 100 bp (binning.c:13); long sequences (contigs,
whole genomes) don't fit one shard's tile.  The array-native treatment mirrors
ring attention's neighbor exchange: split the sequence into segments across
the mesh, ``ppermute`` each segment's leading k-1 bases to its left
neighbor, and scan the locally-extended segment -- every window is scored
exactly once, by the shard owning its start position (SURVEY.md section 5.7).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

SHARD_AXIS = "shards"


def _halo_body(seg, seg_valid_len, *, k):
    """Per-shard: receive the right neighbor's first k-1 bases and append.

    seg: [1, L] this shard's segment codes.  Returns [1, L + k - 1] extended
    segment and its valid length.
    """
    n = lax.axis_size(SHARD_AXIS)
    idx = lax.axis_index(SHARD_AXIS)
    halo = seg[:, : k - 1]
    # send my first k-1 bases to my LEFT neighbor (they extend rightward)
    left = [(i, (i - 1) % n) for i in range(n)]
    recv = lax.ppermute(halo, SHARD_AXIS, perm=left)
    ext = jnp.concatenate([seg, recv], axis=1)
    # the last shard has no right neighbor: its halo is shard 0's prefix,
    # which must not be scanned -- cap the valid length.
    is_last = idx == n - 1
    ext_len = jnp.where(
        is_last, seg_valid_len.reshape(()), seg_valid_len.reshape(()) + (k - 1)
    )
    return ext, ext_len.reshape(1)


@functools.partial(jax.jit, static_argnames=("k", "mesh"))
def haloed_segments(
    segments: jnp.ndarray, seg_lens: jnp.ndarray, *, k: int, mesh: Mesh
):
    """[n_shards, L] segments -> [n_shards, L + k - 1] halo-extended ones.

    seg_lens: [n_shards] valid bases per segment.  The returned lengths
    ensure each window is counted exactly once across shards.
    """
    fn = jax.shard_map(
        functools.partial(_halo_body, k=k),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    return fn(segments, seg_lens)


def split_sequence(seq_codes: np.ndarray, n_shards: int, k: int):
    """Host-side: split one long code sequence into n equal segments
    (padded) for haloed_segments."""
    total = len(seq_codes)
    seg_len = int(np.ceil(total / n_shards))
    segments = np.zeros((n_shards, seg_len), dtype=np.uint8)
    lens = np.zeros(n_shards, dtype=np.int32)
    for s in range(n_shards):
        lo = s * seg_len
        hi = min(total, lo + seg_len)
        if hi > lo:
            segments[s, : hi - lo] = seq_codes[lo:hi]
            lens[s] = hi - lo
    return segments, lens
