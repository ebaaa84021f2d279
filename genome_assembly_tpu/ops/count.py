"""Sort-based k-mer counting and abundance pruning.

The reference's two-level chained hash (mmer -> kmer -> read-id list,
binning.c:1042-1069 + zhash.c) is a pointer-chasing CPU idiom.  On the device
the same table is: flatten all window records, lexicographically sort by
(mmer, kmer_hi, kmer_lo) with a stable sort, and reduce runs of equal keys
with segmented sums.  Pruning (prune_kmers, binning.c:1085-1123) is a mask:
keep a group iff its occurrence count > cutoff.

Counts are occurrences, not distinct reads, matching the reference
(binning.c:1060-1069, SURVEY.md 2.1.5).  Read-id lists per entry are the
group's payload slice; the reference maintains them in descending order, and
a stable sort keeps stream order (ascending read id) inside each group, so
the host reverses per group when materializing parity output.

Everything is static-shape: invalid records are given a sentinel mmer that
sorts past every real key and are masked out of all reductions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from genome_assembly_tpu.ops.minimizer import WindowRecords

# Sentinel mmer for padding/invalid records: real mmers are < 2^30.
from genome_assembly_tpu.common import SENTINEL


def group_counts(group_start: jnp.ndarray) -> jnp.ndarray:
    """Group sizes broadcast to every member, scatter-free.

    Scatter-free by design (segment_sum would scatter): the size
    of each run is (next run start - own run start), both computed with
    associative scans and a gather:
      start_idx[i] = index of i's group start  (forward cummax)
      next_start[i] = first group start strictly after i  (reverse cummin)
    """
    n = group_start.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    start_idx = lax.associative_scan(
        jnp.maximum, jnp.where(group_start, idx, -1)
    )
    starts_or_n = jnp.where(group_start, idx, n)
    suffix_min = lax.associative_scan(jnp.minimum, starts_or_n, reverse=True)
    next_start = jnp.concatenate(
        [suffix_min[1:], jnp.full((1,), n, jnp.int32)]
    )
    count_at_start = next_start - idx
    return count_at_start[start_idx]


class CountedTable(NamedTuple):
    """Sorted, counted, pruned k-mer table (still padded to N records).

    All arrays have length N = total window slots.  Records are sorted by
    (mmer, kmer_hi, kmer_lo); invalid slots hold SENTINEL mmers at the end.

    group_start: True at the first record of each distinct (mmer, kmer).
    count: occurrence count of the record's group (broadcast to every member).
    keep: group_start & count > cutoff & valid -- one True per surviving
      table entry (the post-prune table rows).
    read_id: per-occurrence read ids, stream-ordered within each group.
    stream_idx: flat (read, window) stream position of each occurrence; the
      value at a group's first record is the entry's insertion time, which
      the parity replay engine uses to rebuild the reference's exact hash
      table layout (insertion order determines bucket chains and grow
      points, SURVEY.md 2.1.10/12).
    """

    mmer: jnp.ndarray
    kmer_hi: jnp.ndarray
    kmer_lo: jnp.ndarray
    read_id: jnp.ndarray
    stream_idx: jnp.ndarray
    valid: jnp.ndarray
    group_start: jnp.ndarray
    count: jnp.ndarray
    keep: jnp.ndarray

    @property
    def n_entries(self) -> jnp.ndarray:
        """Distinct (mmer, kmer) entries before pruning."""
        return jnp.sum(self.group_start & self.valid)

    @property
    def n_kept(self) -> jnp.ndarray:
        """Entries surviving the abundance cutoff."""
        return jnp.sum(self.keep)


@functools.partial(jax.jit, static_argnames=("cutoff",))
def count_and_prune(
    records: WindowRecords,
    read_ids: jnp.ndarray,
    *,
    cutoff: int,
    stream_offset=0,
) -> CountedTable:
    """Count occurrences of each (mmer, kmer) and apply the abundance mask.

    records: WindowRecords with [batch, n_windows] arrays.
    read_ids: [batch] uint32 read ids (broadcast across windows).
    stream_offset: global stream index of this batch's first window slot
      (batch_index * batch_rows * n_windows when batching uniformly).
    """
    batch, n_win = records.mmer.shape
    n = batch * n_win

    mmer = jnp.where(records.valid, records.mmer, SENTINEL).reshape(n)
    khi = records.kmer_hi.reshape(n)
    klo = records.kmer_lo.reshape(n)
    rid = jnp.broadcast_to(read_ids[:, None], (batch, n_win)).reshape(n)
    stream = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(stream_offset)

    # Stable lexicographic sort by (mmer, hi, lo); payload rides along, so
    # equal keys keep stream order == ascending (read_id, window).  The
    # valid flag is NOT a sort operand: invalid records hold SENTINEL
    # mmers, so validity is recoverable from the sorted key lane (one
    # less lane through the sort).
    mmer_s, khi_s, klo_s, rid_s, stream_s = lax.sort(
        (mmer, khi, klo, rid, stream), num_keys=3, is_stable=True
    )
    valid_s = mmer_s != SENTINEL

    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            (mmer_s[1:] == mmer_s[:-1])
            & (khi_s[1:] == khi_s[:-1])
            & (klo_s[1:] == klo_s[:-1]),
        ]
    )
    group_start = ~prev_same
    count = group_counts(group_start)
    keep = group_start & valid_s & (count > cutoff)
    return CountedTable(
        mmer=mmer_s,
        kmer_hi=khi_s,
        kmer_lo=klo_s,
        read_id=rid_s,
        stream_idx=stream_s,
        valid=valid_s,
        group_start=group_start,
        count=count,
        keep=keep,
    )


class KeyCounts(NamedTuple):
    """Payload-free counted keys (fast mode): sorted by (hi, lo).

    kept keys are the pruned canonical k-mer set, already in the order the
    dBG lookup phase needs.  Full per-group counts are not materialized on
    this path (the abundance test needs only a shifted equality, below);
    use ``key_group_counts`` when actual counts are wanted.
    """

    kmer_hi: jnp.ndarray
    kmer_lo: jnp.ndarray
    valid: jnp.ndarray  # real (non-sentinel) rows
    group_start: jnp.ndarray
    keep: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cutoff",))
def count_keys(records: WindowRecords, *, cutoff: int) -> KeyCounts:
    """Count canonical k-mers without carrying read-id/stream payloads.

    The fast pipeline needs only the distinct pruned keys: sorting two
    uint32 key lanes is ~3x cheaper than the payload-carrying sort the
    parity path requires, and the sorted kept keys feed ops/dbg.py
    directly.  The abundance test itself is scan-free: a sorted run has
    length > cutoff iff the element ``cutoff`` positions ahead still equals
    the run head -- one shifted comparison instead of segmented counting
    (which cost ~4x the sort itself in associative scans and gathers).
    """
    n = records.kmer_hi.size
    sentinel = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(records.valid, records.kmer_hi, sentinel).reshape(n)
    lo = jnp.where(records.valid, records.kmer_lo, sentinel).reshape(n)
    hi_s, lo_s = lax.sort((hi, lo), num_keys=2)
    valid = hi_s != sentinel
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1]),
        ]
    )
    group_start = ~prev_same
    if cutoff <= 0:
        long_enough = jnp.ones_like(group_start)
    else:
        # run length > cutoff  <=>  key[i + cutoff] == key[i]
        pad_hi = jnp.full((cutoff,), sentinel, dtype=jnp.uint32)
        hi_ahead = jnp.concatenate([hi_s[cutoff:], pad_hi])
        lo_ahead = jnp.concatenate([lo_s[cutoff:], pad_hi])
        long_enough = (hi_ahead == hi_s) & (lo_ahead == lo_s) & valid
    keep = group_start & valid & long_enough
    return KeyCounts(hi_s, lo_s, valid, group_start, keep)


def key_group_counts(kc: KeyCounts) -> jnp.ndarray:
    """Per-record group sizes for a KeyCounts (when counts are needed)."""
    return group_counts(kc.group_start)


@jax.jit
def kept_keys_sorted_with_counts(kc: KeyCounts):
    """kept_keys_sorted plus each kept key's occurrence count.

    The count lane rides the compaction sort as a payload, so the returned
    counts align row-for-row with the compacted keys -- the coverage
    channel the reference carries as per-BP read-id lists
    (binning.c:154-195, 857-888) reduced to its abundance signal.

    Returns (hi, lo, valid, count) all shaped like the input; count is 0
    on sentinel rows.
    """
    sentinel = jnp.uint32(0xFFFFFFFF)
    counts = group_counts(kc.group_start)
    hi = jnp.where(kc.keep, kc.kmer_hi, sentinel)
    lo = jnp.where(kc.keep, kc.kmer_lo, sentinel)
    cnt = jnp.where(kc.keep, counts, 0).astype(jnp.uint32)
    # kept keys are distinct, so the 2-key sort has no real ties; sentinel
    # ties all carry count 0
    hi_c, lo_c, cnt_c = lax.sort((hi, lo, cnt), num_keys=2)
    return hi_c, lo_c, hi_c != sentinel, cnt_c


class KeyRidCounts(NamedTuple):
    """Fast-mode counted keys carrying per-occurrence read ids.

    Sorted by (hi, lo, rid): occurrences of one k-mer are adjacent with
    ascending read ids -- the CSR value order.  Cheaper than the parity
    path's 5-lane sort (no mmer or stream lane; fast-mode canonical k-mers
    determine their minimizer, so (hi, lo) alone is the group key).
    """

    kmer_hi: jnp.ndarray
    kmer_lo: jnp.ndarray
    read_id: jnp.ndarray
    valid: jnp.ndarray
    group_start: jnp.ndarray
    count: jnp.ndarray
    keep: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cutoff",))
def count_keys_rids(
    records: WindowRecords, read_ids: jnp.ndarray, *, cutoff: int
) -> KeyRidCounts:
    """count_keys with a read-id payload lane (fast-mode provenance).

    records: WindowRecords of any shape; read_ids: uint32, same shape as
    records.kmer_hi (window slot -> owning read).  Occurrence counting
    matches count_keys exactly; the extra rid key lane only orders
    occurrences inside each (hi, lo) group.
    """
    n = records.kmer_hi.size
    sentinel = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(records.valid, records.kmer_hi, sentinel).reshape(n)
    lo = jnp.where(records.valid, records.kmer_lo, sentinel).reshape(n)
    rid = read_ids.reshape(n)
    hi_s, lo_s, rid_s = lax.sort((hi, lo, rid), num_keys=3)
    valid = hi_s != sentinel
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1]),
        ]
    )
    group_start = ~prev_same
    count = group_counts(group_start)
    keep = group_start & valid & (count > cutoff)
    return KeyRidCounts(hi_s, lo_s, rid_s, valid, group_start, count, keep)


@jax.jit
def kept_keys_sorted(kc: KeyCounts):
    """Compact kept group-start keys to the front (sorted by key already).

    Returns (hi, lo, valid) shaped like the input, sentinel-padded -- the
    exact input format ops/dbg.py expects.  Kept keys are distinct and
    already in ascending order, so masking the rest to SENTINEL and
    re-sorting the two key lanes compacts them in order -- no stable
    3-lane flag sort needed (that sort was the peak-memory step of
    out-of-core passes).
    """
    sentinel = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(kc.keep, kc.kmer_hi, sentinel)
    lo = jnp.where(kc.keep, kc.kmer_lo, sentinel)
    hi_c, lo_c = lax.sort((hi, lo), num_keys=2)
    return hi_c, lo_c, hi_c != sentinel


def merge_sorted_tables(tables: list[CountedTable], *, cutoff: int) -> CountedTable:
    """Merge per-batch counted tables into one (host-free, device concat+resort).

    Used when a read set spans several device batches: groups split across
    batches are re-merged by a second sort over the concatenated records.
    Pruning must be applied only after the merge, so per-batch tables should
    be built with cutoff=-1 (keep everything) before merging.
    """
    mmer = jnp.concatenate([t.mmer for t in tables])
    khi = jnp.concatenate([t.kmer_hi for t in tables])
    klo = jnp.concatenate([t.kmer_lo for t in tables])
    rid = jnp.concatenate([t.read_id for t in tables])
    stream = jnp.concatenate([t.stream_idx for t in tables])
    valid = jnp.concatenate([t.valid for t in tables])
    n = mmer.shape[0]
    mmer = jnp.where(valid, mmer, SENTINEL)
    # Sort with the global stream index as a key so per-group payload order
    # is stream order even though the inputs were per-batch sorted; the
    # valid flag is recomputed from the sentinel key lane.
    mmer_s, khi_s, klo_s, stream_s, rid_s = lax.sort(
        (mmer, khi, klo, stream, rid), num_keys=4, is_stable=True
    )
    valid_s = mmer_s != SENTINEL
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            (mmer_s[1:] == mmer_s[:-1])
            & (khi_s[1:] == khi_s[:-1])
            & (klo_s[1:] == klo_s[:-1]),
        ]
    )
    group_start = ~prev_same
    count = group_counts(group_start)
    keep = group_start & valid_s & (count > cutoff)
    return CountedTable(
        mmer_s, khi_s, klo_s, rid_s, stream_s, valid_s, group_start, count, keep
    )
