"""Out-of-core counting: hash-partitioned multi-pass for beyond-HBM inputs.

A chromosome-scale run's window records exceed the in-core budget
(celegans preset: 2.9G records x 8 B = 23 GB), but the RECORD STREAM is
cheap to regenerate -- the scan is a small share of a scan + count step
(PERF.md) and reads re-stream from disk or from the on-device read
simulator.  So, KMC-style (PAPERS.md):

  pass g of ceil(P/G):  re-scan every batch once, extracting a GROUP of G
  consecutive RANGE partitions per scan (one batch sort keyed on the
  32-bit partition hash lays any number of consecutive partitions out as
  contiguous runs), then count each partition entirely in HBM.  G is
  sized from a staging-memory budget (default 8 GB -> G ~ 7 at the 1 GB
  per-partition record sizing), so the pass count is
  ~ total_record_bytes / budget.  The link builders (3-lane) and the
  parity path (5-lane) use the same range scheme via their
  payload-carrying extractors.

All of a key's duplicates share its hash, so per-partition counts are
complete and partitions are disjoint: the union of per-partition kept keys
IS the global pruned k-mer set (unordered across partitions; the sort-join
dBG builder does not need global order).

Device memory per pass: n_batches x cap_bp slots where cap_bp =
batch_slots/P x slack; compaction slack overflow is detected exactly
(the slice boundary still holding a real record), never silent.

Reference contrast: the reference would simply exhaust RAM (~1 kB per
occurrence, SURVEY.md section 6); no out-of-core path exists there.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from genome_assembly_tpu.ops import count as count_ops
from genome_assembly_tpu.ops.minimizer import WindowRecords

from genome_assembly_tpu.common import (
    HASH_A as _HASH_A,
    HASH_B as _HASH_B,
    LINK_HASH_A as _LINK_A,
    LINK_HASH_B as _LINK_B,
    SENTINEL,
    fmix32 as _fmix32,
)


# Maximum partitions extracted per re-scan pass under the range scheme.
# Bounds the unrolled slice count in the extraction executable (compile
# size), not memory; memory picks the actual group width.
MAX_GROUP = 16


def key_partition_range(hi: jnp.ndarray, lo: jnp.ndarray, partitions: int):
    """RANGE partition id: contiguous slices of the 32-bit mixed hash.

    pid = floor(h_top16 * P / 2^16) -- monotone in the hash, so a group of
    consecutive partitions is ONE contiguous hash interval and a single
    hash-keyed sort lays out any number of them as adjacent runs (the
    tag-folding scheme caps a group at 3 by spare key bits; this scheme's
    group width is bounded only by staging memory).  uint32-safe for
    partitions <= 65536 (x64 is disabled).  Balance granularity is the
    16-bit bucket: partitions own floor/ceil(65536/P) buckets each.
    """
    h = _fmix32((hi * _HASH_A) ^ (lo * _HASH_B))
    return ((h >> 16) * jnp.uint32(partitions)) >> 16


def link_partition_range(hi: jnp.ndarray, lo: jnp.ndarray, partitions: int):
    """RANGE partition id for the LINK builders' boundary keys.

    Same monotone top-16 scheme as key_partition_range but with the
    independent LINK_HASH constants: the 2-bit packing carries no length,
    so a T-leading k-mer and its 30-mer suffix are the SAME (hi, lo) pair
    -- a shared hash would hand ~1/4 of the FWD-suffix records their
    k-mer's COUNT partition band verbatim, and the kept keys arrive
    count-partition-ordered (see common.LINK_HASH_A).
    """
    h = _fmix32((hi * _LINK_A) ^ (lo * _LINK_B))
    return ((h >> 16) * jnp.uint32(partitions)) >> 16


def _range_lower_bound(p, partitions: int):
    """Smallest 32-bit hash owned by partition p (traced p, uint32 math).

    pid(h) >= p  <=>  (h >> 16) >= ceil(p * 2^16 / P); out-of-range p
    (>= P, the last group's overhang) maps to the all-ones bound, whose
    slice can only contain sentinels.
    """
    p = p.astype(jnp.uint32)
    P = jnp.uint32(partitions)
    bucket = (p * jnp.uint32(65536) + (P - 1)) // P  # ceil, < 2^16 for p < P
    return jnp.where(p >= P, jnp.uint32(0xFFFFFFFF), bucket << 16)


@functools.partial(
    jax.jit, static_argnames=("partitions", "group_size", "cap_bp")
)
def extract_partition_range(
    hi: jnp.ndarray, lo: jnp.ndarray, group: jnp.ndarray, *,
    partitions: int, group_size: int, cap_bp: int
):
    """Extract partitions [group*group_size, (group+1)*group_size) from one
    batch under the RANGE scheme.

    The sort key is the 32-bit partition hash itself (one key lane; the two
    key-value lanes ride as payload), so consecutive partitions come out as
    adjacent runs regardless of group width -- group_size is a memory
    decision, not a bit-packing one.  ``group`` is traced: one executable
    serves every pass.  Returns (hi [G, cap_bp], lo [G, cap_bp],
    overflows [G]) with non-members masked back to SENTINEL.

    Hash 0xFFFFFFFF is clamped to 0xFFFFFFFE (same pid) so every real
    record sorts strictly before the sentinel run -- without the clamp a
    poly-A-suffix key whose hash lands exactly on all-ones could hide
    behind sentinels past the overflow probe and be dropped silently.
    """
    G = group_size
    h = _fmix32((hi * _HASH_A) ^ (lo * _HASH_B))
    keep = hi != SENTINEL
    comp = jnp.where(keep, jnp.minimum(h, jnp.uint32(0xFFFFFFFE)), SENTINEL)
    hi_m = jnp.where(keep, hi, SENTINEL)
    lo_m = jnp.where(keep, lo, SENTINEL)
    comp_s, hi_s, lo_s = lax.sort((comp, hi_m, lo_m), num_keys=1)
    n = comp_s.shape[0]
    p0 = group.astype(jnp.uint32) * jnp.uint32(G)
    pids = p0 + jnp.arange(G, dtype=jnp.uint32)
    bounds = jnp.searchsorted(
        comp_s, _range_lower_bound(pids, partitions), side="left"
    ).astype(jnp.int32)
    P = jnp.uint32(partitions)

    def member(comp_v, hi_v, pid):
        dec = ((comp_v >> 16) * P) >> 16
        return (dec == pid) & (hi_v != SENTINEL)

    his, los, ovfs = [], [], []
    for r in range(G):
        start = jnp.clip(bounds[r], 0, n - cap_bp) if cap_bp <= n else 0
        chi = lax.dynamic_slice_in_dim(hi_s, start, cap_bp)
        clo = lax.dynamic_slice_in_dim(lo_s, start, cap_bp)
        ccomp = lax.dynamic_slice_in_dim(comp_s, start, cap_bp)
        m = member(ccomp, chi, pids[r])
        his.append(jnp.where(m, chi, SENTINEL))
        los.append(jnp.where(m, clo, SENTINEL))
        probe = jnp.clip(bounds[r] + cap_bp, 0, n - 1)
        ovfs.append(
            member(comp_s[probe], hi_s[probe], pids[r])
            & (bounds[r] + cap_bp < n)
        )
    return jnp.stack(his), jnp.stack(los), jnp.stack(ovfs)


@functools.partial(
    jax.jit, static_argnames=("partitions", "group_size", "cap_bp")
)
def extract_partition_range3(
    hi: jnp.ndarray, lo: jnp.ndarray, pay: jnp.ndarray, group: jnp.ndarray, *,
    partitions: int, group_size: int, cap_bp: int
):
    """Payload-carrying variant of :func:`extract_partition_range`.

    Same hash-keyed range extraction with a third uint32 payload lane
    riding through the sort (the out-of-core LINK builder's records carry
    side|state ids).  Group width is a memory decision, not a spare-bit
    one -- see extract_partition_range.  Returns (hi [G, cap_bp], lo,
    pay, overflows [G]); non-members are masked back to SENTINEL in all
    three lanes.
    """
    G = group_size
    h = _fmix32((hi * _LINK_A) ^ (lo * _LINK_B))
    keep = hi != SENTINEL
    comp = jnp.where(keep, jnp.minimum(h, jnp.uint32(0xFFFFFFFE)), SENTINEL)
    hi_m = jnp.where(keep, hi, SENTINEL)
    lo_m = jnp.where(keep, lo, SENTINEL)
    pay_m = jnp.where(keep, pay, SENTINEL)
    comp_s, hi_s, lo_s, pay_s = lax.sort(
        (comp, hi_m, lo_m, pay_m), num_keys=1
    )
    n = comp_s.shape[0]
    p0 = group.astype(jnp.uint32) * jnp.uint32(G)
    pids = p0 + jnp.arange(G, dtype=jnp.uint32)
    bounds = jnp.searchsorted(
        comp_s, _range_lower_bound(pids, partitions), side="left"
    ).astype(jnp.int32)
    P = jnp.uint32(partitions)

    def member(comp_v, hi_v, pid):
        dec = ((comp_v >> 16) * P) >> 16
        return (dec == pid) & (hi_v != SENTINEL)

    his, los, pays, ovfs = [], [], [], []
    for r in range(G):
        start = jnp.clip(bounds[r], 0, n - cap_bp) if cap_bp <= n else 0
        chi = lax.dynamic_slice_in_dim(hi_s, start, cap_bp)
        clo = lax.dynamic_slice_in_dim(lo_s, start, cap_bp)
        cpay = lax.dynamic_slice_in_dim(pay_s, start, cap_bp)
        ccomp = lax.dynamic_slice_in_dim(comp_s, start, cap_bp)
        mem = member(ccomp, chi, pids[r])
        his.append(jnp.where(mem, chi, SENTINEL))
        los.append(jnp.where(mem, clo, SENTINEL))
        pays.append(jnp.where(mem, cpay, SENTINEL))
        probe = jnp.clip(bounds[r] + cap_bp, 0, n - 1)
        ovfs.append(
            member(comp_s[probe], hi_s[probe], pids[r])
            & (bounds[r] + cap_bp < n)
        )
    return jnp.stack(his), jnp.stack(los), jnp.stack(pays), jnp.stack(ovfs)


@jax.jit
def _compact_rows2(hi, lo):
    """Sort one extracted 2-lane slice so real records lead + their count.

    Real keys' hi lane is < SENTINEL (packed keys carry <= 30 bits in
    hi), so a single hi-keyed sort pushes sentinel padding to the back
    and the host reads back exactly n_real rows.
    """
    hi_s, lo_s = lax.sort((hi, lo), num_keys=1)
    return hi_s, lo_s, jnp.sum(hi != SENTINEL)


def _reextract_partition2(
    batch_keys, n_batches: int, p: int, *,
    partitions: int, cap0: int, batch_slots: int,
):
    """Re-extract ONE partition whose statistical staging cap overflowed.

    Same self-healing contract as ops/dbg._reextract_partition3 but for
    the 2-lane count records: sweep the batches again extracting only
    partition ``p`` with a doubled cap, escalating until clean (cap >=
    batch_slots cannot overflow).  Called by partitioned_count instead of
    surfacing a fatal overflow after a multi-hour chromosome-scale pass.
    Device memory is bounded at one batch's extraction: each slice is
    compacted on device and read back at its true size (a device-resident
    n_batches x cap staging OOM'd at chr1 scale -- see
    _reextract_partition3).
    """
    import logging

    cap = cap0
    while True:
        cap = min(batch_slots, max(2 * cap, 1024))
        logging.getLogger(__name__).warning(
            "count partition %d overflowed its staging cap; re-extracting "
            "alone at cap=%d", p, cap,
        )
        hs, ls = [], []
        overflowed = False
        for b in range(n_batches):
            hi, lo = batch_keys(b)
            ghi, glo, ovf = extract_partition_range(
                hi, lo, jnp.uint32(p),
                partitions=partitions, group_size=1, cap_bp=cap,
            )
            del hi, lo
            hi_s, lo_s, n_real = _compact_rows2(ghi[0], glo[0])
            del ghi, glo
            if bool(ovf[0]):
                overflowed = True
                break
            ne = int(n_real)  # hard sync; batch temporaries now dead
            hs.append(np.asarray(hi_s[:ne]))
            ls.append(np.asarray(lo_s[:ne]))
            del hi_s, lo_s
        if not overflowed or cap >= batch_slots:
            return (
                jnp.asarray(np.concatenate(hs)),
                jnp.asarray(np.concatenate(ls)),
            )
        hs = ls = None  # free before the next escalation


def range_group_plan(
    n_units: int, unit_records: int, *, partitions: int,
    bytes_per_record: int, budget_bytes: int = 6 << 30,
    group_size: int | None = None, sigma_scale: float = 1.0,
):
    """Shared (cap_bp, group_size) sizing for range-scheme extractions.

    cap_bp is statistical (mean + 8 sigma + 64 over the worst-balanced
    partition); group_size fits `units x cap_bp x bytes` staging per
    partition into the budget, clamped to [1, MAX_GROUP, partitions].

    sigma_scale inflates the deviation term for CLUSTERED records: keys
    arriving in same-partition groups of multiplicity <= M have
    sqrt(M)-larger per-partition count deviation than independent
    records (the link builders' boundary keys join in groups of <= 8,
    measured to overflow the plain-sigma cap at chr1 scale).
    """
    mean = unit_records * np.ceil(65536 / partitions) / 65536
    cap_bp = min(
        unit_records,
        int(np.ceil(mean + 8.0 * sigma_scale * np.sqrt(mean))) + 64,
    )
    if group_size is None:
        staged = max(1, n_units * cap_bp * bytes_per_record)
        group_size = int(max(1, min(MAX_GROUP, budget_bytes // staged)))
    return cap_bp, min(group_size, partitions)


@functools.partial(
    jax.jit, static_argnames=("partitions", "group_size", "cap_bp")
)
def extract_partition_range5(
    mmer: jnp.ndarray,
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    rid: jnp.ndarray,
    stream: jnp.ndarray,
    group: jnp.ndarray,
    *,
    partitions: int,
    group_size: int,
    cap_bp: int,
):
    """Five-lane (parity-record) RANGE extraction.

    The partition hash covers the full (mmer, kmer) group key (the
    reference groups by signature bin AND k-mer, SURVEY.md 2.1.4); the
    group is a contiguous hash interval, so one 1-key sort lays out any
    number of consecutive partitions -- width from staging memory, not
    the mmer lane's spare bits.  Returns ([G, cap_bp] x 5,
    overflows [G]).
    """
    G = group_size
    h = _fmix32(
        (mmer * _HASH_A) ^ (khi * _HASH_B) ^ (klo * jnp.uint32(0x9E3779B9))
    )
    keep = mmer != SENTINEL
    comp = jnp.where(keep, jnp.minimum(h, jnp.uint32(0xFFFFFFFE)), SENTINEL)
    lanes_m = [
        jnp.where(keep, x, SENTINEL) for x in (mmer, khi, klo, rid, stream)
    ]
    sorted_all = lax.sort((comp, *lanes_m), num_keys=1)
    comp_s, lanes_s = sorted_all[0], sorted_all[1:]
    n = comp_s.shape[0]
    p0 = group.astype(jnp.uint32) * jnp.uint32(G)
    pids = p0 + jnp.arange(G, dtype=jnp.uint32)
    bounds = jnp.searchsorted(
        comp_s, _range_lower_bound(pids, partitions), side="left"
    ).astype(jnp.int32)
    P = jnp.uint32(partitions)

    def member(comp_v, m_v, pid):
        dec = ((comp_v >> 16) * P) >> 16
        return (dec == pid) & (m_v != SENTINEL)

    outs = ([], [], [], [], [])
    ovfs = []
    for r in range(G):
        start = jnp.clip(bounds[r], 0, n - cap_bp) if cap_bp <= n else 0
        ccomp = lax.dynamic_slice_in_dim(comp_s, start, cap_bp)
        cl = [lax.dynamic_slice_in_dim(x, start, cap_bp) for x in lanes_s]
        mem = member(ccomp, cl[0], pids[r])
        for j in range(5):
            outs[j].append(jnp.where(mem, cl[j], SENTINEL))
        probe = jnp.clip(bounds[r] + cap_bp, 0, n - 1)
        ovfs.append(
            member(comp_s[probe], lanes_s[0][probe], pids[r])
            & (bounds[r] + cap_bp < n)
        )
    return tuple(jnp.stack(o) for o in outs) + (jnp.stack(ovfs),)


@functools.partial(jax.jit, static_argnames=("cutoff",))
def _count_parity_partition(mmer, khi, klo, rid, stream, *, cutoff):
    """Sort one partition's parity records and compute group structure.

    Groups are complete (all records of a (mmer, kmer) share its hash), so
    counts and the prune mask have their global meaning.  The stable
    4-key sort keeps each group's payload in stream order, matching
    count_and_prune's contract for the replay engine.
    """
    from genome_assembly_tpu.ops.count import group_counts

    mmer_s, khi_s, klo_s, str_s, rid_s = lax.sort(
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
    return mmer_s, khi_s, klo_s, rid_s, str_s, valid_s, group_start, count, keep


def partitioned_count_parity(
    batch_records: Callable[[int], tuple],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    slack: float | None = None,
    group_size: int | None = None,
    group_budget_bytes: int = 8 << 30,
    checkpoint_dir: str | None = None,
    with_streams: bool = False,
    dataset_tag: str | None = None,
):
    """Out-of-core PARITY counting: the payload-carrying analogue of
    :func:`partitioned_count`.

    dataset_tag: as in :func:`partitioned_count` (fingerprints the read
    SOURCE, not just the batch geometry).

    batch_records(i) -> (mmer, khi, klo, rid, stream) flat uint32 lanes for
    batch i (SENTINEL mmer = invalid), regenerated per group pass
    (ceil(P/G) scans per batch; G from the staging budget, see
    extract_partition_range5).  Returns a parity HostTable
    (genome_assembly_tpu.parity.table.HostTable) holding every group
    (cutoff -1; the replay engine prunes with the reference's own
    semantics) or only surviving groups (cutoff >= 0), in global
    first-seen order -- plus (n_windows, batch_overflows).

    Replay-order correctness: each group's first_seen stream index is
    global, so ordering across partitions is exactly the reference's
    insertion order regardless of which pass counted the group.

    checkpoint_dir: per-partition group checkpoints (part_<p>_parity.npz),
    resumable like the fast-mode count.

    with_streams: also return each group's per-occurrence global stream
    indices (aligned with read_ids) as a second element -- what the
    non-ACGT exception path (parity/nonacgt.py) needs to re-key dirty
    occurrences.  Checkpoints then persist the stream lane too; a resume
    from partitions saved WITHOUT streams recounts just those partitions
    (and the reverse resume works unchanged, extra lane ignored).
    """
    from genome_assembly_tpu.parity import table as table_ops

    probe = batch_records(0)
    batch_slots = int(probe[0].shape[0])
    cap_bp, G = range_group_plan(
        n_batches, batch_slots, partitions=partitions,
        bytes_per_record=20, budget_bytes=group_budget_bytes,
        group_size=group_size,
    )
    if slack is not None:  # explicit multiplicative override (tests)
        cap_bp = min(
            batch_slots,
            int(np.ceil(batch_slots / partitions * slack)) + 1,
        )

    ckpt = None
    if checkpoint_dir is not None:
        import json
        import pathlib

        ckpt = pathlib.Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        fp = {
            "format": 2,
            "scheme": "range16",
            "mode": "parity",
            "partitions": partitions,
            "cutoff": cutoff,
            "n_batches": n_batches,
            "batch_slots": batch_slots,
        }
        if dataset_tag is not None:
            fp["dataset"] = dataset_tag
        meta_path = ckpt / "meta_parity.json"
        if meta_path.exists():
            old = json.loads(meta_path.read_text())
            if old != fp:
                raise ValueError(
                    f"checkpoint_dir {ckpt} was written by a different "
                    f"parity configuration: {old} != {fp}"
                )
        else:
            meta_path.write_text(json.dumps(fp))

    g_mmer, g_hi, g_lo, g_count, g_first = [], [], [], [], []
    g_ids: list = []
    g_streams: list = []
    n_windows = 0
    batch_overflows = 0
    n_groups = (partitions + G - 1) // G

    def part_path(p):
        return ckpt / f"part_{p}_parity.npz" if ckpt is not None else None

    def part_usable(p):
        """Saved AND carrying every lane this call needs."""
        path = part_path(p)
        if path is None or not path.exists():
            return False
        if not with_streams:
            return True
        with np.load(path) as saved:
            return "flat_streams" in saved.files

    def load_part(p):
        saved = np.load(part_path(p))
        streams = saved["flat_streams"] if with_streams else None
        return (
            saved["mmer"], saved["khi"], saved["klo"], saved["count"],
            saved["first"], saved["flat_ids"], streams,
            int(saved["overflows"]),
        )

    def accumulate(mm, hi, lo, cnt, first, flat_ids, flat_streams=None):
        g_mmer.append(mm)
        g_hi.append(hi)
        g_lo.append(lo)
        g_count.append(cnt)
        g_first.append(first)
        g_ids.append(flat_ids)
        g_streams.append(flat_streams)

    for g in range(n_groups):
        group_parts = [
            p for p in range(g * G, min((g + 1) * G, partitions))
        ]
        missing = [p for p in group_parts if not part_usable(p)]
        if not missing:
            for p in group_parts:
                mm, hi, lo, cnt, first, flat, strm, bo = load_part(p)
                accumulate(mm, hi, lo, cnt, first, flat, strm)
                batch_overflows += bo
            if g == 0 and ckpt is not None:
                # the window count was taken during group 0's live pass
                n_windows += int(np.load(ckpt / "windows_parity.npy"))
            continue

        staged = [([], [], [], [], []) for _ in range(G)]
        ovf_dev = jnp.zeros((G,), jnp.int32)
        # uint32 accumulator (x64 is disabled): good to 4.29G windows,
        # i.e. any single-host parity run
        win_dev = jnp.zeros((), jnp.uint32)
        for b in range(n_batches):
            mm, hi, lo, rid, stream = batch_records(b)
            if g == 0:
                win_dev = win_dev + jnp.sum(mm != SENTINEL, dtype=jnp.uint32)
            gm, gh, gl, gr, gs, ovf = extract_partition_range5(
                mm, hi, lo, rid, stream, jnp.uint32(g),
                partitions=partitions, group_size=G, cap_bp=cap_bp,
            )
            for r in range(G):
                staged[r][0].append(gm[r])
                staged[r][1].append(gh[r])
                staged[r][2].append(gl[r])
                staged[r][3].append(gr[r])
                staged[r][4].append(gs[r])
            ovf_dev = ovf_dev + ovf.astype(jnp.int32)
        group_overflows = np.asarray(ovf_dev)
        if g == 0:
            n_windows += int(win_dev)
            if ckpt is not None:
                np.save(ckpt / "windows_parity.npy", np.int64(n_windows))

        for r in range(G):
            p = g * G + r
            if p >= partitions:
                continue
            if part_usable(p):
                mm, hi, lo, cnt, first, flat, strm, bo = load_part(p)
                accumulate(mm, hi, lo, cnt, first, flat, strm)
                batch_overflows += bo
                continue
            pass_overflows = int(group_overflows[r])
            batch_overflows += pass_overflows
            lanes = [jnp.concatenate(staged[r][j]) for j in range(5)]
            staged[r] = None
            sorted_lanes = _count_parity_partition(*lanes, cutoff=cutoff)
            del lanes
            # host-side group slicing (same layout as table.extract_groups)
            mmer_h = np.asarray(sorted_lanes[0])
            khi_h = np.asarray(sorted_lanes[1])
            klo_h = np.asarray(sorted_lanes[2])
            rid_h = np.asarray(sorted_lanes[3])
            str_h = np.asarray(sorted_lanes[4])
            valid_h = np.asarray(sorted_lanes[5])
            gs_h = np.asarray(sorted_lanes[6])
            cnt_h = np.asarray(sorted_lanes[7])
            keep_h = np.asarray(sorted_lanes[8])
            del sorted_lanes
            starts = np.flatnonzero(keep_h if cutoff >= 0 else (gs_h & valid_h))
            sizes = cnt_h[starts].astype(np.int64)
            off = np.zeros(len(starts) + 1, dtype=np.int64)
            np.cumsum(sizes, out=off[1:])
            flat = np.empty(off[-1], dtype=np.uint32)
            for i, (s, c) in enumerate(zip(starts, sizes)):
                flat[off[i] : off[i + 1]] = rid_h[s : s + c]
            flat_strm = None
            if with_streams:
                # the stream lane rides the same stable sort as read ids,
                # so the identical slicing yields per-occurrence streams
                flat_strm = np.empty(off[-1], dtype=np.uint32)
                for i, (s, c) in enumerate(zip(starts, sizes)):
                    flat_strm[off[i] : off[i + 1]] = str_h[s : s + c]
            accumulate(
                mmer_h[starts], khi_h[starts], klo_h[starts],
                cnt_h[starts].astype(np.int32), str_h[starts], flat,
                flat_strm,
            )
            if ckpt is not None:
                tmp = ckpt / f"part_{p}_parity.tmp.npz"
                extra = (
                    {"flat_streams": flat_strm} if with_streams else {}
                )
                np.savez_compressed(
                    tmp,
                    mmer=g_mmer[-1], khi=g_hi[-1], klo=g_lo[-1],
                    count=g_count[-1], first=g_first[-1], flat_ids=flat,
                    overflows=np.int64(pass_overflows),
                    **extra,
                )
                tmp.rename(part_path(p))

    # merge partitions in global first-seen order
    mmer_all = np.concatenate(g_mmer) if g_mmer else np.zeros(0, np.uint32)
    hi_all = np.concatenate(g_hi) if g_hi else np.zeros(0, np.uint32)
    lo_all = np.concatenate(g_lo) if g_lo else np.zeros(0, np.uint32)
    cnt_all = np.concatenate(g_count) if g_count else np.zeros(0, np.int32)
    first_all = np.concatenate(g_first) if g_first else np.zeros(0, np.uint32)
    sizes_all = cnt_all.astype(np.int64)
    off_all = np.zeros(len(cnt_all) + 1, dtype=np.int64)
    np.cumsum(sizes_all, out=off_all[1:])
    flat_all = (
        np.concatenate(g_ids) if g_ids else np.zeros(0, np.uint32)
    )
    order = np.argsort(first_all, kind="stable")
    read_ids = [
        flat_all[off_all[i] : off_all[i + 1]].astype(np.uint32) for i in order
    ]
    host = table_ops.HostTable(
        mmer=mmer_all[order],
        kmer_hi=hi_all[order],
        kmer_lo=lo_all[order],
        count=cnt_all[order],
        first_seen=first_all[order],
        read_ids=read_ids,
    )
    if with_streams:
        flat_strm_all = (
            np.concatenate(g_streams)
            if g_streams else np.zeros(0, np.uint32)
        )
        streams = [
            flat_strm_all[off_all[i] : off_all[i + 1]].astype(np.uint32)
            for i in order
        ]
        return host, streams, n_windows, batch_overflows
    return host, n_windows, batch_overflows


class PartitionedCount(NamedTuple):
    """Union of per-partition pruned keys (unordered across partitions).

    With ``return_host=True`` the three arrays are host numpy (the keys
    were already hosted per partition during the passes, so this avoids
    BOTH the final whole-array upload and any later readback when the
    link builder runs in host-parked mode)."""

    kmer_hi: jnp.ndarray  # [n_kept] kept canonical keys (exact size: each
    kmer_lo: jnp.ndarray  # partition is trimmed to its true kept count)
    valid: jnp.ndarray
    n_distinct: int
    n_kept: int
    batch_overflows: int  # nonzero => raise slack
    kept_overflow: bool  # total kept keys exceeded kept_cap (global test)
    group_size: int = 3  # partitions extracted per re-scan pass (chosen
    # from the staging budget; passes = ceil(partitions / group_size))
    partitions: int = 0  # actual partition count (auto-sized paths pick
    # their own; 0 = caller's request stands)


def partitioned_count(
    batch_keys: Callable[[int], Tuple[jnp.ndarray, jnp.ndarray]],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    kept_cap: int,
    slack: float | None = None,
    group_size: int | None = None,
    group_budget_bytes: int = 8 << 30,
    checkpoint_dir: str | None = None,
    return_host: bool = False,
    scan_chunk: int = 1,
    only_partitions: tuple | None = None,
    on_progress: Callable[[int, int, int, int], None] | None = None,
    dataset_tag: str | None = None,
) -> PartitionedCount:
    """Count n_batches record batches in ceil(P/G) re-scan passes.

    dataset_tag: opaque caller string folded into the checkpoint
    fingerprint (omitted from it when None, so older tag-less dirs stay
    valid).  Callers whose batch CONTENT can vary under identical
    (n_batches, batch_slots) -- e.g. run_scale's virtual vs materialized
    genome reads -- must tag, or a resume would silently mix datasets.

    on_progress(group, n_groups, batches_dispatched, n_batches) fires
    after each extraction dispatch.  Dispatch is asynchronous, so this
    reports how far the DISPATCH stream has advanced, not device
    completion -- still the only liveness signal a chromosome-scale
    pass (6,867 silent batches at humanchr) otherwise lacks.

    batch_keys(i) -> (hi, lo) flat uint32 key lanes for batch i (invalid =
    SENTINEL); called once per pass per batch, so it should be a cheap
    jitted regeneration (device read simulation, or a re-streamed file
    read).

    scan_chunk > 1 fuses that many consecutive batches into ONE dispatch
    (a lax.scan over the batch index inside a single jit).  The per-batch
    compute is one record sort, so a chromosome-scale pass (chr1: 6,867
    batches/pass) is many small dispatches; fusing 16-32 batches
    amortizes the per-dispatch host cost.  Requires batch_keys to
    be TRACEABLE with a traced batch index (a jitted device simulation
    is; a host-side file reader is not -- keep scan_chunk=1 there).
    Results are bit-identical either way: the same records land in the
    same partitions in the same batch order.  Each pass extracts a GROUP of G consecutive RANGE partitions
    (extract_partition_range) -- G is a staging-memory decision:

      G = clamp(group_budget_bytes // (n_batches * cap_bp * 8), 1, 16)

    so the pass count is ~ total_record_bytes / group_budget_bytes rather
    than P/3 (the old tag-folding bound).  ``group_size`` overrides.

    cap_bp (staged slots per batch per partition) is sized statistically
    by default: mean + 8*sqrt(mean) + 64 over the worst-balanced partition
    (range buckets are 16-bit granular), which replaces the old flat 1.6x
    -- at chromosome scale the multiplicative slack was pure staging waste.
    Pass ``slack`` to force the multiplicative form.  Overflow stays
    exactly detected (the slice-boundary probe), never silent.

    checkpoint_dir: if given, each completed partition's kept keys land in
    ``part_<p>.npz`` there and are skipped on re-run -- a killed
    chromosome-scale job resumes at its last finished pass (the elasticity
    model of SURVEY.md 5.3/5.4: passes are idempotent and independent).
    Partition contents depend only on (partitions, cutoff, dataset), NOT
    on G or cap_bp, so checkpoints survive group/staging retuning; a
    partition saved with recorded overflow is recounted, not reused.

    only_partitions=(lo, hi): count ONLY partitions in [lo, hi) -- the
    multi-host division of SCALE.md section 2 made executable.  Requires
    checkpoint_dir (results flow through the shared part_<p>.npz format:
    each host banks its range, and a final rangeless call merges every
    partition with ZERO re-scans).  Groups with no owned partition are
    skipped entirely; a group straddling the range boundary stages its
    whole group in one pass but counts/saves only the owned partitions.
    The returned arrays cover only the owned range.

    Each partition's kept keys are trimmed to their TRUE count on the host
    before accumulation (no per-partition padding), so hash skew between
    partitions cannot fake an overflow and the returned arrays are exactly
    n_kept long -- downstream link-building sorts see no dead rows.
    kept_overflow is a single global test (n_kept > kept_cap).
    """
    probe_hi, probe_lo = batch_keys(0)
    batch_slots = int(probe_hi.shape[0])
    if slack is not None:
        cap_bp = min(
            batch_slots,
            int(np.ceil(batch_slots / partitions * slack)) + 1,
        )
    else:
        # worst-balanced partition owns ceil(65536/P) 16-bit hash buckets
        mean = batch_slots * np.ceil(65536 / partitions) / 65536
        cap_bp = min(
            batch_slots, int(np.ceil(mean + 8.0 * np.sqrt(mean))) + 64
        )
    if group_size is None:
        group_size = int(
            max(1, min(MAX_GROUP, group_budget_bytes // (n_batches * cap_bp * 8)))
        )
    group_size = min(group_size, partitions)

    ckpt = None
    if checkpoint_dir is not None:
        import json
        import pathlib

        ckpt = pathlib.Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        # fingerprint: partition checkpoints are only valid for the exact
        # run parameters (a different partition count remaps every key).
        # "format": 5 = range partition scheme with fmix32-diffused
        # partition hashes (the raw two-lane combine banded the link
        # partitions under count-partition-ordered input; partition
        # contents depend on the hash, so older checkpoints must not
        # resume); group width and staging
        # caps do not affect partition contents and are not fingerprinted
        # (overflowed partitions are recounted on load instead).
        fp = {
            "format": 5,
            "scheme": "range16",
            "partitions": partitions,
            "cutoff": cutoff,
            "n_batches": n_batches,
            "batch_slots": batch_slots,
        }
        if dataset_tag is not None:
            fp["dataset"] = dataset_tag
        meta_path = ckpt / "meta.json"
        if meta_path.exists():
            old = json.loads(meta_path.read_text())
            if old != fp:
                raise ValueError(
                    f"checkpoint_dir {ckpt} was written by a different "
                    f"configuration: {old} != {fp}; use a fresh directory"
                )
        else:
            meta_path.write_text(json.dumps(fp))

    def part_usable(p):
        """A checkpoint is reusable only if its pass saw no overflow."""
        path = ckpt / f"part_{p}.npz"
        if not path.exists():
            return False
        return int(np.load(path)["batch_overflows"]) == 0

    def load_part(p):
        saved = np.load(ckpt / f"part_{p}.npz")
        return (
            saved["khi"],
            saved["klo"],
            int(saved["n_distinct"]),
            int(saved["n_kept"]),
            int(saved["batch_overflows"]),
        )

    khi_parts, klo_parts = [], []
    n_distinct = 0
    n_kept = 0
    batch_overflows = 0
    G = group_size
    scan_chunk = max(1, min(scan_chunk, n_batches))
    if scan_chunk > 1:
        # Defined ONCE (outside the group loop) so there are at most two
        # compiles: the full chunk and the tail.  b0 and g are traced.
        @functools.partial(jax.jit, static_argnames=("n_scan",))
        def _fused_extract(b0, g, *, n_scan):
            def body(carry, i):
                hi, lo = batch_keys(b0 + i)
                ghi, glo, ovf = extract_partition_range(
                    hi, lo, g,
                    partitions=partitions, group_size=G, cap_bp=cap_bp,
                )
                return carry, (ghi, glo, ovf.astype(jnp.int32))

            _, (ghis, glos, ovfs) = lax.scan(
                body, 0, jnp.arange(n_scan, dtype=jnp.int32)
            )
            return ghis, glos, jnp.sum(ovfs, axis=0)

    if only_partitions is not None:
        if ckpt is None:
            raise ValueError(
                "only_partitions requires checkpoint_dir (partition "
                "results flow through the shared part_<p>.npz files)"
            )
        own_lo, own_hi = int(only_partitions[0]), int(only_partitions[1])
        if own_lo >= min(own_hi, partitions):
            raise ValueError(
                f"only_partitions=({own_lo}, {own_hi}) owns nothing: the "
                f"run has {partitions} partitions (auto-sized; check the "
                "worker's range against the merge run's partition count)"
            )
    n_groups = (partitions + G - 1) // G
    for g in range(n_groups):
        group_parts = [
            p for p in range(g * G, min((g + 1) * G, partitions))
        ]
        if only_partitions is not None:
            group_parts = [
                p for p in group_parts if own_lo <= p < own_hi
            ]
            if not group_parts:
                continue
        owned = set(group_parts)
        missing = [
            p for p in group_parts if ckpt is None or not part_usable(p)
        ]
        if not missing:
            for p in group_parts:
                khi, klo, nd, nk, bo = load_part(p)
                khi_parts.append(khi)
                klo_parts.append(klo)
                n_distinct += nd
                n_kept += nk
                batch_overflows += bo
            continue

        # one re-scan serves the whole group: G partition runs per
        # batch sort, accumulated separately
        pieces_hi = [[] for _ in range(G)]
        pieces_lo = [[] for _ in range(G)]
        # accumulate overflow on device; ONE readback per group (a
        # per-batch int() would stall the dispatch pipeline)
        ovf_dev = jnp.zeros((G,), jnp.int32)
        if scan_chunk > 1:
            b = 0
            while b < n_batches:
                n_scan = min(scan_chunk, n_batches - b)
                ghis, glos, ovf = _fused_extract(
                    np.int32(b), np.uint32(g), n_scan=n_scan
                )
                for r in range(G):
                    pieces_hi[r].append(ghis[:, r].reshape(-1))
                    pieces_lo[r].append(glos[:, r].reshape(-1))
                del ghis, glos  # free the stacked staging copy
                ovf_dev = ovf_dev + ovf
                b += n_scan
                if on_progress is not None:
                    on_progress(g, n_groups, b, n_batches)
        else:
            for b in range(n_batches):
                hi, lo = batch_keys(b)
                ghi, glo, ovf = extract_partition_range(
                    hi, lo, jnp.uint32(g),
                    partitions=partitions, group_size=G, cap_bp=cap_bp,
                )
                for r in range(G):
                    pieces_hi[r].append(ghi[r])
                    pieces_lo[r].append(glo[r])
                ovf_dev = ovf_dev + ovf.astype(jnp.int32)
                if on_progress is not None:
                    on_progress(g, n_groups, b + 1, n_batches)
        group_overflows = np.asarray(ovf_dev)

        def count_partition(p, cat_hi, cat_lo, pass_overflows):
            nonlocal n_distinct, n_kept, batch_overflows
            batch_overflows += pass_overflows
            recs = WindowRecords(
                mmer=jnp.zeros((0,), jnp.uint32),
                kmer_hi=cat_hi,
                kmer_lo=cat_lo,
                valid=cat_hi != SENTINEL,
            )
            kc = count_ops.count_keys(recs, cutoff=cutoff)
            del recs, cat_hi, cat_lo  # kc's sorted copies supersede these
            n_distinct_p = int(jnp.sum(kc.group_start & kc.valid))
            n_distinct += n_distinct_p
            n_kept_p = int(jnp.sum(kc.keep))
            n_kept += n_kept_p
            khi, klo, _ = count_ops.kept_keys_sorted(kc)
            del kc
            # trim to the partition's TRUE kept count (kept keys are
            # compacted to the front) and park on the host: no padding can
            # reach the final concatenation, and the device frees this
            # pass's arrays before the next group's staging begins
            khi_parts.append(np.asarray(khi[:n_kept_p]))
            klo_parts.append(np.asarray(klo[:n_kept_p]))
            if ckpt is not None:
                # savez appends ".npz" unless the name already ends with it
                tmp = ckpt / f"part_{p}.tmp.npz"
                np.savez_compressed(
                    tmp,
                    khi=khi_parts[-1],
                    klo=klo_parts[-1],
                    n_distinct=np.int64(n_distinct_p),
                    n_kept=np.int64(n_kept_p),
                    batch_overflows=np.int64(pass_overflows),
                )
                tmp.rename(ckpt / f"part_{p}.npz")

        overflowed = []
        for r in range(G):
            p = g * G + r
            if p >= partitions or p not in owned:
                pieces_hi[r] = pieces_lo[r] = None
                continue
            if ckpt is not None and part_usable(p):
                pieces_hi[r] = pieces_lo[r] = None
                khi, klo, nd, nk, bo = load_part(p)
                khi_parts.append(khi)
                klo_parts.append(klo)
                n_distinct += nd
                n_kept += nk
                batch_overflows += bo
                continue
            pass_overflows = int(group_overflows[r])
            if slack is None and pass_overflows:
                # statistical cap missed this partition: its staged records
                # are incomplete, so counting them would be silently wrong.
                # Queue a single-partition re-extraction with an escalated
                # cap (after the group's clean partitions free their
                # staging) instead of surfacing a fatal overflow after
                # hours of chromosome-scale passes.
                pieces_hi[r] = pieces_lo[r] = None
                overflowed.append(p)
                continue
            cat_hi = jnp.concatenate(pieces_hi[r])
            cat_lo = jnp.concatenate(pieces_lo[r])
            pieces_hi[r] = pieces_lo[r] = None  # free staging before count
            count_partition(p, cat_hi, cat_lo, pass_overflows)
        for p in overflowed:
            cat_hi, cat_lo = _reextract_partition2(
                batch_keys, n_batches, p,
                partitions=partitions, cap0=cap_bp,
                batch_slots=batch_slots,
            )
            count_partition(p, cat_hi, cat_lo, 0)

    kmer_hi = np.concatenate([np.asarray(a, dtype=np.uint32) for a in khi_parts])
    kmer_lo = np.concatenate([np.asarray(a, dtype=np.uint32) for a in klo_parts])
    if not return_host:
        kmer_hi = jnp.asarray(kmer_hi)
        kmer_lo = jnp.asarray(kmer_lo)
    valid = kmer_hi != SENTINEL
    return PartitionedCount(
        kmer_hi=kmer_hi,
        kmer_lo=kmer_lo,
        valid=valid,
        n_distinct=n_distinct,
        n_kept=n_kept,
        batch_overflows=batch_overflows,
        kept_overflow=n_kept > kept_cap,
        group_size=G,
        partitions=partitions,
    )


# ---------------------------------------------------------------------------
# Super-k-mer staging (ops/superkmer.py): compressed out-of-core counting.

SUPER_MAX_GROUP = 128  # the gather-form extractor's group width is memory-
# bound, not compile-bound (one row gather serves any G), so the cap is a
# sanity rail only


@functools.partial(
    jax.jit, static_argnames=("partitions", "group_size", "cap_bp")
)
def extract_partition_range_super(
    mm, slen, b0, b1, b2, b3, p_start, *,
    partitions: int, group_size: int, cap_bp: int
):
    """RANGE extraction of super-k-mer records, partitioned by MINIMIZER.

    All of a canonical k-mer's occurrences share its minimizer (fast_scan's
    minimizer is a function of the window bases), so hashing the mmer lane
    keeps k-mer groups complete per partition -- the KMC signature
    argument.  Unlike the key extractors, this one sorts only (hash,
    position) and fetches records with ONE row gather, so group width is
    a pure memory decision.

    p_start: FIRST partition id of the group (traced scalar; ragged
    groups start anywhere), or a [group_size] ARRAY of arbitrary
    partition ids (similar-load packing -- each pid slices its own hash
    interval, so nothing requires consecutive ids).  pids past
    ``partitions`` never match any record hash, so tail padding and
    narrow groups are inert.

    Returns ([G, cap_bp] x 6 lanes, overflows [G]).
    """
    G = group_size
    n = mm.shape[0]
    h = _fmix32((mm * _HASH_A) ^ (mm * _HASH_B))
    keep = mm != SENTINEL
    comp = jnp.where(keep, jnp.minimum(h, jnp.uint32(0xFFFFFFFE)), SENTINEL)
    pos = jnp.arange(n, dtype=jnp.int32)
    comp_s, pos_s = lax.sort((comp, pos), num_keys=1)
    rows = jnp.stack([mm, slen, b0, b1, b2, b3], axis=1)  # [n, 6]
    p_start = jnp.asarray(p_start)
    if p_start.ndim:
        pids = p_start.astype(jnp.uint32)
    else:
        pids = p_start.astype(jnp.uint32) + jnp.arange(G, dtype=jnp.uint32)
    bounds = jnp.searchsorted(
        comp_s, _range_lower_bound(pids, partitions), side="left"
    ).astype(jnp.int32)
    starts = jnp.clip(bounds, 0, max(n - cap_bp, 0))
    idx = starts[:, None] + jnp.arange(cap_bp, dtype=jnp.int32)[None, :]
    comp_g = comp_s[idx]  # [G, cap]
    recs = rows[pos_s[idx]]  # ONE [G*cap, 6] row gather
    P = jnp.uint32(partitions)
    member = (
        (((comp_g >> 16) * P) >> 16 == pids[:, None])
        & (comp_g != SENTINEL)
    )
    outs = tuple(
        jnp.where(member, recs[..., j], SENTINEL) for j in range(6)
    )
    probe = jnp.clip(bounds + cap_bp, 0, n - 1)
    cp = comp_s[probe]
    ovf = (
        (((cp >> 16) * P) >> 16 == pids)
        & (cp != SENTINEL)
        & (bounds + cap_bp < n)
    )
    return outs + (ovf,)


@jax.jit
def _compact_super_lanes(lanes):
    """Sort real records to the front (SENTINEL rows last) and count them."""
    lanes = lax.sort(tuple(lanes), num_keys=1)
    return lanes, jnp.sum(lanes[0] != SENTINEL)


@functools.partial(
    jax.jit, static_argnames=("cutoff", "k", "m", "chunk", "n_chunks")
)
def _expand_count_super(
    lanes, *, cutoff: int, k: int, m: int, chunk: int, n_chunks: int
):
    from genome_assembly_tpu.ops import superkmer

    # slice/pad to the occupied prefix INSIDE the jit (static shapes from
    # static n_chunks): eager per-lane slices would cost 6 extra
    # dispatches per partition
    n = lanes[0].shape[0]
    eff = n_chunks * chunk
    if eff <= n:
        lanes = tuple(x[:eff] for x in lanes)
    else:
        pad = eff - n
        lanes = tuple(
            jnp.concatenate([x, jnp.full((pad,), SENTINEL, jnp.uint32)])
            for x in lanes
        )
    his, los = [], []
    for c in range(n_chunks):
        s = c * chunk
        hi, lo = superkmer.expand_records(
            *(x[s : s + chunk] for x in lanes), k=k, m=m
        )
        his.append(hi)
        los.append(lo)
    hi_all = jnp.concatenate(his)
    recs = WindowRecords(
        mmer=jnp.zeros((0,), jnp.uint32),
        kmer_hi=hi_all,
        kmer_lo=jnp.concatenate(los),
        valid=hi_all != SENTINEL,
    )
    kc = count_ops.count_keys(recs, cutoff=cutoff)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    n_distinct = jnp.sum(kc.group_start & kc.valid)
    n_kept = jnp.sum(kc.keep)
    return khi, klo, n_distinct, n_kept


def _count_super_partition(lanes, *, cutoff: int, k: int, m: int, chunk: int):
    """Expand one partition's records chunk-wise and count the windows.

    Real records are compacted to the front first (one 6-lane sort;
    SENTINEL rows sort last) and only occupied chunks expand: the staged
    layout is n_batches x cap_bp slots and mostly sentinels under skewed
    caps, so expanding it raw multiplies the EMPTY slots by S_CAP too --
    6,867 batches x cap x 25 x 8 B is a 13.7 GB expansion buffer at
    humanchr scale.  The
    occupied chunk count rounds up to a power of two so the expansion +
    count graphs compile for O(log) distinct shapes, not one per
    partition; the per-partition n_real readback is the same single
    scalar round-trip the partition totals already pay.
    """
    n = lanes[0].shape[0]
    lanes, n_real_dev = _compact_super_lanes(tuple(lanes))
    n_real = int(n_real_dev)
    n_chunks_all = (n + chunk - 1) // chunk
    need = max(1, -(-n_real // chunk))
    n_chunks = 1
    while n_chunks < need:
        n_chunks *= 2
    n_chunks = min(n_chunks, n_chunks_all)
    from genome_assembly_tpu.ops import superkmer as _sk

    if n_chunks * chunk * _sk.S_CAP > SUB_COUNT_SLOTS:
        # HOT partition: the S_CAP-strided expansion of all chunks at
        # once would materialize records x 25 x 8 B (~13-26 GB for the
        # 3 Gbp hot minimizer partition).  Count it per
        # K-MER-HASH SUBRANGE instead: all windows of one k-mer share
        # the k-mer, so subrange counts are exact and their kept sets
        # disjoint -- the same argument that makes partitions mergeable.
        return _count_super_partition_subranges(
            tuple(lanes), cutoff=cutoff, k=k, m=m, chunk=chunk,
            n_chunks=n_chunks,
        )
    return _expand_count_super(
        tuple(lanes), cutoff=cutoff, k=k, m=m, chunk=chunk,
        n_chunks=n_chunks,
    )


SUB_COUNT_SLOTS = int(
    os.environ.get("GA_SUB_COUNT_SLOTS", 192 << 20)
)  # expanded-window slots above which a partition counts per key-hash
# subrange: a fixed budget sized so the hi+lo lanes and count-sort copies
# stay under 16 GB next to live staging.  The env override exists so a
# run can force SMALL partitions through the subrange path (the 3 Gbp
# hot partitions only appear in the last packed groups).


def _count_super_partition_subranges(
    lanes, *, cutoff: int, k: int, m: int, chunk: int, n_chunks: int
):
    """Count ONE oversized partition in key-hash subranges.

    For each subrange: every chunk expands (chunk x S_CAP slots,
    transient), windows outside the subrange mask to SENTINEL, a 2-lane
    sort compacts real windows to the front, and only a RETAIN-sized
    prefix accumulates -- so peak memory is bounded by
    ~SUB_COUNT_SLOTS regardless of the partition's true size.  A real
    window past the retain prefix marks the subrange overflowed; the
    whole partition then retries with doubled subranges (retain per
    chunk halves+margins, so escalation terminates at
    retain == chunk * S_CAP, which cannot overflow).

    The subrange hash reuses the LINK constants (independent of the
    minimizer-partition hash, common.py) over the window's canonical
    key lanes.
    """
    from genome_assembly_tpu.common import (
        LINK_HASH_A, LINK_HASH_B, fmix32 as _fmx,
    )
    from genome_assembly_tpu.ops import superkmer

    eff_slots = n_chunks * chunk * superkmer.S_CAP
    n_sub = max(2, -(-eff_slots // SUB_COUNT_SLOTS))

    @functools.partial(
        jax.jit, static_argnames=("n_sub", "sub", "retain")
    )
    def _sub_count(lanes, *, n_sub, sub, retain):
        n = lanes[0].shape[0]
        eff = n_chunks * chunk
        if eff <= n:
            lanes = tuple(x[:eff] for x in lanes)
        else:
            pad = eff - n
            lanes = tuple(
                jnp.concatenate([x, jnp.full((pad,), SENTINEL, jnp.uint32)])
                for x in lanes
            )
        his, los = [], []
        ovf = jnp.int32(0)
        for c in range(n_chunks):
            s0 = c * chunk
            hi, lo = superkmer.expand_records(
                *(x[s0 : s0 + chunk] for x in lanes), k=k, m=m
            )
            h = _fmx((hi * LINK_HASH_A) ^ (lo * LINK_HASH_B))
            in_sub = (
                ((h >> 16) * jnp.uint32(n_sub)) >> 16 == jnp.uint32(sub)
            ) & (hi != SENTINEL)
            hi = jnp.where(in_sub, hi, SENTINEL)
            lo = jnp.where(in_sub, lo, SENTINEL)
            hi, lo = lax.sort((hi, lo), num_keys=2)
            ovf = ovf + jnp.sum(
                (hi[retain:] != SENTINEL).astype(jnp.int32)
            ) if retain < hi.shape[0] else ovf
            his.append(hi[:retain])
            los.append(lo[:retain])
        hi_all = jnp.concatenate(his)
        recs = WindowRecords(
            mmer=jnp.zeros((0,), jnp.uint32),
            kmer_hi=hi_all,
            kmer_lo=jnp.concatenate(los),
            valid=hi_all != SENTINEL,
        )
        kc = count_ops.count_keys(recs, cutoff=cutoff)
        khi, klo, valid = count_ops.kept_keys_sorted(kc)
        n_distinct = jnp.sum(kc.group_start & kc.valid)
        n_kept = jnp.sum(kc.keep)
        return khi, klo, n_distinct, n_kept, ovf

    cs = chunk * superkmer.S_CAP
    mult = 1.35
    while True:
        # windows/chunk/subrange concentrate tightly (key hash is
        # uniform); margin = 1.35x + statistical floor, pow2q-bucketed
        # so escalations reuse compiled shapes where possible.  On
        # overflow the margin doubles; retain == cs cannot overflow (a
        # chunk cannot expand past cs slots), so escalation terminates.
        est = cs / n_sub
        retain = min(cs, int(np.ceil(mult * est + 8 * np.sqrt(est) + 64)))
        e = 1 << max(int(retain).bit_length() - 3, 0)
        retain = min(cs, -(-retain // e) * e)
        khi_parts, klo_parts = [], []
        nd = nk = 0
        overflowed = False
        for sub in range(n_sub):
            khi, klo, d, kcnt, ovf = _sub_count(
                lanes, n_sub=n_sub, sub=sub, retain=retain
            )
            if int(ovf):
                overflowed = True
                break
            kcnt_i = int(kcnt)
            khi_parts.append(khi[:kcnt_i])
            klo_parts.append(klo[:kcnt_i])
            nd += int(d)
            nk += kcnt_i
        if not overflowed:
            return (
                jnp.concatenate(khi_parts),
                jnp.concatenate(klo_parts),
                jnp.int32(nd),
                jnp.int32(nk),
            )
        mult *= 2.0


def _reextract_partition_super(
    batch_super, n_batches: int, p: int, *,
    partitions: int, cap0: int, batch_slots: int,
):
    """Re-extract ONE super-record partition whose staging cap overflowed.

    Same self-healing contract as _reextract_partition2 for the 6-lane
    super-k-mer records: sweep the batches extracting only partition ``p``
    with a doubled cap, escalating until clean (cap >= batch_slots cannot
    overflow).  Returns the 6 concatenated record lanes.

    Device memory is bounded at ONE batch's extraction, exactly like
    _reextract_partition2: each batch's slice is compacted on device
    (one 6-lane sort; SENTINEL rows sort last) and read back at its true
    size into host accumulators, and the sweep breaks on the first
    overflow before escalating -- a device-resident n_batches x cap
    staging pattern grows with the escalated cap
    (see _reextract_partition3's docstring).
    """
    import logging

    cap = cap0
    while True:
        cap = min(batch_slots, max(2 * cap, 1024))
        logging.getLogger(__name__).warning(
            "super count partition %d overflowed its staging cap; "
            "re-extracting alone at cap=%d", p, cap,
        )
        lanes_acc = [[] for _ in range(6)]
        overflowed = False
        for b in range(n_batches):
            lanes = batch_super(b)
            out = extract_partition_range_super(
                *lanes, jnp.uint32(p),
                partitions=partitions, group_size=1, cap_bp=cap,
            )
            del lanes
            if bool(out[6][0]):
                overflowed = True
                break
            sorted_lanes = lax.sort(
                tuple(out[j][0] for j in range(6)), num_keys=1
            )
            n_real = int(jnp.sum(sorted_lanes[0] != SENTINEL))  # hard sync
            del out
            for j in range(6):
                lanes_acc[j].append(np.asarray(sorted_lanes[j][:n_real]))
            del sorted_lanes
        if not overflowed or cap >= batch_slots:
            return tuple(
                jnp.asarray(np.concatenate(lanes_acc[j])) for j in range(6)
            )
        lanes_acc = None  # free before the next escalation


def partitioned_count_super(
    batch_super: Callable[[int], tuple],
    n_batches: int,
    *,
    k: int,
    m: int,
    partitions: int = 0,
    cutoff: int,
    kept_cap: int,
    slack: float | None = None,
    group_size: int | None = None,
    group_budget_bytes: int = 8 << 30,
    expand_slots_budget: int = 128 << 20,
    expand_chunk: int = 1 << 20,
    checkpoint_dir: str | None = None,
    return_host: bool = False,
    scan_chunk: int = 1,
    only_partitions: tuple | None = None,
    on_progress: Callable[[int, int, int, int], None] | None = None,
    dataset_tag: str | None = None,
) -> PartitionedCount:
    """Out-of-core counting over SUPER-K-MER records (ops/superkmer.py).

    dataset_tag: as in :func:`partitioned_count` (fingerprints the read
    SOURCE, not just the batch geometry).

    on_progress: as in :func:`partitioned_count` (dispatch-stream
    liveness, fired after each extraction dispatch).

    only_partitions=(lo, hi): worker form of the multi-host pass
    division, exactly as in :func:`partitioned_count` (requires
    checkpoint_dir; partitions= must be given explicitly OR the probe
    batch must be identical across workers -- it is, batch 0 is
    deterministic per dataset).

    scan_chunk > 1 fuses that many batches per dispatch exactly like
    partitioned_count (requires a traceable batch_super; results are
    bit-identical) -- the dispatch amortization matters even more
    here because super passes stage 3-4x more partitions per re-scan.

    batch_super(i) -> the 6 flat record lanes of batch i
    (superkmer.super_records output).  Staging a record costs 24 B for
    ~10 windows (k=31, m=7 measured) instead of 8 B per window, so each
    re-scan pass extracts ~3-4x more partitions within the same staging
    budget and the pass count -- the dominant out-of-core cost -- drops
    accordingly.  Partitioning hashes the MINIMIZER (all occurrences of a
    k-mer share it), and each partition expands its records back to
    windows chunk-wise on device before the normal sort-count.

    partitions=0 sizes partitions so one partition's EXPANDED window
    slots fit ``expand_slots_budget`` (the count-sort working set);
    records per batch are estimated from the probe batch.  Returns the
    same PartitionedCount as partitioned_count; kept keys across
    partitions are disjoint because a k-mer lives in exactly one
    minimizer partition.
    """
    from genome_assembly_tpu.ops import superkmer

    probe = batch_super(0)
    batch_slots = int(probe[0].shape[0])
    mm0 = np.asarray(probe[0])
    mm0 = mm0[mm0 != SENTINEL].astype(np.uint32)
    n_rec0 = int(mm0.size)
    if partitions == 0:
        total_recs = max(n_rec0 * n_batches, 1)
        per_part = max(expand_slots_budget // superkmer.S_CAP, 1)
        partitions = int(np.ceil(1.1 * total_recs / per_part))
    partitions = max(partitions, 1)
    # Record caps come from the probe batch's ACTUAL per-partition
    # histogram, not a uniform-hash model: records cluster by minimizer
    # and minimizer mass is skewed, so the worst partition's load, with a drift margin,
    # is the honest cap.  Overflow stays exactly detected regardless.
    h0 = _fmix32((mm0 * _HASH_A) ^ (mm0 * _HASH_B))
    pid0 = ((h0 >> np.uint32(16)) * np.uint32(partitions)) >> np.uint32(16)
    loads = (
        np.bincount(pid0, minlength=partitions)
        if n_rec0
        else np.ones(partitions, np.int64)
    )
    peak = max(int(loads.max()), 1)
    cap_bp = min(
        batch_slots,
        int(np.ceil(1.25 * peak + 8.0 * np.sqrt(max(peak, 1)))) + 64,
    )
    if slack is not None:
        cap_bp = min(batch_slots, int(np.ceil(peak * slack)) + 1)
    if group_size is None and slack is None:
        # RAGGED groups: minimizer mass is heavy-tailed, so ONE hot
        # partition's cap throttled every group under the uniform
        # scheme (humanchr r5: global peak ~6.9k records/batch vs mean
        # ~700 forced G=7 of 1,247 partitions -- a super pass banked
        # LESS of the count than a plain pass).  Per-partition caps
        # from the probe histogram let cold runs group wide while hot
        # partitions isolate into narrow groups; caps and widths are
        # bucketed to powers of two so the fused extraction program
        # compiles for a handful of shapes, not one per group.
        # Partition CONTENTS are grouping-independent (checkpoints
        # stay valid across retunes, as for the plain scheme).
        caps_p = np.minimum(
            batch_slots,
            np.ceil(1.25 * loads + 8.0 * np.sqrt(np.maximum(loads, 1)))
            .astype(np.int64) + 64,
        )
        def pow2(v):
            # quarter-pow2 buckets: {1, 1.25, 1.5, 1.75} x 2^e -- caps a
            # group's staging waste at 25% (a straight pow2 bucket can
            # double it, halving G) while keeping the distinct compiled
            # extraction shapes to ~4 per octave
            v = max(int(v), 1)
            e = 1 << max(v.bit_length() - 3, 0)
            return -(-v // e) * e
        # the expand+count of each partition runs while the WHOLE group's
        # staging is still device-resident: reserve its working set
        # (expanded (hi, lo) buffer + its sort copy) from the staging
        # budget (8 GB of staging plus ~4 GB of count temporaries would
        # otherwise stack up at humanchr scale)
        resv = 4 * expand_slots_budget * 8
        stage_budget = max(group_budget_bytes - resv, group_budget_bytes // 8)
        # Dispatch-level compaction (fused path only): a dispatch's
        # [n_scan, G, cap] staging block is ~90% sentinels because cap
        # is sized for the PEAK batch while typical batches carry the
        # mean.  One batched 6-lane row sort per dispatch compacts each
        # partition's slice to a mean-sized RETENTION cap, so the
        # accumulated (device-resident) staging pays mean + margin, not
        # peak -- the group width G scales up by the same ~5-8x factor.
        # Retention overflow is per-partition detected and self-heals
        # through the existing single-partition re-extraction.
        sc = max(1, min(scan_chunk, n_batches))
        # similar-load packing: partition ids are hash-ordered, so a
        # consecutive group's cap is set by its (random) hottest member.
        # Nothing in the range extraction needs consecutive ids (each
        # pid slices its own hash interval), so groups are packed from
        # the load-SORTED order -- near-uniform caps per group, ~4x
        # fewer passes at humanchr scale than consecutive packing.
        order = np.argsort(caps_p, kind="stable").astype(np.int64)
        groups = []
        lo = 0
        while lo < partitions:
            for Gb in (128, 64, 32, 16, 8, 4, 2, 1):
                if Gb > SUPER_MAX_GROUP:
                    continue
                w = min(Gb, partitions - lo)
                members = order[lo : lo + w]
                cap_g = pow2(caps_p[members].max())
                if sc > 1:
                    ml = int(loads[members].max())
                    retain_g = pow2(min(
                        sc * cap_g,
                        int(np.ceil(1.25 * sc * ml
                                    + 8.0 * np.sqrt(max(sc * ml, 1)))) + 64,
                    ))
                    per_part = -(-n_batches // sc) * retain_g * 24
                else:
                    retain_g = None
                    per_part = n_batches * cap_g * 24
                if Gb == 1 or per_part * Gb <= stage_budget:
                    width, shape_g, shape_cap = w, Gb, cap_g
                    shape_retain = retain_g
                    break
            pid_list = np.sort(order[lo : lo + width]).astype(np.uint32)
            groups.append(
                (pid_list, width, shape_g, min(shape_cap, batch_slots),
                 shape_retain)
            )
            lo += width
        G = max(g[2] for g in groups)
    else:
        if group_size is None:
            staged = max(1, n_batches * cap_bp * 24)
            group_size = int(
                max(1, min(SUPER_MAX_GROUP, group_budget_bytes // staged))
            )
        G = min(group_size, partitions)
        groups = [
            (np.arange(g * G, min((g + 1) * G, partitions), dtype=np.uint32),
             min(G, partitions - g * G), G, cap_bp, None)
            for g in range((partitions + G - 1) // G)
        ]

    ckpt = None
    if checkpoint_dir is not None:
        import json
        import pathlib

        ckpt = pathlib.Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        fp = {
            "format": 5,
            "scheme": "super-range16",
            "partitions": partitions,
            "cutoff": cutoff,
            "k": k,
            "m": m,
            "s_cap": superkmer.S_CAP,
            "n_batches": n_batches,
            "batch_slots": batch_slots,
        }
        if dataset_tag is not None:
            fp["dataset"] = dataset_tag
        meta_path = ckpt / "meta.json"
        if meta_path.exists():
            old = json.loads(meta_path.read_text())
            if old != fp:
                raise ValueError(
                    f"checkpoint_dir {ckpt} was written by a different "
                    f"configuration: {old} != {fp}; use a fresh directory"
                )
        else:
            meta_path.write_text(json.dumps(fp))

    def part_usable(p):
        path = ckpt / f"part_{p}.npz"
        if not path.exists():
            return False
        return int(np.load(path)["batch_overflows"]) == 0

    def load_part(p):
        saved = np.load(ckpt / f"part_{p}.npz")
        return (
            saved["khi"], saved["klo"], int(saved["n_distinct"]),
            int(saved["n_kept"]), int(saved["batch_overflows"]),
        )

    khi_parts, klo_parts = [], []
    n_distinct = 0
    n_kept = 0
    batch_overflows = 0
    scan_chunk = max(1, min(scan_chunk, n_batches))
    if scan_chunk > 1:
        @functools.partial(
            jax.jit,
            static_argnames=("n_scan", "shape_g", "shape_cap", "retain"),
        )
        def _fused_extract_super(b0, p0, *, n_scan, shape_g, shape_cap,
                                 retain):
            def body(carry, i):
                lanes = batch_super(b0 + i)
                out = extract_partition_range_super(
                    *lanes, p0,
                    partitions=partitions, group_size=shape_g,
                    cap_bp=shape_cap,
                )
                return carry, (out[:6], out[6].astype(jnp.int32))

            _, (lanes_s, ovfs) = lax.scan(
                body, 0, jnp.arange(n_scan, dtype=jnp.int32)
            )
            ovfs = jnp.sum(ovfs, axis=0)
            if retain is None or retain >= n_scan * shape_cap:
                # keep the [n_scan, G, cap] layout (uniform mode, or a
                # remainder chunk small enough that compaction is moot)
                return lanes_s, ovfs
            # dispatch-level compaction: [n_scan, G, cap] -> [G, retain].
            # One BATCHED 6-lane row sort pushes
            # each partition's real records to the front of its slice;
            # rows past ``retain`` overflow that partition (self-heals).
            rows_g = tuple(
                lanes_s[j].transpose(1, 0, 2).reshape(
                    shape_g, n_scan * shape_cap
                )
                for j in range(6)
            )
            rows_s = lax.sort(rows_g, dimension=1, num_keys=1)
            kept = tuple(r[:, :retain] for r in rows_s)
            dropped = rows_s[0][:, retain:] != SENTINEL
            ovfs = ovfs + jnp.sum(dropped, axis=1).astype(jnp.int32)
            return kept, ovfs

    if only_partitions is not None:
        if ckpt is None:
            raise ValueError(
                "only_partitions requires checkpoint_dir (partition "
                "results flow through the shared part_<p>.npz files)"
            )
        own_lo, own_hi = int(only_partitions[0]), int(only_partitions[1])
        if own_lo >= min(own_hi, partitions):
            raise ValueError(
                f"only_partitions=({own_lo}, {own_hi}) owns nothing: the "
                f"run has {partitions} partitions (auto-sized; check the "
                "worker's range against the merge run's partition count)"
            )
    n_groups = len(groups)
    for g, (pid_list, width, shape_g, cap_g, retain_g) in enumerate(groups):
        group_parts = [int(p) for p in pid_list]
        # inert padding: out-of-range pids match no record hash
        pid_arg = np.full((shape_g,), partitions, np.uint32)
        pid_arg[:width] = pid_list
        if only_partitions is not None:
            group_parts = [p for p in group_parts if own_lo <= p < own_hi]
            if not group_parts:
                continue
        owned = set(group_parts)
        missing = [
            p for p in group_parts if ckpt is None or not part_usable(p)
        ]
        if not missing:
            for p in group_parts:
                khi, klo, nd, nk, bo = load_part(p)
                khi_parts.append(khi)
                klo_parts.append(klo)
                n_distinct += nd
                n_kept += nk
                batch_overflows += bo
            continue

        pieces = [[[] for _ in range(6)] for _ in range(width)]
        ovf_dev = jnp.zeros((shape_g,), jnp.int32)
        if scan_chunk > 1:
            b = 0
            while b < n_batches:
                n_scan = min(scan_chunk, n_batches - b)
                lanes_s, ovf = _fused_extract_super(
                    np.int32(b), pid_arg, n_scan=n_scan,
                    shape_g=shape_g, shape_cap=cap_g, retain=retain_g,
                )
                for r in range(width):
                    for j in range(6):
                        # [n_scan, G, cap] raw, or [G, retain] compacted
                        sl = (lanes_s[j][:, r].reshape(-1)
                              if lanes_s[j].ndim == 3 else lanes_s[j][r])
                        pieces[r][j].append(sl)
                del lanes_s
                ovf_dev = ovf_dev + ovf
                b += n_scan
                if on_progress is not None:
                    on_progress(g, n_groups, b, n_batches)
        else:
            for b in range(n_batches):
                lanes = batch_super(b)
                out = extract_partition_range_super(
                    *lanes, jnp.asarray(pid_arg),
                    partitions=partitions, group_size=shape_g,
                    cap_bp=cap_g,
                )
                for r in range(width):
                    for j in range(6):
                        pieces[r][j].append(out[j][r])
                ovf_dev = ovf_dev + out[6].astype(jnp.int32)
                if on_progress is not None:
                    on_progress(g, n_groups, b + 1, n_batches)
        group_overflows = np.asarray(ovf_dev)

        def count_super_partition(p, cat, pass_overflows):
            nonlocal n_distinct, n_kept, batch_overflows
            batch_overflows += pass_overflows
            khi, klo, nd, nk = _count_super_partition(
                cat, cutoff=cutoff, k=k, m=m, chunk=expand_chunk
            )
            del cat
            n_distinct_p = int(nd)
            n_kept_p = int(nk)
            n_distinct += n_distinct_p
            n_kept += n_kept_p
            khi_parts.append(np.asarray(khi[:n_kept_p]))
            klo_parts.append(np.asarray(klo[:n_kept_p]))
            del khi, klo
            if ckpt is not None:
                tmp = ckpt / f"part_{p}.tmp.npz"
                np.savez_compressed(
                    tmp,
                    khi=khi_parts[-1],
                    klo=klo_parts[-1],
                    n_distinct=np.int64(n_distinct_p),
                    n_kept=np.int64(n_kept_p),
                    batch_overflows=np.int64(pass_overflows),
                )
                tmp.rename(ckpt / f"part_{p}.npz")

        overflowed = []
        for r in range(width):
            p = int(pid_list[r])
            if p >= partitions or p not in owned:
                pieces[r] = None
                continue
            if ckpt is not None and part_usable(p):
                pieces[r] = None
                khi, klo, nd, nk, bo = load_part(p)
                khi_parts.append(khi)
                klo_parts.append(klo)
                n_distinct += nd
                n_kept += nk
                batch_overflows += bo
                continue
            pass_overflows = int(group_overflows[r])
            if slack is None and pass_overflows:
                # the probe-histogram cap missed (minimizer mass drifted
                # from the probe batch): queue a single-partition
                # re-extraction with an escalated cap instead of failing
                # after the multi-pass count -- same self-heal contract as
                # partitioned_count / the link builders.
                pieces[r] = None
                overflowed.append(p)
                continue
            cat = tuple(jnp.concatenate(pieces[r][j]) for j in range(6))
            pieces[r] = None
            count_super_partition(p, cat, pass_overflows)
        for p in overflowed:
            cat = _reextract_partition_super(
                batch_super, n_batches, p,
                partitions=partitions, cap0=cap_g, batch_slots=batch_slots,
            )
            count_super_partition(p, cat, 0)

    kmer_hi = np.concatenate([np.asarray(a, np.uint32) for a in khi_parts])
    kmer_lo = np.concatenate([np.asarray(a, np.uint32) for a in klo_parts])
    if not return_host:
        kmer_hi = jnp.asarray(kmer_hi)
        kmer_lo = jnp.asarray(kmer_lo)
    valid = kmer_hi != SENTINEL
    return PartitionedCount(
        kmer_hi=kmer_hi,
        kmer_lo=kmer_lo,
        valid=valid,
        n_distinct=n_distinct,
        n_kept=n_kept,
        batch_overflows=batch_overflows,
        kept_overflow=n_kept > kept_cap,
        group_size=G,
        partitions=partitions,
    )
