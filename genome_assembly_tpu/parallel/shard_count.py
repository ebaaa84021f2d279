"""Minimizer-sharded distributed k-mer counting.

The distributed analogue of the reference's two-level table, and the design
the reference's author left as an open question (FAQ.md:11, "how to merge
bins across nodes"):

  1. Each shard scans its slice of the read batch locally (data parallel).
  2. Every record is routed to ``owner(minimizer)`` via a capacity-padded
     ``all_to_all`` over the mesh's interconnect -- the MSP/KMC super-k-mer routing
     idea in array form.
  3. Each shard sorts and segment-counts the records it owns; shards own
     disjoint minimizer ranges, so no cross-shard groups exist and pruning
     is local.

Ownership uses a multiplicative hash of the minimizer so skewed minimizer
distributions (33 bins held 102k records on reads.txt -- SURVEY.md section
7) spread across shards.  Per-(shard, owner) routing capacity is a static
slack factor over the uniform share; overflow is detected and reported via
a psum'd counter so callers can re-run with more slack rather than
silently losing records.

Everything below runs under ``jax.shard_map`` with a 1-D mesh and works
identically on a virtual CPU mesh (tests) and a multi-GPU mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genome_assembly_tpu.ops import minimizer as minimizer_ops
from genome_assembly_tpu.ops.count import SENTINEL, group_counts
from genome_assembly_tpu.parallel import ragged
from genome_assembly_tpu.common import (
    HASH_A as _HASH_A,
    HASH_B as _HASH_B,
    fmix32 as _fmix32,
)

SHARD_AXIS = "shards"

# Knuth's multiplicative constant; spreads consecutive minimizer values.
_HASH_MULT = np.uint32(2654435761)


def owner_of(mmer: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Shard owning a minimizer: multiplicative hash then mod."""
    return ((mmer * _HASH_MULT) >> 8) % jnp.uint32(n_shards)


def key_owner_of(khi: jnp.ndarray, klo: jnp.ndarray, n_shards: int):
    """Shard owning a canonical k-mer KEY: two-lane multiplicative hash.

    Fast-mode alternative to minimizer ownership: minimizer mass is
    heavy-tailed (33 bins held 102k records on reads.txt, SURVEY.md
    section 7), so at high shard counts the biggest minimizers dominate
    single shards -- the comm model measures received-record skew 1.70 at
    256 shards under owner_of, capping count-phase efficiency at ~58%
    regardless of overlap.  A canonical key's multiplicity is ~coverage
    (fine-grained), so key ownership balances to ~1.0.  All copies of a
    key share its owner, and a key's minimizer is a function of the key,
    so the shard-local (mmer, khi, klo) groups stay complete.  Parity
    mode keeps minimizer ownership (route_by="mmer"): the reference's
    two-level table is signature-major and the replay consumes
    signature-grouped tables.
    """
    h = _fmix32((khi * _HASH_A) ^ (klo * _HASH_B))
    return (h >> 7) % jnp.uint32(n_shards)


class ShardedCount(NamedTuple):
    """Per-shard counted table, arrays [n_shards, cap] (leading axis sharded).

    Groups are complete within one shard (ownership is by minimizer, or
    by canonical key under route_by="key"), so `keep`/`count` have the
    same meaning as the single-device CountedTable.
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
    overflow: jnp.ndarray  # [n_shards] dropped-record counts (want all zero)


def _bucketize_records(
    codes, lengths, read_ids, stream_offset, *, k, m, parity, n_shards, cap,
    routing="padded", route_by="mmer",
):
    """Per-shard: local scan -> owner-sorted staging, NO collective.

    This is the compute half of the routing step, split from the exchange
    so a software-pipelined multi-batch driver can put batch i's exchange
    and batch i+1's scan in ONE program with no data dependence between
    them -- XLA's async collectives then overlap the wire with the scan.

    Returns the staged tuple ``_exchange_staged`` consumes:
      padded: (mmer, khi, klo, rid, stream blocks [n_shards, cap], overflow)
      ragged: (owner_sorted [n], payload [n, 5], zero overflow)
    """
    scan = minimizer_ops.parity_scan if parity else minimizer_ops.fast_scan
    recs = scan(codes, lengths, k=k, m=m)
    rows, n_win = recs.mmer.shape
    n = rows * n_win

    mmer = jnp.where(recs.valid, recs.mmer, SENTINEL).reshape(n)
    khi = recs.kmer_hi.reshape(n)
    klo = recs.kmer_lo.reshape(n)
    rid = jnp.broadcast_to(read_ids[:, None], (rows, n_win)).reshape(n)
    stream = jnp.arange(n, dtype=jnp.uint32) + stream_offset.reshape(())
    valid = recs.valid.reshape(n)

    dest = (
        key_owner_of(khi, klo, n_shards)
        if route_by == "key"
        else owner_of(mmer, n_shards)
    )
    owner = jnp.where(valid, dest, jnp.uint32(n_shards))

    # Sort by owner; within-owner offset = index - first index of the group.
    owner_s, mmer_s, khi_s, klo_s, rid_s, stream_s = lax.sort(
        (owner, mmer, khi, klo, rid, stream), num_keys=1, is_stable=True
    )

    if routing == "ragged":
        payload = jnp.stack([mmer_s, khi_s, klo_s, rid_s, stream_s], axis=1)
        return owner_s, payload, jnp.zeros((), jnp.int32)

    idx = jnp.arange(n, dtype=jnp.int32)
    # run-start via the tiny per-owner starts table: owners are sorted
    # and have small cardinality, so first-of-run is a gather from an
    # (n_shards+1)-entry searchsorted -- no n-query binary search (a
    # log2(n) gather-round cost) and no n-length associative_scan
    starts = jnp.searchsorted(
        owner_s, jnp.arange(n_shards + 1, dtype=owner_s.dtype), side="left"
    ).astype(jnp.int32)
    first_of_owner = starts[jnp.clip(owner_s, 0, n_shards).astype(jnp.int32)]
    slot = idx - first_of_owner
    ok = (slot < cap) & (owner_s < n_shards)
    overflow = jnp.sum((slot >= cap) & (owner_s < n_shards), dtype=jnp.int32)

    # Scatter into per-owner capacity blocks; rows that don't fit (or are
    # invalid) get an out-of-range index and drop.
    o_idx = jnp.where(ok, owner_s.astype(jnp.int32), n_shards)
    s_idx = jnp.where(ok, slot, 0)

    def scatter(vals, fill):
        buf = jnp.full((n_shards, cap), fill, dtype=vals.dtype)
        return buf.at[o_idx, s_idx].set(vals, mode="drop")

    return (
        scatter(mmer_s, SENTINEL),
        scatter(khi_s, jnp.uint32(0)),
        scatter(klo_s, jnp.uint32(0)),
        scatter(rid_s, jnp.uint32(0)),
        scatter(stream_s, jnp.uint32(0xFFFFFFFF)),
        overflow,
    )


def _exchange_staged(staged, *, n_shards, cap, routing="padded",
                     ragged_native=False):
    """The collective half of the routing step (see _bucketize_records).

    Returns (mmer, khi, klo, rid, stream, overflow) -- this shard's
    received records (sentinel-padded)."""
    if routing == "ragged":
        owner_s, payload, overflow = staged
        received, dropped = ragged.route_records_ragged(
            owner_s, payload, n_shards=n_shards, cap_total=cap,
            axis_name=SHARD_AXIS, use_native=ragged_native,
        )
        return (
            received[:, 0], received[:, 1], received[:, 2],
            received[:, 3], received[:, 4],
            overflow + dropped.astype(jnp.int32),
        )

    b_mmer, b_khi, b_klo, b_rid, b_stream, overflow = staged

    # Exchange: block j goes to shard j.
    def xchg(x):
        return lax.all_to_all(x, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True)

    r_mmer = xchg(b_mmer).reshape(-1)
    r_khi = xchg(b_khi).reshape(-1)
    r_klo = xchg(b_klo).reshape(-1)
    r_rid = xchg(b_rid).reshape(-1)
    r_stream = xchg(b_stream).reshape(-1)
    return r_mmer, r_khi, r_klo, r_rid, r_stream, overflow


def _route_records(
    codes, lengths, read_ids, stream_offset, *, k, m, parity, n_shards, cap,
    routing="padded", ragged_native=False, route_by="mmer",
):
    """Per-shard: local scan -> bucketize by owner -> all_to_all.

    Returns (mmer, khi, klo, rid, stream, overflow) -- this shard's
    received records (sentinel-padded) before any counting, so callers can
    accumulate several batches' routed records and count once.

    routing="padded": capacity-padded dense blocks (cap per src/dst pair).
    routing="ragged": exact-size lax.ragged_all_to_all with one
    per-destination budget (cap = receiver total) -- robust to skewed
    minimizer distributions; see parallel/ragged.py."""
    staged = _bucketize_records(
        codes, lengths, read_ids, stream_offset,
        k=k, m=m, parity=parity, n_shards=n_shards, cap=cap, routing=routing,
        route_by=route_by,
    )
    return _exchange_staged(
        staged, n_shards=n_shards, cap=cap, routing=routing,
        ragged_native=ragged_native,
    )


def _scan_and_route(
    codes, lengths, read_ids, stream_offset, *, k, m, parity, n_shards, cap,
    routing="padded", ragged_native=False, route_by="mmer",
):
    """Per-shard body: route (above) then local sort/count."""
    r_mmer, r_khi, r_klo, r_rid, r_stream, overflow = _route_records(
        codes, lengths, read_ids, stream_offset, k=k, m=m, parity=parity,
        n_shards=n_shards, cap=cap, routing=routing,
        ragged_native=ragged_native, route_by=route_by,
    )
    r_valid = r_mmer != SENTINEL
    return _local_count(r_mmer, r_khi, r_klo, r_rid, r_stream, r_valid, overflow)


def _local_count(r_mmer, r_khi, r_klo, r_rid, r_stream, r_valid, overflow):
    """Sort-and-count the records this shard owns (groups are complete)."""
    # sort by key then stream for stable per-group read-id order; validity
    # rides in the sentinel mmer lane rather than as a 6th sort operand
    m_s, hi_s, lo_s, st_s, id_s = lax.sort(
        (r_mmer, r_khi, r_klo, r_stream, r_rid),
        num_keys=4,
        is_stable=True,
    )
    v_s = m_s != SENTINEL
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            (m_s[1:] == m_s[:-1])
            & (hi_s[1:] == hi_s[:-1])
            & (lo_s[1:] == lo_s[:-1]),
        ]
    )
    group_start = ~prev_same
    count = group_counts(group_start)
    return (
        m_s[None],
        hi_s[None],
        lo_s[None],
        id_s[None],
        st_s[None],
        v_s[None],
        group_start[None],
        count[None],
        overflow[None],
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "parity", "cutoff", "mesh", "slack", "routing", "route_by",
    ),
)
def sharded_count(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    read_ids: jnp.ndarray,
    *,
    k: int,
    m: int,
    parity: bool,
    cutoff: int,
    mesh: Mesh,
    slack: float = 4.0,
    routing: str = "padded",
    route_by: str = "mmer",
) -> ShardedCount:
    """Distributed count+prune over a 1-D mesh.

    codes [B, L] / lengths [B] / read_ids [B] sharded on axis 0 (B must be
    divisible by mesh size).  routing="ragged" exchanges exact record
    counts (lax.ragged_all_to_all) under one per-destination budget of
    n_local*slack records instead of a per-pair pad -- same memory bound
    but immune to per-(source,destination) skew and with wire bytes equal
    to real records.
    """
    if routing not in ("padded", "ragged", "two_level"):
        raise ValueError(f"unknown routing {routing!r}")
    _check_route_by(route_by, parity)
    if route_by == "key" and routing == "two_level":
        raise ValueError("two_level routing routes by minimizer only")
    if routing == "two_level":
        # DCN-aware hierarchical routing over a 2-D (slices, shards) mesh
        # (parallel/two_level.py): intra-slice ICI stage, then ONE
        # aggregated inter-slice DCN exchange.  Bit-identical results to
        # the flat routers -- purely a wire-layout switch.
        from genome_assembly_tpu.parallel import two_level

        return two_level.sharded_count_two_level(
            codes, lengths, read_ids, k=k, m=m, parity=parity,
            cutoff=cutoff, mesh=mesh, slack=slack,
        )
    n_shards = mesh.shape[SHARD_AXIS]
    batch, max_len = codes.shape
    rows = batch // n_shards
    n_win = max_len - k + 1
    n_local = rows * n_win
    if routing == "ragged":
        cap = int(np.ceil(n_local * slack))
    else:
        cap = int(np.ceil(n_local / n_shards * slack))
    # per-shard stream offsets follow the global (read, window) order
    offsets = (
        jnp.arange(n_shards, dtype=jnp.uint32)[:, None] * jnp.uint32(n_local)
    )

    fn = jax.shard_map(
        functools.partial(
            _scan_and_route,
            k=k,
            m=m,
            parity=parity,
            n_shards=n_shards,
            cap=cap,
            routing=routing,
            route_by=route_by,
            ragged_native=_is_ragged_native(mesh, routing),
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
    )
    m_s, hi_s, lo_s, id_s, st_s, v_s, gs, count, overflow = fn(
        codes, lengths, read_ids, offsets
    )
    keep = gs & v_s & (count > cutoff)
    return ShardedCount(
        mmer=m_s,
        kmer_hi=hi_s,
        kmer_lo=lo_s,
        read_id=id_s,
        stream_idx=st_s,
        valid=v_s,
        group_start=gs,
        count=count,
        keep=keep,
        overflow=overflow,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "parity", "mesh", "slack", "routing", "route_by",
    ),
)
def _route_batch(
    codes, lengths, read_ids, offsets, *, k, m, parity, mesh, slack, routing,
    route_by="mmer",
):
    """One batch's routed (uncounted) records, sharded [n_shards, R]."""
    n_shards = mesh.shape[SHARD_AXIS]
    batch, max_len = codes.shape
    rows = batch // n_shards
    n_win = max_len - k + 1
    n_local = rows * n_win
    if routing == "ragged":
        cap = int(np.ceil(n_local * slack))
    else:
        cap = int(np.ceil(n_local / n_shards * slack))

    def body(codes, lengths, read_ids, stream_offset):
        out = _route_records(
            codes, lengths, read_ids, stream_offset,
            k=k, m=m, parity=parity, n_shards=n_shards, cap=cap,
            routing=routing, route_by=route_by,
            ragged_native=_is_ragged_native(mesh, routing),
        )
        return tuple(x[None] for x in out)

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=P(SHARD_AXIS),
    )
    return fn(codes, lengths, read_ids, offsets)


def _routing_cap(n_local: int, n_shards: int, slack: float, routing: str):
    if routing == "ragged":
        return int(np.ceil(n_local * slack))
    return int(np.ceil(n_local / n_shards * slack))


def _is_ragged_native(mesh: Mesh, routing: str) -> bool:
    return routing == "ragged" and ragged.has_native(mesh)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "parity", "mesh", "slack", "routing", "route_by",
    ),
)
def _bucketize_batch(
    codes, lengths, read_ids, offsets, *, k, m, parity, mesh, slack, routing,
    route_by="mmer",
):
    """One batch's staged (bucketized, unexchanged) blocks, sharded."""
    n_shards = mesh.shape[SHARD_AXIS]
    batch, max_len = codes.shape
    n_local = (batch // n_shards) * (max_len - k + 1)
    cap = _routing_cap(n_local, n_shards, slack, routing)

    def body(codes, lengths, read_ids, stream_offset):
        staged = _bucketize_records(
            codes, lengths, read_ids, stream_offset,
            k=k, m=m, parity=parity, n_shards=n_shards, cap=cap,
            routing=routing, route_by=route_by,
        )
        return tuple(x[None] for x in staged)

    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=P(SHARD_AXIS),
    )
    return fn(codes, lengths, read_ids, offsets)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "parity", "mesh", "slack", "routing", "route_by",
    ),
)
def _exchange_and_bucketize_batch(
    staged, codes, lengths, read_ids, offsets, *, k, m, parity, mesh, slack,
    routing, route_by="mmer",
):
    """ONE program: exchange the PREVIOUS batch's staged blocks while
    scanning/bucketizing the CURRENT batch.

    The all_to_all's operands are the carried ``staged`` arrays -- nothing
    in it depends on this batch's scan -- so XLA's latency-hiding
    scheduler is free to run the collective asynchronously under the scan
    compute.  This is the software pipeline that turns the count phase's
    serial comm+compute sum into max(comm, compute) at high shard counts
    (parallel/comm_model.pipeline_model quantifies the effect).

    Returns (received lanes + overflow, new staged tuple), all sharded.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    batch, max_len = codes.shape
    n_local = (batch // n_shards) * (max_len - k + 1)
    cap = _routing_cap(n_local, n_shards, slack, routing)

    def body(staged, codes, lengths, read_ids, stream_offset):
        received = _exchange_staged(
            tuple(x[0] for x in staged), n_shards=n_shards, cap=cap,
            routing=routing, ragged_native=_is_ragged_native(mesh, routing),
        )
        new_staged = _bucketize_records(
            codes, lengths, read_ids, stream_offset,
            k=k, m=m, parity=parity, n_shards=n_shards, cap=cap,
            routing=routing, route_by=route_by,
        )
        return (
            tuple(x[None] for x in received),
            tuple(x[None] for x in new_staged),
        )

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 5,
        out_specs=P(SHARD_AXIS),
    )
    return fn(staged, codes, lengths, read_ids, offsets)


@functools.partial(
    jax.jit, static_argnames=("mesh", "cap", "routing")
)
def _exchange_batch(staged, *, mesh, cap, routing):
    """Drain the pipeline: exchange the final staged blocks."""
    n_shards = mesh.shape[SHARD_AXIS]

    def body(staged):
        received = _exchange_staged(
            tuple(x[0] for x in staged), n_shards=n_shards, cap=cap,
            routing=routing, ragged_native=_is_ragged_native(mesh, routing),
        )
        return tuple(x[None] for x in received)

    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(P(SHARD_AXIS),), out_specs=P(SHARD_AXIS),
    )
    return fn(staged)


@functools.partial(jax.jit, static_argnames=("cutoff", "mesh"))
def _count_received(m_cat, hi_cat, lo_cat, rid_cat, st_cat, ovf_cat, *,
                    cutoff, mesh):
    def body(m_r, hi_r, lo_r, rid_r, st_r, ovf_r):
        v = m_r[0] != SENTINEL
        return _local_count(
            m_r[0], hi_r[0], lo_r[0], rid_r[0], st_r[0], v,
            jnp.sum(ovf_r[0]),
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 6,
        out_specs=P(SHARD_AXIS),
    )
    m_s, hi_s, lo_s, id_s, st_s, v_s, gs, count, overflow = fn(
        m_cat, hi_cat, lo_cat, rid_cat, st_cat, ovf_cat
    )
    keep = gs & v_s & (count > cutoff)
    return ShardedCount(
        mmer=m_s, kmer_hi=hi_s, kmer_lo=lo_s, read_id=id_s, stream_idx=st_s,
        valid=v_s, group_start=gs, count=count, keep=keep, overflow=overflow,
    )


def _check_route_by(route_by: str, parity: bool) -> None:
    if route_by not in ("mmer", "key"):
        raise ValueError(f"unknown route_by {route_by!r}")
    if route_by == "key" and parity:
        raise ValueError(
            "parity mode requires minimizer ownership (route_by='mmer'): "
            "the replay consumes signature-grouped tables"
        )


def sharded_count_batches(
    batches,
    *,
    k: int,
    m: int,
    parity: bool,
    cutoff: int,
    mesh: Mesh,
    slack: float = 4.0,
    routing: str = "padded",
    route_by: str = "mmer",
    pipelined: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
) -> ShardedCount:
    """Distributed count over MULTIPLE read batches (any total size).

    Each batch is routed by minimizer ownership as it streams in; every
    shard accumulates the records it owns across batches and sorts/counts
    ONCE at the end, so groups spanning batches are whole and the result
    is identical to a single-batch run over the concatenated reads.

    pipelined=True (default) software-pipelines the stream with a
    one-batch delay: each dispatched program exchanges batch i-1's staged
    blocks WHILE scanning/bucketizing batch i (no data dependence between
    the two, so XLA overlaps the collective with the scan).  Results are
    bit-identical to the unpipelined form -- the same ops run, split
    differently across programs; only the wall-clock overlap changes.

    checkpoint_dir: per-shard resumable checkpoints of the accumulated
    routed records (utils/checkpoint.save_count_shards), written every
    ``checkpoint_every`` exchanged batches.  A killed run -- including
    any process of a multi-process run -- resumes at the last committed
    batch, even on a DIFFERENT mesh shape or process count (records are
    re-routed by the same ownership hash on load).  Each save syncs the
    accumulated lanes to host, so raise checkpoint_every when the
    readback cost matters.

    batches: sequence of reads_io.ReadBatch, all padded to the same row
    count (divisible by the mesh size); read_ids must be globally
    consecutive across batches (reads_io.batch_reads does this).
    """
    if routing not in ("padded", "ragged"):
        raise ValueError(f"unknown routing {routing!r}")
    _check_route_by(route_by, parity)
    n_shards = mesh.shape[SHARD_AXIS]
    received = None
    n_local = None
    staged = None
    cap = None
    start_batch = 0
    done = 0
    ckpt_meta = None

    def accumulate(routed):
        nonlocal received, done
        ovf = routed[5].reshape(n_shards, 1).astype(jnp.int32)
        lanes = routed[:5] + (ovf,)
        if received is None:
            received = list(lanes)
        else:
            received = [
                jnp.concatenate([acc, new], axis=1)
                for acc, new in zip(received, lanes)
            ]
        done += 1

    def maybe_save(force=False):
        if checkpoint_dir is None or received is None or done <= start_batch:
            return
        if force or (done - start_batch) % max(checkpoint_every, 1) == 0:
            from genome_assembly_tpu.utils import checkpoint as ckpt_ops

            ckpt_ops.save_count_shards(
                checkpoint_dir, received, done, ckpt_meta
            )

    for bi, b in enumerate(batches):
        batch_rows, max_len = b.codes.shape
        rows = batch_rows // n_shards
        n_win = max_len - k + 1
        if n_local is None:
            n_local = rows * n_win
            cap = _routing_cap(n_local, n_shards, slack, routing)
            if checkpoint_dir is not None:
                from genome_assembly_tpu.utils import checkpoint as ckpt_ops

                ckpt_meta = {
                    "k": k, "m": m, "parity": parity,
                    "batch_rows": batch_rows, "max_len": max_len,
                    "route_by": route_by,
                }
                loaded = ckpt_ops.load_count_shards(
                    checkpoint_dir, n_shards=n_shards, expect=ckpt_meta
                )
                if loaded is not None:
                    host_lanes, start_batch = loaded
                    sharding = NamedSharding(mesh, P(SHARD_AXIS))
                    received = [
                        jax.device_put(lane, sharding) for lane in host_lanes
                    ]
                    done = start_batch
        if bi < start_batch:
            continue  # this batch's records are already in `received`
        codes = jnp.asarray(b.codes)
        lengths = jnp.asarray(b.lengths)
        rids = jnp.asarray(b.read_ids)
        # global stream order: batch-major, then shard, then local slot
        offsets = (
            jnp.arange(n_shards, dtype=jnp.uint32)[:, None] * jnp.uint32(n_local)
            + jnp.uint32(bi * n_shards * n_local)
        )
        if not pipelined:
            accumulate(_route_batch(
                codes, lengths, rids, offsets,
                k=k, m=m, parity=parity, mesh=mesh, slack=slack,
                routing=routing, route_by=route_by,
            ))
            maybe_save()
        elif staged is None:
            staged = _bucketize_batch(
                codes, lengths, rids, offsets,
                k=k, m=m, parity=parity, mesh=mesh, slack=slack,
                routing=routing, route_by=route_by,
            )
        else:
            routed, staged = _exchange_and_bucketize_batch(
                staged, codes, lengths, rids, offsets,
                k=k, m=m, parity=parity, mesh=mesh, slack=slack,
                routing=routing, route_by=route_by,
            )
            accumulate(routed)
            maybe_save()
    if staged is not None:  # drain the one-batch pipeline delay
        accumulate(_exchange_batch(staged, mesh=mesh, cap=cap, routing=routing))
    if received is None:
        raise ValueError("no batches")
    maybe_save(force=True)
    return _count_received(*received, cutoff=cutoff, mesh=mesh)


def sharded_groups_for_replay(sc: ShardedCount):
    """ShardedCount (built with cutoff=-1) -> insertion-ordered host groups.

    Returns (mmer, kmer_hi, kmer_lo, id_offsets, read_ids) numpy arrays in
    global first-seen order -- the native parity replay's input format.
    Ownership partitioning loses no ordering information because each
    group's first_seen stream index is global.
    """
    mmer_o, hi_o, lo_o, offsets, flat_ids, _ = _sharded_groups(
        sc, with_streams=False
    )
    return mmer_o, hi_o, lo_o, offsets, flat_ids


def sharded_host_table_with_streams(sc: ShardedCount):
    """ShardedCount -> (parity HostTable, per-group occurrence streams).

    The stream lane rides the same grouped layout as read ids, so the
    identical slicing yields each occurrence's global stream index --
    what the non-ACGT exception regroup (parity/nonacgt.py) needs.
    """
    from genome_assembly_tpu.parity import table as table_ops

    mmer_o, hi_o, lo_o, offsets, flat_ids, flat_streams = _sharded_groups(sc)
    read_ids = [
        flat_ids[offsets[i] : offsets[i + 1]].astype(np.uint32)
        for i in range(len(mmer_o))
    ]
    streams = [
        flat_streams[offsets[i] : offsets[i + 1]].astype(np.uint32)
        for i in range(len(mmer_o))
    ]
    first = np.asarray(
        [s[0] if len(s) else 0 for s in streams], dtype=np.uint32
    )
    host = table_ops.HostTable(
        mmer=mmer_o, kmer_hi=hi_o, kmer_lo=lo_o,
        count=(offsets[1:] - offsets[:-1]).astype(np.int32),
        first_seen=first, read_ids=read_ids,
    )
    return host, streams


def _sharded_groups(sc: ShardedCount, with_streams: bool = True):
    mmer = np.asarray(sc.mmer)
    khi = np.asarray(sc.kmer_hi)
    klo = np.asarray(sc.kmer_lo)
    rid = np.asarray(sc.read_id)
    stream = np.asarray(sc.stream_idx)
    count = np.asarray(sc.count)
    gs = np.asarray(sc.group_start)
    valid = np.asarray(sc.valid)

    g_mmer, g_hi, g_lo, g_first, g_ids, g_strm = [], [], [], [], [], []
    for s in range(mmer.shape[0]):
        starts = np.flatnonzero(gs[s] & valid[s])
        for g in starts:
            c = count[s, g]
            g_mmer.append(mmer[s, g])
            g_hi.append(khi[s, g])
            g_lo.append(klo[s, g])
            g_first.append(stream[s, g])
            g_ids.append(rid[s, g : g + c])
            if with_streams:
                g_strm.append(stream[s, g : g + c])
    order = np.argsort(np.asarray(g_first), kind="stable")
    mmer_o = np.asarray(g_mmer, dtype=np.uint32)[order]
    hi_o = np.asarray(g_hi, dtype=np.uint32)[order]
    lo_o = np.asarray(g_lo, dtype=np.uint32)[order]
    sizes = np.asarray([len(g_ids[i]) for i in order], dtype=np.int64)
    offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    flat_ids = (
        np.concatenate([np.asarray(g_ids[i], dtype=np.int32) for i in order])
        if len(order)
        else np.zeros(0, dtype=np.int32)
    )
    flat_streams = None
    if with_streams:
        flat_streams = (
            np.concatenate(
                [np.asarray(g_strm[i], dtype=np.uint32) for i in order]
            )
            if len(order)
            else np.zeros(0, dtype=np.uint32)
        )
    return mmer_o, hi_o, lo_o, offsets, flat_ids, flat_streams


def sharded_to_host_dict(sc: ShardedCount, k: int, m: int):
    """Merge per-shard tables into the string-keyed dict (tests/materialize).

    Shards own disjoint minimizers, so this is pure concatenation.
    """
    from genome_assembly_tpu.ops import encode

    out = {}
    mmer = np.asarray(sc.mmer)
    khi = np.asarray(sc.kmer_hi)
    klo = np.asarray(sc.kmer_lo)
    rid = np.asarray(sc.read_id)
    stream = np.asarray(sc.stream_idx)
    count = np.asarray(sc.count)
    keep = np.asarray(sc.keep)
    for s in range(mmer.shape[0]):
        starts = np.flatnonzero(keep[s])
        for g in starts:
            c = count[s, g]
            sig = encode.unpack_int(int(mmer[s, g]), m)
            kmer = encode.unpack_int(
                encode.split_to_int(int(khi[s, g]), int(klo[s, g]), k), k
            )
            ids = rid[s, g : g + c]
            order = np.argsort(stream[s, g : g + c], kind="stable")
            out[(sig, kmer)] = list(map(int, ids[order][::-1]))
    return out
