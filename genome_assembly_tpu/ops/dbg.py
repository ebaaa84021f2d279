"""Fast-mode de Bruijn graph compaction: unitigs via parallel pointer jumping.

The reference extends unitigs with a serial greedy merge over mutating hash
tables (find_kmer_extensions, binning.c:659-783): O(entries x bin size) of
pointer chasing, impossible to parallelize as written.  The data-parallel
formulation is the classic list-ranking view:

  1. The pruned canonical k-mer set is a sorted array (the graph's nodes).
  2. Each node has two directed states: (node, strand).  State s has a
     *unitig edge* to its unique successor t iff out-degree(s) == 1 and
     in-degree(t) == 1 (in-degree(t) equals out-degree of t's flipped
     state, by reverse-complement symmetry).  All degrees come from eight
     membership lookups per node -- data-parallel binary searches over the
     sorted key array, no mutation anywhere.
  3. The unitig-edge relation is a functional graph whose maximal paths are
     exactly the unitigs; pointer doubling ranks every state in
     O(log chain-length) rounds of gathers (vs the reference's serial
     walks).  Cycles are broken at their minimum state id, found by
     min-propagation during the same doubling rounds.

Unlike the reference, extension candidates are found by *value* lookup, so
true graph neighbors are never missed due to signature binning (the
reference only probes 4 constructed boundary bins and misses neighbors
binned elsewhere -- SURVEY.md 2.1.8); and safe deletion simply does not
arise: nothing mutates.

Requires odd k (no reverse-complement palindromes), the standard choice.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from genome_assembly_tpu.ops import encode


def searchsorted2(
    hi: jnp.ndarray, lo: jnp.ndarray, qhi: jnp.ndarray, qlo: jnp.ndarray
) -> jnp.ndarray:
    """Left insertion points of (qhi, qlo) queries in the sorted (hi, lo)
    lane pair.  Vectorized binary search: ceil(log2 N) rounds of gathers
    (keys stay two uint32 lanes, ops/encode.py; the compare is two-lane).
    """
    n = hi.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    # one [n, 2] row gather per round instead of two 1-D gathers
    tbl = jnp.stack([hi, lo], axis=1)
    # derive the search-bound inits from the queries so their varying-axis
    # type matches the loop carry under shard_map
    lo_b = (qhi * 0).astype(jnp.int32)
    hi_b = lo_b + n

    def body(_, carry):
        lo_b, hi_b = carry
        mid = (lo_b + hi_b) >> 1
        row = tbl[jnp.clip(mid, 0, n - 1)]
        mh = row[:, 0]
        ml = row[:, 1]
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        lo_b = jnp.where(less, mid + 1, lo_b)
        hi_b = jnp.where(less, hi_b, mid)
        return lo_b, hi_b

    lo_b, hi_b = lax.fori_loop(0, steps, body, (lo_b, hi_b))
    return lo_b


def lookup2(
    hi: jnp.ndarray, lo: jnp.ndarray, qhi: jnp.ndarray, qlo: jnp.ndarray
) -> jnp.ndarray:
    """Index of each (qhi, qlo) in the sorted key arrays, or -1."""
    n = hi.shape[0]
    pos = searchsorted2(hi, lo, qhi, qlo)
    idx = jnp.clip(pos, 0, n - 1)
    found = (hi[idx] == qhi) & (lo[idx] == qlo) & (pos < n)
    return jnp.where(found, pos, -1)


class CompactedGraph(NamedTuple):
    """Per-state chain assignment from pointer jumping.

    States are indexed 2*node + strand (strand 0 = the canonical key's own
    orientation, 1 = its reverse complement).  All arrays have length 2N.
    """

    next_state: jnp.ndarray  # unitig-edge successor state or -1
    head: jnp.ndarray  # chain head state id
    rank: jnp.ndarray  # position within chain
    is_cycle: jnp.ndarray  # state belongs to a cyclic chain


def _oriented_value(khi, klo, rhi, rlo, strand):
    """Packed oriented k-mer of each (node, strand)."""
    ohi = jnp.where(strand == 0, khi, rhi)
    olo = jnp.where(strand == 0, klo, rlo)
    return ohi, olo


@functools.partial(jax.jit, static_argnames=("k",))
def build_unitig_links(
    khi: jnp.ndarray, klo: jnp.ndarray, valid: jnp.ndarray, *, k: int
) -> jnp.ndarray:
    """next_state[2N]: the unitig-edge successor of every state, or -1.

    khi/klo: sorted canonical keys, padded; valid marks real rows.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k (no RC palindromes)")
    n = khi.shape[0]
    n_lo = min(k, 16)
    n_hi = k - n_lo
    mask_lo = jnp.uint32((1 << (2 * n_lo)) - 1)
    mask_hi = jnp.uint32((1 << (2 * n_hi)) - 1) if n_hi else jnp.uint32(0)

    rhi, rlo = encode.reverse_complement_packed(khi, klo, k)

    # states: [2N] node = s >> 1, strand = s & 1
    # iota arithmetic, not repeat/tile: no [n, 2] broadcast is
    # materialized
    sid2 = jnp.arange(2 * n, dtype=jnp.int32)
    node = sid2 >> 1
    strand = sid2 & 1
    ohi, olo = _oriented_value(khi[node], klo[node], rhi[node], rlo[node], strand)
    state_valid = valid[node]

    # Successor candidates: drop the leading base, append b.
    # oriented value v (2k bits in two lanes) -> suffix = v without its top
    # base; cand = suffix << 2 | b.
    if n_hi > 0:
        suf_hi = ((ohi << 2) | (olo >> (2 * (n_lo - 1)))) & mask_hi
        suf_lo_base = (olo << 2) & mask_lo
    else:
        suf_hi = jnp.zeros_like(ohi)
        suf_lo_base = (olo << 2) & mask_lo

    state_id = 2 * node + strand
    out_deg = jnp.zeros(2 * n, dtype=jnp.int32)
    succ_state = jnp.full(2 * n, -1, dtype=jnp.int32)
    for b in range(4):
        chi = suf_hi
        clo = suf_lo_base | jnp.uint32(b)
        # canonical form of the candidate
        rchi, rclo = encode.reverse_complement_packed(chi, clo, k)
        fwd_le = (chi < rchi) | ((chi == rchi) & (clo <= rclo))
        qhi = jnp.where(fwd_le, chi, rchi)
        qlo = jnp.where(fwd_le, clo, rclo)
        idx = lookup2(khi, klo, qhi, qlo)
        found = (idx >= 0) & state_valid
        # entry strand of the target: 0 if the candidate equals the target's
        # canonical orientation (fwd_le), else 1.
        t_state = jnp.where(fwd_le, 2 * idx, 2 * idx + 1).astype(jnp.int32)
        # A hairpin edge (target is this state's own twin) is a loop on the
        # node's port in the bidirected model and contributes degree 2:
        # it can never be a unitig edge, and its presence also disqualifies
        # any other extension through this port.
        hairpin = t_state == (state_id ^ 1)
        out_deg = out_deg + jnp.where(hairpin, 2, 1) * found.astype(jnp.int32)
        succ_state = jnp.where(found, t_state, succ_state)

    # unitig edge: out_deg(s) == 1 and in_deg(t) == 1, where
    # in_deg(t) == out_deg(flip(t)).
    unique_succ = (out_deg == 1) & state_valid
    t = jnp.where(unique_succ, succ_state, 0)
    flip_t = t ^ 1
    t_in_deg = out_deg[flip_t]
    next_state = jnp.where(unique_succ & (t_in_deg == 1), succ_state, -1)
    return next_state


@functools.partial(jax.jit, static_argnames=("k",))
def build_unitig_links_join(
    khi: jnp.ndarray, klo: jnp.ndarray, valid: jnp.ndarray, *, k: int
) -> jnp.ndarray:
    """next_state[2N] via a (k-1)-mer sort-join -- no membership lookups.

    The binary-search formulation above costs 8 lookups x ~21 dependent
    gather rounds per state; this one costs one sort of 4 boundary records
    per node.  Which is faster on a given device is a measurement
    (build_unitig_links stays as the differential-test reference).

    Formulation: every state (oriented k-mer v) emits two records keyed by
    a (k-1)-mer value: an OUT record keyed by suffix(v) and an IN record
    keyed by prefix(v).  Edge s->t exists iff suffix(v_s) == prefix(v_t),
    i.e. exactly the key groups.  For a group g with out-set O_g / in-set
    I_g, the candidate formulation's degrees are
    out_deg(s) = |I_g| + [flip(s) in I_g] and in_deg(t) = |O_g| +
    [flip(t) in O_g], so s->t is a unitig edge iff |O_g| == |I_g| == 1 and
    t != flip(s).  With records sorted by (key, side, state) that test is a
    static shifted comparison: a group is exactly two adjacent rows, OUT
    then IN.

    Returns results identical to build_unitig_links (differential-tested).
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k (no RC palindromes)")
    n = khi.shape[0]
    n_lo = min(k, 16)
    n_hi = k - n_lo

    rhi, rlo = encode.reverse_complement_packed(khi, klo, k)
    # STRAND-MAJOR state layout: [all strand-0 states | all strand-1].
    # Record order is irrelevant (the join sorts), and this form needs
    # neither repeat/tile [n, 2] broadcasts nor khi[sid2 >> 1] gathers.
    # The state ids still encode the interleaved 2*node+strand.
    ohi = jnp.concatenate([khi, rhi])
    olo = jnp.concatenate([klo, rlo])
    state_valid = jnp.concatenate([valid, valid])
    node_iota = jnp.arange(n, dtype=jnp.uint32)
    state_id = jnp.concatenate([2 * node_iota, 2 * node_iota + 1])

    # suffix = v & mask(2k-2); prefix = v >> 2  (two-lane arithmetic)
    if n_hi > 0:
        suf_hi = ohi & jnp.uint32((1 << (2 * n_hi - 2)) - 1)
        suf_lo = olo
        pre_hi = ohi >> 2
        pre_lo = (olo >> 2) | ((ohi & 3) << 30)
    else:
        suf_hi = jnp.zeros_like(ohi)
        suf_lo = olo & jnp.uint32((1 << (2 * k - 2)) - 1)
        pre_hi = jnp.zeros_like(ohi)
        pre_lo = olo >> 2

    sent = jnp.uint32(0xFFFFFFFF)
    key_hi = jnp.concatenate(
        [jnp.where(state_valid, suf_hi, sent), jnp.where(state_valid, pre_hi, sent)]
    )
    key_lo = jnp.concatenate(
        [jnp.where(state_valid, suf_lo, sent), jnp.where(state_valid, pre_lo, sent)]
    )
    side = jnp.concatenate(
        [jnp.zeros(2 * n, jnp.uint32), jnp.ones(2 * n, jnp.uint32)]
    )
    payload = (side << 31) | jnp.concatenate([state_id, state_id])
    vrow = jnp.concatenate([state_valid, state_valid])

    khi_s, klo_s, pay_s, v_s = lax.sort(
        (key_hi, key_lo, payload, vrow), num_keys=3
    )
    m = 4 * n
    side_s = (pay_s >> 31).astype(jnp.int32)
    state_s = (pay_s & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)

    def nxt(x, fill):
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    def prv(x, fill):
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    same_next = (nxt(khi_s, sent ^ 1) == khi_s) & (nxt(klo_s, sent ^ 1) == klo_s)
    same_prev = (prv(khi_s, sent ^ 1) == khi_s) & (prv(klo_s, sent ^ 1) == klo_s)
    # group of exactly two rows: OUT at i, IN at i+1
    pair = (
        ~same_prev
        & same_next
        & ~nxt(same_next, True)
        & (side_s == 0)
        & (nxt(side_s, 1) == 1)
        & v_s
    )
    target = nxt(state_s, -1)
    hairpin = target == (state_s ^ 1)
    next_for_row = jnp.where(pair & ~hairpin, target, -1)

    # restore state order: OUT rows (side 0) sort first, ordered by state id
    pay2, next_sorted = lax.sort((pay_s, next_for_row), num_keys=1)
    return next_sorted[: 2 * n]


@functools.partial(jax.jit, static_argnames=("k", "chunk_nodes"))
def _chunk_boundary_records(
    khi_c: jnp.ndarray, klo_c: jnp.ndarray, valid_c: jnp.ndarray,
    base_node: jnp.ndarray, *, k: int, chunk_nodes: int
):
    """OUT/IN boundary records for one chunk of nodes (both strands).

    Returns (key_hi, key_lo, payload) of length 4*chunk_nodes; payload is
    side << 31 | global_state_id; invalid rows are SENTINEL in all lanes.
    One compiled executable serves every chunk (base_node is traced).
    """
    n_lo = min(k, 16)
    n_hi = k - n_lo
    rhi, rlo = encode.reverse_complement_packed(khi_c, klo_c, k)
    # strand-major layout, no per-state gathers (see
    # build_unitig_links_join): downstream hash-partitions + sorts the
    # records, so record order is free
    node_iota = jnp.arange(chunk_nodes, dtype=jnp.int32)
    g0 = (2 * (base_node.astype(jnp.int32) + node_iota)).astype(jnp.uint32)
    gid = jnp.concatenate([g0, g0 + 1])
    ohi = jnp.concatenate([khi_c, rhi])
    olo = jnp.concatenate([klo_c, rlo])
    state_valid = jnp.concatenate([valid_c, valid_c])

    if n_hi > 0:
        suf_hi = ohi & jnp.uint32((1 << (2 * n_hi - 2)) - 1)
        suf_lo = olo
        pre_hi = ohi >> 2
        pre_lo = (olo >> 2) | ((ohi & 3) << 30)
    else:
        suf_hi = jnp.zeros_like(ohi)
        suf_lo = olo & jnp.uint32((1 << (2 * k - 2)) - 1)
        pre_hi = jnp.zeros_like(ohi)
        pre_lo = olo >> 2

    sent = jnp.uint32(0xFFFFFFFF)
    key_hi = jnp.concatenate(
        [jnp.where(state_valid, suf_hi, sent), jnp.where(state_valid, pre_hi, sent)]
    )
    key_lo = jnp.concatenate(
        [jnp.where(state_valid, suf_lo, sent), jnp.where(state_valid, pre_lo, sent)]
    )
    side = jnp.concatenate(
        [jnp.zeros(2 * chunk_nodes, jnp.uint32), jnp.ones(2 * chunk_nodes, jnp.uint32)]
    )
    payload = jnp.where(
        jnp.concatenate([state_valid, state_valid]),
        (side << 31) | jnp.concatenate([gid, gid]),
        sent,
    )
    return key_hi, key_lo, payload


@jax.jit
def _partition_edges(key_hi, key_lo, payload):
    """Sort one partition's records and pair-test: (src or -1, dst).

    The same exactly-two-rows OUT-then-IN group test as
    build_unitig_links_join, over records whose key groups are complete
    (all of a (k-1)-mer's records share its hash partition).
    """
    sent = jnp.uint32(0xFFFFFFFF)
    khi_s, klo_s, pay_s = lax.sort((key_hi, key_lo, payload), num_keys=3)
    v_s = khi_s != sent
    side_s = (pay_s >> 31).astype(jnp.int32)
    state_s = (pay_s & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)

    def nxt(x, fill):
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    def prv(x, fill):
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    same_next = (nxt(khi_s, sent ^ 1) == khi_s) & (nxt(klo_s, sent ^ 1) == klo_s)
    same_prev = (prv(khi_s, sent ^ 1) == khi_s) & (prv(klo_s, sent ^ 1) == klo_s)
    pair = (
        ~same_prev
        & same_next
        & ~nxt(same_next, True)
        & (side_s == 0)
        & (nxt(side_s, 1) == 1)
        & v_s
    )
    target = nxt(state_s, -1)
    hairpin = target == (state_s ^ 1)
    edge = pair & ~hairpin
    return jnp.where(edge, state_s, -1), target


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_edges(next_state, src, dst):
    loc = jnp.where(src >= 0, src, next_state.shape[0])
    return next_state.at[loc].set(dst, mode="drop", unique_indices=True)


@jax.jit
def _compact_partition_rows(hi, lo, pay):
    """Sort one extracted slice so real records lead; return their count.

    Real keys' hi lane is < SENTINEL (boundary keys carry <= 30 bits in
    hi), so a single hi-keyed sort pushes the sentinel padding to the
    back and the host can read back exactly n_real rows.
    """
    sent = jnp.uint32(0xFFFFFFFF)
    hi_s, lo_s, pay_s = lax.sort((hi, lo, pay), num_keys=1)
    return hi_s, lo_s, pay_s, jnp.sum(hi != sent)


def _reextract_partition3(
    chunk_records, n_chunks: int, p: int, *,
    partitions: int, cap0: int, rec_per_chunk: int,
):
    """Re-extract ONE partition whose statistical staging cap overflowed.

    The group extraction's cap_bp is statistical (mean + 8 sigma over the
    worst-balanced range bucket, ops/outofcore.range_group_plan); a missed
    tail at chromosome scale would abort the run AFTER the multi-hour
    count ("raise link slack").  Instead the builders
    withhold an overflowed partition's edges and call this: one extra
    sweep over the chunks with group_size=1 and a doubled cap, escalating
    until clean.  cap >= rec_per_chunk cannot overflow (the slice covers
    the whole chunk), so the loop terminates.

    Device memory is BOUNDED at one chunk's extraction: each chunk's
    slice is compacted on device and read back at its TRUE size (staging
    n_chunks x cap device-resident would grow with the escalated cap).
    The readback is ~the real partition bytes, paid only on this rare
    path.
    """
    import logging

    from genome_assembly_tpu.ops import outofcore

    cap = cap0
    while True:
        cap = min(rec_per_chunk, max(2 * cap, 1024))
        logging.getLogger(__name__).warning(
            "link partition %d overflowed its staging cap; re-extracting "
            "alone at cap=%d", p, cap,
        )
        hs, ls, ps = [], [], []
        overflowed = False
        for c in range(n_chunks):
            rk_hi, rk_lo, rpay = chunk_records(c)
            ghi, glo, gpay, ovf = outofcore.extract_partition_range3(
                rk_hi, rk_lo, rpay, jnp.uint32(p),
                partitions=partitions, group_size=1, cap_bp=cap,
            )
            del rk_hi, rk_lo, rpay
            hi_s, lo_s, pay_s, n_real = _compact_partition_rows(
                ghi[0], glo[0], gpay[0]
            )
            del ghi, glo, gpay
            if bool(ovf[0]):
                overflowed = True
                break
            ne = int(n_real)  # hard sync; chunk temporaries now dead
            hs.append(np.asarray(hi_s[:ne]))
            ls.append(np.asarray(lo_s[:ne]))
            ps.append(np.asarray(pay_s[:ne]))
            del hi_s, lo_s, pay_s
        if not overflowed or cap >= rec_per_chunk:
            return (
                jnp.asarray(np.concatenate(hs)),
                jnp.asarray(np.concatenate(ls)),
                jnp.asarray(np.concatenate(ps)),
            )
        hs = ls = ps = None  # free before the next escalation


def build_unitig_links_ooc(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    partitions: int,
    chunk_nodes: int = 1 << 24,
    slack: float | None = None,
    group_size: int | None = None,
    group_budget_bytes: int = 5 << 30,
):
    """next_state[2N] for key sets whose 4N-record join sort exceeds HBM.

    Identical results to build_unitig_links_join (differential-tested),
    computed in ceil(partitions/G) passes: each pass regenerates every
    chunk's boundary records (cheap arithmetic over the resident key
    array), extracts a GROUP of G consecutive RANGE partitions
    (ops/outofcore.extract_partition_range3; G sized from a staging
    budget, not the old 2-bit tag limit of 3), then sorts + pair-tests
    each partition independently and scatters its edges into the
    accumulating link array.

    Peak device memory: 2N links + the key array + G partitions' staged
    records (G x 4N/partitions x 12 B) + one partition's sort copies --
    the knob that lets a 268M-state celegans-scale graph build within a
    16 GB budget.

    Returns (next_state [2N], overflow_count); nonzero overflow => more
    partitions or explicit ``slack`` (a partition's records exceeded
    their per-chunk capacity).
    """
    from genome_assembly_tpu.ops import outofcore

    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n = khi.shape[0]
    if n % chunk_nodes:
        pad = chunk_nodes - (n % chunk_nodes)
        sent = jnp.uint32(0xFFFFFFFF)
        khi = jnp.concatenate([khi, jnp.full((pad,), sent, jnp.uint32)])
        klo = jnp.concatenate([klo, jnp.full((pad,), sent, jnp.uint32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    n_padded = khi.shape[0]
    n_chunks = n_padded // chunk_nodes
    rec_per_chunk = 4 * chunk_nodes
    cap_bp, G = outofcore.range_group_plan(
        n_chunks, rec_per_chunk, partitions=partitions,
        bytes_per_record=12, budget_bytes=group_budget_bytes,
        group_size=group_size, sigma_scale=2.9,  # boundary keys join in
        # groups of <= 8 per (k-1)-mer: sqrt(8) deviation inflation
    )
    if slack is not None:  # explicit multiplicative override (tests)
        cap_bp = min(
            rec_per_chunk,
            int(np.ceil(rec_per_chunk / partitions * slack)) + 1,
        )

    def chunk_records(c):
        s = c * chunk_nodes
        return _chunk_boundary_records(
            khi[s : s + chunk_nodes],
            klo[s : s + chunk_nodes],
            valid[s : s + chunk_nodes],
            jnp.int32(s),
            k=k,
            chunk_nodes=chunk_nodes,
        )

    next_state = jnp.full(2 * n_padded, -1, dtype=jnp.int32)
    ovf_total = 0
    n_groups = (partitions + G - 1) // G
    for g in range(n_groups):
        pieces = [([], [], []) for _ in range(G)]
        ovf_dev = jnp.zeros((G,), jnp.int32)
        for c in range(n_chunks):
            rk_hi, rk_lo, rpay = chunk_records(c)
            ghi, glo, gpay, ovf = outofcore.extract_partition_range3(
                rk_hi, rk_lo, rpay, jnp.uint32(g),
                partitions=partitions, group_size=G, cap_bp=cap_bp,
            )
            for r in range(G):
                pieces[r][0].append(ghi[r])
                pieces[r][1].append(glo[r])
                pieces[r][2].append(gpay[r])
            ovf_dev = ovf_dev + ovf.astype(jnp.int32)
        ovf_host = np.asarray(ovf_dev)

        overflowed = []
        for r in range(G):
            p = g * G + r
            if p >= partitions:
                pieces[r] = None
                continue
            if slack is None and int(ovf_host[r]):
                # statistical cap missed this partition: its staged records
                # are incomplete, so NO edges from it were scattered; queue
                # a single-partition re-extraction with an escalated cap
                # (after the group's staging frees) instead of failing the
                # whole run.
                pieces[r] = None
                overflowed.append(p)
                continue
            ovf_total += int(ovf_host[r])
            cat_hi = jnp.concatenate(pieces[r][0])
            cat_lo = jnp.concatenate(pieces[r][1])
            cat_pay = jnp.concatenate(pieces[r][2])
            pieces[r] = None  # free staging before the partition sort
            src, dst = _partition_edges(cat_hi, cat_lo, cat_pay)
            del cat_hi, cat_lo, cat_pay
            next_state = _scatter_edges(next_state, src, dst)
            del src, dst
        for p in overflowed:
            cat_hi, cat_lo, cat_pay = _reextract_partition3(
                chunk_records, n_chunks, p,
                partitions=partitions, cap0=cap_bp,
                rec_per_chunk=rec_per_chunk,
            )
            src, dst = _partition_edges(cat_hi, cat_lo, cat_pay)
            del cat_hi, cat_lo, cat_pay
            next_state = _scatter_edges(next_state, src, dst)
            del src, dst
    return next_state[: 2 * n], ovf_total


@jax.jit
def _compact_edges(src: jnp.ndarray, dst: jnp.ndarray):
    """Sort real edges to the front for a thin host readback.

    src rows of -1 (no edge) become SENTINEL and sort last; the edge count
    is returned as a device scalar so the host can slice the readback to
    exactly n_edges rows (reading the full padded partition back would
    move several times the bytes).
    """
    sent = jnp.uint32(0xFFFFFFFF)
    key = jnp.where(src >= 0, src.astype(jnp.uint32), sent)
    key_s, dst_s = lax.sort((key, dst.astype(jnp.uint32)), num_keys=1)
    return key_s, dst_s, jnp.sum(src >= 0)


def build_unitig_links_parked(
    khi,
    klo,
    valid,
    *,
    k: int,
    partitions: int,
    chunk_nodes: int = 1 << 24,
    slack: float | None = None,
    group_size: int | None = None,
    group_budget_bytes: int = 5 << 30,
    park_links: bool = False,
    on_event=None,
):
    """build_unitig_links_ooc with the big residents parked in host RAM.

    ``on_event(kind, **fields)`` (optional) reports phase progress so
    chromosome-scale runs can see where the link wall goes
    (comm_model.parked_links_model budgets it):

    - ``("link_pass", g=, chunks=, wall_s=)`` after each group's chunk
      sweep (wall is hard-synced by the overflow readback);
    - ``("link_partition", p=, wall_s=, n_edges=)`` after each
      partition's sort-join (synced via the edge-count readback when
      park_links; dispatch-only otherwise, n_edges=-1);
    - ``("link_reextract", p=)`` when a staging cap escalates.

    The plain out-of-core builder keeps the full key array AND the 2N link
    array device-resident (ops/dbg.py build_unitig_links_ooc) -- ~12 GB at
    3 Gbp for those two alone, over a 16 GB budget before sort
    temporaries.  This variant removes either or both residents:

    - **parked keys**: pass khi/klo/valid as HOST numpy arrays; each group
      pass re-uploads them chunk-by-chunk (the upload is streamed, never
      whole-array), so the device holds one chunk's keys at a time.
    - **parked links** (``park_links=True``): each partition's edges are
      compacted on device, read back as exactly n_edges (src, dst) rows,
      and scattered into a host-resident int32 next_state -- the device
      never holds the 2N link array.  Total readback = 8 B x n_edges
      (~2N), over the host link.

    Results are bit-identical to build_unitig_links_join /
    build_unitig_links_ooc (differential-tested).  Returns
    (next_state, overflow_count); next_state is host numpy when
    park_links else a device array.  Peak device memory: one chunk's
    keys + GROUP staging + one partition's sort (+ the 2N link array only
    when not park_links).
    """
    import time as _time

    from genome_assembly_tpu.ops import outofcore

    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    keys_hosted = isinstance(khi, np.ndarray)
    xp = np if keys_hosted else jnp
    n = khi.shape[0]
    if n % chunk_nodes:
        pad = chunk_nodes - (n % chunk_nodes)
        sent = xp.uint32(0xFFFFFFFF)
        khi = xp.concatenate([khi, xp.full((pad,), sent, xp.uint32)])
        klo = xp.concatenate([klo, xp.full((pad,), sent, xp.uint32)])
        valid = xp.concatenate([valid, xp.zeros((pad,), bool)])
    n_padded = khi.shape[0]
    n_chunks = n_padded // chunk_nodes
    rec_per_chunk = 4 * chunk_nodes
    cap_bp, G = outofcore.range_group_plan(
        n_chunks, rec_per_chunk, partitions=partitions,
        bytes_per_record=12, budget_bytes=group_budget_bytes,
        group_size=group_size, sigma_scale=2.9,  # boundary keys join in
        # groups of <= 8 per (k-1)-mer: sqrt(8) deviation inflation
    )
    if slack is not None:  # explicit multiplicative override (tests)
        cap_bp = min(
            rec_per_chunk,
            int(np.ceil(rec_per_chunk / partitions * slack)) + 1,
        )

    def chunk_records(c):
        s = c * chunk_nodes
        chi = khi[s : s + chunk_nodes]
        clo = klo[s : s + chunk_nodes]
        cva = valid[s : s + chunk_nodes]
        if keys_hosted:
            chi, clo, cva = (
                jax.device_put(chi), jax.device_put(clo), jax.device_put(cva)
            )
        return _chunk_boundary_records(
            chi, clo, cva, jnp.int32(c * chunk_nodes), k=k,
            chunk_nodes=chunk_nodes,
        )

    if park_links:
        next_host = np.full(2 * n_padded, -1, dtype=np.int32)
        next_state = None
    else:
        next_state = jnp.full(2 * n_padded, -1, dtype=jnp.int32)

    def emit_partition(p, cat_hi, cat_lo, cat_pay):
        nonlocal next_state
        t0 = _time.perf_counter()
        src, dst = _partition_edges(cat_hi, cat_lo, cat_pay)
        ne = -1
        if park_links:
            src_c, dst_c, n_edges = _compact_edges(src, dst)
            del src, dst
            ne = int(n_edges)  # hard sync; sort temporaries freed
            src_h = np.asarray(src_c[:ne]).astype(np.int64)
            dst_h = np.asarray(dst_c[:ne]).astype(np.int32)
            del src_c, dst_c
            next_host[src_h] = dst_h
        else:
            next_state = _scatter_edges(next_state, src, dst)
            del src, dst
        if on_event is not None:
            on_event(
                "link_partition", p=p,
                wall_s=round(_time.perf_counter() - t0, 3), n_edges=ne,
            )

    ovf_total = 0
    n_groups = (partitions + G - 1) // G
    for g in range(n_groups):
        t_sweep = _time.perf_counter()
        pieces = [([], [], []) for _ in range(G)]
        ovf_dev = jnp.zeros((G,), jnp.int32)
        for c in range(n_chunks):
            rk_hi, rk_lo, rpay = chunk_records(c)
            ghi, glo, gpay, ovf = outofcore.extract_partition_range3(
                rk_hi, rk_lo, rpay, jnp.uint32(g),
                partitions=partitions, group_size=G, cap_bp=cap_bp,
            )
            for r in range(G):
                pieces[r][0].append(ghi[r])
                pieces[r][1].append(glo[r])
                pieces[r][2].append(gpay[r])
            ovf_dev = ovf_dev + ovf.astype(jnp.int32)
        ovf_host = np.asarray(ovf_dev)
        if on_event is not None:
            on_event(
                "link_pass", g=g, chunks=n_chunks,
                wall_s=round(_time.perf_counter() - t_sweep, 3),
            )

        overflowed = []
        for r in range(G):
            p = g * G + r
            if p >= partitions:
                pieces[r] = None
                continue
            if slack is None and int(ovf_host[r]):
                # statistical cap missed: withhold this partition's edges
                # (its staging is incomplete) and re-extract it alone with
                # an escalated cap once the group's staging frees -- see
                # _reextract_partition3.
                pieces[r] = None
                overflowed.append(p)
                continue
            ovf_total += int(ovf_host[r])
            cat_hi = jnp.concatenate(pieces[r][0])
            cat_lo = jnp.concatenate(pieces[r][1])
            cat_pay = jnp.concatenate(pieces[r][2])
            pieces[r] = None  # free staging before the partition sort
            emit_partition(p, cat_hi, cat_lo, cat_pay)
            del cat_hi, cat_lo, cat_pay
        for p in overflowed:
            if on_event is not None:
                on_event("link_reextract", p=p)
            cat_hi, cat_lo, cat_pay = _reextract_partition3(
                chunk_records, n_chunks, p,
                partitions=partitions, cap0=cap_bp,
                rec_per_chunk=rec_per_chunk,
            )
            emit_partition(p, cat_hi, cat_lo, cat_pay)
            del cat_hi, cat_lo, cat_pay
    if park_links:
        return next_host[: 2 * n], ovf_total
    return next_state[: 2 * n], ovf_total


@jax.jit
def pointer_jump(next_state: jnp.ndarray) -> CompactedGraph:
    """List-rank the unitig chains: head id + rank per state.

    Pointer doubling over *predecessor* links with head-absorbing
    self-loops: after ceil(log2(2N)) rounds every acyclic state has jumped
    to its chain head with its distance accumulated.  Cycles (no head)
    adopt the minimum state id on the cycle -- propagated by the same
    doubling -- as a deterministic representative.
    """
    n2 = next_state.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
    ids = jnp.arange(n2, dtype=jnp.int32)

    # Unique predecessor (in-degree <= 1 by the unitig-edge rule).
    # Scatter with an out-of-range index for "no link" so nothing real is
    # clobbered.
    pred = jnp.full(n2, -1, dtype=jnp.int32)
    src = jnp.where(next_state >= 0, next_state, n2)
    pred = pred.at[src].set(ids, mode="drop", unique_indices=True)

    # Head-absorbing parent: heads (pred == -1) self-loop with rank 0.
    parent = jnp.where(pred >= 0, pred, ids)
    rank = (pred >= 0).astype(jnp.int32)
    min_id = jnp.minimum(ids, parent)

    # Doubling with early exit: rounds needed = log2(longest chain), which
    # on real data is far below log2(2N) (only a genome-spanning unitig
    # needs them all); parents of acyclic states stop changing once
    # absorbed, and cycles keep rotating, so "no parent moved" is exact
    # convergence for the acyclic part while cycle min-propagation is
    # already complete by then (the window covers the whole cycle).
    def cond(carry):
        _, _, _, r, changed = carry
        return (r < steps) & changed

    def body(carry):
        parent, rank, min_id, r, _ = carry
        # ONE row gather of [2N, 3] rows instead of three 1-D gathers
        tbl = jnp.stack([parent, rank, min_id], axis=1)
        g = tbl[parent]
        parent2 = g[:, 0]
        rank2 = rank + g[:, 1]
        min2 = jnp.minimum(min_id, g[:, 2])
        changed = jnp.any(parent2 != parent)
        return parent2, rank2, min2, r + 1, changed

    parent, rank, min_id, _, _ = lax.while_loop(
        cond, body, (parent, rank, min_id, jnp.int32(0), jnp.bool_(True))
    )

    # Acyclic states absorbed at the head (whose pred is -1).  Cyclic
    # states' parent is still somewhere on the cycle: pred[parent] >= 0.
    is_cycle = pred[parent] >= 0
    head = jnp.where(is_cycle, min_id, parent)
    # Cycle ranks would be a function of the round count (the early exit
    # above stops as soon as parents stabilize, which for a 2^j-cycle is
    # earlier than the fixed bound): zero them so every implementation --
    # early-exit, fixed-round, sharded, partitioned -- agrees exactly.
    # Consumers re-rank cycles by walking them (materialize_unitigs).
    rank = jnp.where(is_cycle, 0, rank)
    return CompactedGraph(
        next_state=next_state, head=head, rank=rank, is_cycle=is_cycle
    )


@functools.partial(jax.jit, static_argnames=("lanes",))
def _jump_init(next_state: jnp.ndarray, lanes: int = 2):
    n2 = next_state.shape[0]
    ids = jnp.arange(n2, dtype=jnp.int32)
    pred = jnp.full(n2, -1, dtype=jnp.int32)
    src = jnp.where(next_state >= 0, next_state, n2)
    pred = pred.at[src].set(ids, mode="drop", unique_indices=True)
    parent = jnp.where(pred >= 0, pred, ids)
    rank = (pred >= 0).astype(jnp.int32)
    cols = [parent, rank]
    if lanes == 3:
        cols.append(jnp.minimum(ids, parent))
    return jnp.stack(cols, axis=1), pred


@functools.partial(jax.jit, donate_argnums=(0,))
def _jump_round(tbl: jnp.ndarray):
    parent = tbl[:, 0]
    g = tbl[parent]
    cols = [g[:, 0], tbl[:, 1] + g[:, 1]]
    if tbl.shape[1] == 3:
        cols.append(jnp.minimum(tbl[:, 2], g[:, 2]))
    new = jnp.stack(cols, axis=1)
    return new, jnp.any(new[:, 0] != parent)


@functools.partial(jax.jit, static_argnames=("n_chunks",), donate_argnums=(1,))
def _jump_round_lowmem(tbl: jnp.ndarray, out: jnp.ndarray, *, n_chunks: int):
    """One doubling round at minimum live memory: OLD table + NEW table.

    ``_jump_round``'s whole-array gather materializes a full-size
    temporary next to the (aliased) carry -- 4.8 GB live at 200M states
    (compiled memory_analysis), on top of ~3 GB of pipeline residency.
    Doubling cannot be done in place (late chunks gather rows early
    chunks would have overwritten), so the floor is two tables; this
    kernel reaches it by processing the output in ``n_chunks`` slices
    inside one fori_loop -- gather temporaries are chunk-sized.  ``out``
    is donated; callers ping-pong two buffers across rounds.
    """
    rows = tbl.shape[0] // n_chunks
    lanes = tbl.shape[1]

    def body(c, carry):
        out, changed = carry
        sl = lax.dynamic_slice_in_dim(tbl, c * rows, rows)
        parent = sl[:, 0]
        g = tbl[parent]
        cols = [g[:, 0], sl[:, 1] + g[:, 1]]
        if lanes == 3:
            cols.append(jnp.minimum(sl[:, 2], g[:, 2]))
        new = jnp.stack(cols, axis=1)
        changed = changed | jnp.any(new[:, 0] != parent)
        out = lax.dynamic_update_slice(out, new, (c * rows, 0))
        return out, changed

    return lax.fori_loop(0, n_chunks, body, (out, jnp.bool_(False)))


@functools.partial(jax.jit, donate_argnums=(1,))
def _jump_finish(tbl: jnp.ndarray, pred: jnp.ndarray, next_state: jnp.ndarray):
    # pred is donated (it aliases one int32[n2] output); tbl is not -- a
    # [n2, 2] buffer can alias none of the 1-D outputs, and XLA would
    # just warn "donated buffer not usable"
    parent = tbl[:, 0]
    is_cycle = pred[parent] >= 0
    min_lane = tbl[:, 2] if tbl.shape[1] == 3 else parent
    head = jnp.where(is_cycle, min_lane, parent)
    rank = jnp.where(is_cycle, 0, tbl[:, 1])
    return CompactedGraph(
        next_state=next_state, head=head, rank=rank, is_cycle=is_cycle
    )


def pointer_jump_bulk(
    next_state: jnp.ndarray,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 4,
    lowmem_chunks: int | None = None,
    on_round=None,
) -> CompactedGraph:
    """pointer_jump for HUGE graphs: identical results, lower peak memory.

    The fused while_loop version double-buffers three full-size loop
    carries plus the gather table -- too much at chromosome scale (268M
    states exceed a 16 GB budget).  Here each doubling round is its own
    jitted call, and early exit reads one scalar per round (~28 host round
    trips at most -- negligible against the gathers it gates).

    lowmem_chunks > 0 (auto above 2^27 states) switches rounds to
    ``_jump_round_lowmem``: two ping-ponged [n2, lanes] tables and
    chunk-sized gather temporaries -- the in-place floor for doubling
    (late chunks must gather rows early chunks would have overwritten).
    The whole-array ``_jump_round`` holds 4.8 GB live at 200M states
    next to ~3 GB pipeline residency; the chunked form holds ~3.3 GB
    flat.  States are padded to
    a chunk multiple with self-absorbed isolates (invisible to results
    and to early exit; outputs are sliced back).

    The common acyclic case runs with TWO lanes (parent, rank); the cycle
    representative (min state id on the cycle) needs a min lane carried
    through every round, so when cycles are detected the doubling reruns
    once with three lanes.  Real assemblies at k=31 are overwhelmingly
    acyclic, and the rerun costs exactly one more pass over the same
    graph when they are not.

    checkpoint_dir: per-extension-round frontier checkpoints (SURVEY.md
    section 5.4): every ``checkpoint_every`` doubling rounds the [2N,
    lanes] table lands on disk (atomic rename), fingerprinted against the
    exact link array, so a killed chromosome-scale jump resumes at its
    last saved round instead of round 0.  Rounds are idempotent given the
    table (absorbed states gather rank 0 from their head), so a resumed
    run is bit-identical to an uninterrupted one.  Frontiers are stored
    unpadded, so checkpoints are portable across lowmem_chunks settings.

    on_round: optional callback ``(round_index, wall_seconds)`` fired
    after each doubling round (scale runs log per-round progress).
    """
    import time as _time

    n2 = next_state.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
    if lowmem_chunks is None:
        lowmem_chunks = 8 if n2 > (1 << 27) else 0

    fp = None
    if checkpoint_dir is not None:
        from genome_assembly_tpu.utils import checkpoint as ckpt_mod

        fp = ckpt_mod.jump_fingerprint(next_state)

    n2p = n2
    ns_run = next_state
    if lowmem_chunks:
        n2p = int(np.ceil(n2 / lowmem_chunks)) * lowmem_chunks
        if n2p != n2:
            ns_run = jnp.concatenate(
                [next_state, jnp.full((n2p - n2,), -1, jnp.int32)]
            )

    def pad_frontier(a):
        """Pad a host frontier array to n2p with self-absorbed rows."""
        a = np.asarray(a)
        if a.shape[0] == n2p:
            return jnp.asarray(a)
        pad_ids = np.arange(a.shape[0], n2p, dtype=np.int32)
        if a.ndim == 2:
            cols = [pad_ids, np.zeros_like(pad_ids)]
            if a.shape[1] == 3:
                cols.append(pad_ids)
            pad = np.stack(cols, axis=1)
        else:  # pred: pad rows have no predecessor
            pad = np.full(n2p - a.shape[0], -1, np.int32)
        return jnp.concatenate([jnp.asarray(a), jnp.asarray(pad)])

    def run(lanes):
        start = 0
        tbl = pred = None
        if fp is not None:
            from genome_assembly_tpu.utils import checkpoint as ckpt_mod

            saved = ckpt_mod.load_jump_frontier(checkpoint_dir, lanes, fp)
            if saved is not None:
                tbl_h, pred_h, start = saved
                tbl = pad_frontier(tbl_h)
                pred = pad_frontier(pred_h)
        if tbl is None:
            tbl, pred = _jump_init(ns_run, lanes)
        out = jnp.zeros_like(tbl) if lowmem_chunks else None
        for r in range(start, steps):
            t0 = _time.perf_counter()
            if lowmem_chunks:
                new_tbl, changed = _jump_round_lowmem(
                    tbl, out, n_chunks=lowmem_chunks
                )
                tbl, out = new_tbl, tbl
            else:
                tbl, changed = _jump_round(tbl)
            done = not bool(changed)  # scalar readback = hard sync
            if on_round is not None:
                on_round(r, _time.perf_counter() - t0)
            if fp is not None and not done and (r + 1) % checkpoint_every == 0:
                from genome_assembly_tpu.utils import checkpoint as ckpt_mod

                ckpt_mod.save_jump_frontier(
                    checkpoint_dir,
                    np.asarray(tbl)[:n2],
                    np.asarray(pred)[:n2],
                    r + 1,
                    lanes,
                    fp,
                )
            if done:
                break
        del out
        graph = _jump_finish(tbl, pred, ns_run)
        if n2p != n2:
            graph = CompactedGraph(
                next_state=next_state,
                head=graph.head[:n2],
                rank=graph.rank[:n2],
                is_cycle=graph.is_cycle[:n2],
            )
        elif lowmem_chunks:
            graph = graph._replace(next_state=next_state)
        return graph

    graph = run(2)
    if bool(jnp.any(graph.is_cycle)):
        del graph  # free before the wider rerun
        graph = run(3)
    return graph


_CODE_CHARS = np.frombuffer(b"TGCA", dtype=np.uint8)


def materialize_unitigs(
    khi: np.ndarray,
    klo: np.ndarray,
    valid: np.ndarray,
    graph: CompactedGraph,
    k: int,
) -> List[str]:
    """Host-side unitig assembly from chain assignments.

    Devices keep fixed shapes; the ragged string assembly happens here
    (SURVEY.md section 7 "variable-length unitigs on fixed-shape buffers"),
    fully vectorized in numpy: states are lexsorted by (head, rank), chain
    boundaries come from head changes, and all characters land in one flat
    byte buffer in a single pass.  Each unitig appears once: of the two
    strand traversals, the canonical (lexicographically smaller) one is
    kept; palindromic unitigs and cycle rotations are deduped explicitly.
    """
    unitigs, _, _ = _materialize(khi, klo, valid, graph, k, None)
    return unitigs


def materialize_unitigs_cov(
    khi: np.ndarray,
    klo: np.ndarray,
    valid: np.ndarray,
    graph: CompactedGraph,
    k: int,
    node_counts: np.ndarray,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """materialize_unitigs plus per-unitig abundance coverage.

    node_counts: per-node occurrence counts aligned with khi/klo rows
    (count.kept_keys_sorted_with_counts).  Returns (unitigs, occ_sum,
    n_kmers): occ_sum[i] is the total occurrence count of unitig i's
    constituent canonical k-mers and n_kmers[i] their number, so mean
    coverage is occ_sum / n_kmers -- the abundance signal the reference
    carries as per-BP read-id lists (binning.c:857-888).
    """
    return _materialize(khi, klo, valid, graph, k, np.asarray(node_counts))


_ASCII_TGCA = np.frombuffer(b"TGCA", dtype=np.uint8)


@jax.jit
def _count_cycle_nodes(valid, is_cycle):
    """Valid cycle-node count (flat gather; see _materialize_prep_sort)."""
    sid = jnp.arange(is_cycle.shape[0], dtype=jnp.int32)
    return jnp.sum((is_cycle & valid[sid >> 1]).astype(jnp.int32))


@functools.partial(jax.jit, donate_argnums=(1, 2, 3))
def _materialize_prep_sort(valid, head, rank, is_cycle):
    """Device walk sort for materialize_unitigs_device.

    Sorts linear valid states into (head, rank) walk order; invalid and
    cycle rows sort to a sentinel tail.  Returns (sid_s, chain_start,
    n_lin, n_cyc).  Split from the byte-extraction pass so the 3-lane
    full-length sort's temporaries are dead before the key gather runs
    -- fused, the two together exceed a 16 GB budget at 200M states next
    to the resident graph.  head/rank/is_cycle are DONATED (4.5 GB at
    chr1 scale): the caller pre-reads whatever the cycle path needs, and
    the 3-lane sort's outputs reuse the donated buffers -- without this
    the sort's operands+outputs alone exceed 16 GB at 500M states.
    """
    n2 = head.shape[0]
    sid = jnp.arange(n2, dtype=jnp.int32)
    # flat gather, NOT jnp.repeat(valid, 2): no [N, 2] pred
    # intermediate is materialized
    node_valid = valid[sid >> 1]
    lin = node_valid & ~is_cycle
    big = jnp.int32(0x7FFFFFFF)
    key_head = jnp.where(lin, head, big)
    key_rank = jnp.where(lin, rank, big)
    h_s, _, sid_s = lax.sort((key_head, key_rank, sid), num_keys=2)
    prev = jnp.concatenate([jnp.full((1,), -2, jnp.int32), h_s[:-1]])
    chain_start = (h_s != prev) & (h_s != big)
    n_lin = jnp.sum((h_s != big).astype(jnp.int32))
    n_cyc = jnp.sum((is_cycle & node_valid).astype(jnp.int32))
    return sid_s, chain_start, n_lin, n_cyc


@jax.jit
def _materialize_prep_compact(sid_s, chain_start):
    """Compact chain-start info so the host never reads the big lanes.

    Returns (pos_s, sid_h, n_chains): ascending chain-start positions and
    the head state id at each, both compacted to the front of 2N-sized
    arrays (one 2-lane device sort).  The host slices the first n_chains
    of each -- a readback of O(chains) ints instead of the full sorted
    state-id lane (800 MB at celegans scale).
    """
    n2 = sid_s.shape[0]
    idx = jnp.arange(n2, dtype=jnp.int32)
    big = jnp.int32(0x7FFFFFFF)
    key = jnp.where(chain_start, idx, big)
    pos_s, sid_h = lax.sort((key, sid_s), num_keys=1)
    n_chains = jnp.sum(chain_start.astype(jnp.int32))
    return pos_s, sid_h, n_chains


@functools.partial(jax.jit, static_argnames=("k",))
def _materialize_prep_bytes(khi, klo, sid_s, *, k):
    """Per-state output BYTE in walk order (second prep pass).

    A state's contribution is its value's last base as ASCII: forward
    states end in klo & 3, rc states in the complement of the forward
    k-mer's FIRST base -- complement == 3 - code in the T=0 G=1 C=2 A=3
    encoding.
    """
    node = sid_s >> 1
    strand = sid_s & 1
    keys = jnp.stack([khi, klo], axis=1)[node]  # one row gather, not two
    khi_g, klo_g = keys[:, 0], keys[:, 1]
    n_lo = min(k, 16)
    if k > n_lo:
        first_code = (khi_g >> (2 * (k - n_lo) - 2)) & 3
    else:
        first_code = (klo_g >> (2 * k - 2)) & 3
    code = jnp.where(strand == 0, klo_g & 3, 3 - first_code)
    return jnp.asarray(_ASCII_TGCA)[code.astype(jnp.int32)]


def materialize_unitigs_device(
    khi,
    klo,
    valid,
    graph: CompactedGraph,
    k: int,
    node_counts=None,
    donate: bool = False,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """materialize_unitigs(_cov) with the heavy steps on device.

    The host reference path reads the whole graph back (3.2 GB at
    chromosome scale), runs a k-step reverse-complement loop over all 2N
    values, and lexsorts 2N states -- 517 s at celegans scale, almost all
    of it readback + rc + lexsort.  Here the (head, rank) walk sort and
    per-state byte extraction run on device; the host reads back one
    uint8 byte lane, one bool lane, and the sorted state ids, then does a
    single vectorized placement pass.  The k-step rc loop runs only for
    chain-head states.  Identical output to materialize_unitigs /
    materialize_unitigs_cov (differential-tested, including cycles and
    palindromes); cycles fall back to the shared host cycle path.

    Returns (unitigs, occ_sums, n_kmers); the count arrays are empty when
    node_counts is None.

    donate=True CONSUMES the graph's head/rank/is_cycle device buffers
    and eagerly drops next_state (the cycle path reads it back first)
    (donated into the walk sort, saving 4.5 GB of sort headroom at chr1
    scale); the caller must not touch ``graph`` afterwards.  The default
    passes copies into the donating jit, trading that headroom for
    caller safety.
    """
    # the prep sort DONATES head/rank/is_cycle, so anything the cycle
    # path needs must be read back BEFORE it runs (cycles are rare; the
    # count itself is one cheap reduction)
    valid_j = jnp.asarray(valid)
    n_cyc = int(_count_cycle_nodes(valid_j, jnp.asarray(graph.is_cycle)))
    next_np = head_np = cyc_states = None
    if n_cyc:
        next_np = np.asarray(graph.next_state)
        head_np = np.asarray(graph.head)
        cyc_states = np.flatnonzero(
            np.asarray(graph.is_cycle) & np.repeat(np.asarray(valid), 2)
        )
    if donate:
        # The donate contract already forbids the caller from touching
        # ``graph`` afterwards; drop the next_state lane eagerly too (the
        # cycle path read back what it needs above).  2 GB of walk-sort
        # headroom at chr1 scale -- the compact step OOM'd next to it.
        try:
            graph.next_state.delete()
        except AttributeError:
            pass  # host numpy graphs have no device buffer to drop

    def _arm(x):
        x = jnp.asarray(x)
        return x if donate else jnp.array(x, copy=True)

    sid_s, chain_start, n_lin, _ = _materialize_prep_sort(
        valid_j, _arm(graph.head), _arm(graph.rank), _arm(graph.is_cycle)
    )
    n_lin = int(n_lin)  # hard sync: the sort pass's temporaries are freed
    byte_s = _materialize_prep_bytes(
        jnp.asarray(khi), jnp.asarray(klo), sid_s, k=k
    )
    khi_u = np.asarray(khi, dtype=np.uint64)
    klo_u = np.asarray(klo, dtype=np.uint64)

    cycle_strings: List[str] = []
    cycle_sums: List[int] = []
    cycle_lens: List[int] = []
    if n_cyc:
        cycle_strings, cycle_sums, cycle_lens = _materialize_cycles(
            next_np, head_np, cyc_states,
            _host_state_vals(khi_u, klo_u, k, cyc_states), k, node_counts,
        )

    if n_lin == 0:
        return (
            cycle_strings,
            np.asarray(cycle_sums, dtype=np.int64),
            np.asarray(cycle_lens, dtype=np.int64),
        )

    if node_counts is None:
        # thin-readback path: the ASCII byte lane is the only big
        # transfer.  Chain starts + head state ids come back compacted
        # (O(chains) ints); chain geometry is rebuilt from starts alone.
        try:
            pos_s, sid_h, n_chains_dev = _materialize_prep_compact(
                sid_s, chain_start
            )
            n_chains = int(n_chains_dev)
        except Exception as exc:
            if "RESOURCE_EXHAUSTED" not in str(exc):
                raise
            # The compact OOM'd AFTER the (possibly donating) walk sort
            # consumed the graph lanes, so the caller cannot rebuild and
            # retry -- but sid_s/chain_start/byte_s are alive, which is
            # everything the fat sid-readback placement (the coverage
            # path below) needs.  Rescue there instead of losing a
            # multi-hour run at its very last device step.
            n_chains = -1
    if node_counts is None and n_chains >= 0:
        starts = np.asarray(pos_s[:n_chains]).astype(np.int64)
        head_sids = np.asarray(sid_h[:n_chains])
        byte_np = np.asarray(byte_s[:n_lin])

        chain_lens = np.diff(np.append(starts, n_lin))
        out_lens = chain_lens + (k - 1)
        out_off = np.zeros(n_chains + 1, dtype=np.int64)
        np.cumsum(out_lens, out=out_off[1:])
        buf = np.empty(out_off[-1], dtype=np.uint8)

        # head states contribute their first k-1 bases as the chain
        # prefix; their LAST base arrives through the byte lane like any
        # other state's, so the body placement below is uniform
        first_vals = _host_state_vals(khi_u, klo_u, k, head_sids)
        for j in range(k - 1):
            shift = np.uint64(2 * (k - 1 - j))
            buf[out_off[:-1] + j] = _CODE_CHARS[
                ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
            ]
        chain_id = np.repeat(
            np.arange(n_chains, dtype=np.int64), chain_lens
        )
        local_i = np.arange(n_lin, dtype=np.int64) - starts[chain_id]
        buf[out_off[chain_id] + (k - 1) + local_i] = byte_np

        return _canonical_chain_strings(
            buf.tobytes(), out_off, chain_lens, None,
            cycle_strings, cycle_sums, cycle_lens,
        )

    # coverage path (or the compact-OOM rescue above): per-chain sums
    # need int64 accumulation over every state's node counts (x64 is
    # disabled on device), so the state-id lane readback stays
    sid_np = np.asarray(sid_s)[:n_lin]
    byte_np = np.asarray(byte_s)[:n_lin]
    cs_np = np.asarray(chain_start)[:n_lin]

    starts = np.flatnonzero(cs_np)
    chain_lens = np.diff(np.append(starts, n_lin))
    out_lens = chain_lens + (k - 1)
    out_off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_off[1:])
    buf = np.empty(out_off[-1], dtype=np.uint8)

    first_vals = _host_state_vals(khi_u, klo_u, k, sid_np[starts])
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        buf[out_off[:-1] + j] = _CODE_CHARS[
            ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
        ]
    # non-start states: sorted order == walk order, so each chain's body
    # bytes are already contiguous; place them at off + k-1 + local index
    chain_id = np.cumsum(cs_np) - 1
    local_i = np.arange(n_lin, dtype=np.int64) - starts[chain_id]
    ns = ~cs_np
    buf[out_off[chain_id[ns]] + (k - 1) + local_i[ns]] = byte_np[ns]

    if node_counts is None:
        chain_sums = None  # rescue path: no coverage channel requested
    else:
        node_counts = np.asarray(node_counts)
        chain_sums = np.add.reduceat(
            node_counts[sid_np >> 1].astype(np.int64), starts
        )

    return _canonical_chain_strings(
        buf.tobytes(), out_off, chain_lens, chain_sums,
        cycle_strings, cycle_sums, cycle_lens,
    )


def _host_state_vals(
    khi: np.ndarray, klo: np.ndarray, k: int, sids: np.ndarray
) -> np.ndarray:
    """uint64 packed 2k-bit values of the given STATE ids (node = sid >> 1,
    odd sid = reverse complement).  Vectorized over just the requested
    states, so callers pay the k-step rc loop only for the states they
    materialize (chain heads + cycle members), not all 2N."""
    n_lo = min(k, 16)
    kmask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    node = (sids >> 1).astype(np.int64)
    v = (khi[node].astype(np.uint64) << np.uint64(2 * n_lo)) | klo[node]
    odd = (sids & 1).astype(bool)
    if odd.any():
        comp = kmask - v[odd]  # complement per 2-bit group == mask - v
        out = np.zeros_like(comp)
        for j in range(k):
            out = (out << np.uint64(2)) | (
                (comp >> np.uint64(2 * j)) & np.uint64(3)
            )
        v = v.copy()
        v[odd] = out
    return v


def materialize_unitigs_partitioned(
    khi: np.ndarray,
    klo: np.ndarray,
    valid: np.ndarray,
    graph: CompactedGraph,
    k: int,
    partitions: int = 8,
) -> List[str]:
    """materialize_unitigs with bounded per-bucket host memory.

    Chains are bucketed by a hash of their head id (a chain is atomic
    under head bucketing) and each bucket runs the flat-buffer placement
    pass over ONLY its own states, so peak host memory beyond the input
    arrays is O(total/partitions).  This is the single-host rehearsal
    form of config 5's distributed materialization: at pod scale each
    host receives exactly the state records of the chains it owns
    (routed by head hash -- the same exchange shape as the sharded
    count) and streams buckets through this pass.  Same output SET as
    ``materialize_unitigs`` (bucket order differs); palindromic twins
    are deduped by the chain-invariant rule "emit from the twin whose
    head id is smaller" instead of the cross-chain set, so no bucket
    ever needs another bucket's output.  Accepts int64 graph arrays
    (the wide-id pipeline's host conversion) unchanged.
    """
    khi_u = np.asarray(khi, dtype=np.uint64)
    klo_u = np.asarray(klo, dtype=np.uint64)
    valid = np.asarray(valid)
    head = np.asarray(graph.head)
    rank = np.asarray(graph.rank).astype(np.int64)
    is_cycle = np.asarray(graph.is_cycle)
    node_valid = np.repeat(valid, 2)

    out: List[str] = []
    # cycles: rare on real data; the shared host cycle path runs once,
    # unbucketed (bucketing them too would only need routing by cycle
    # head, which graph.head already is)
    cyc_states = np.flatnonzero(is_cycle & node_valid)
    if cyc_states.size:
        cs, _, _ = _materialize_cycles(
            np.asarray(graph.next_state), head, cyc_states,
            _host_state_vals(khi_u, klo_u, k, cyc_states), k, None,
        )
        out.extend(cs)

    lin_states = np.flatnonzero(node_valid & ~is_cycle)
    if lin_states.size == 0:
        return out
    # multiplicative hash over head ids (int64-safe for the wide path)
    hb = (
        head[lin_states].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        >> np.uint64(40)
    ) % np.uint64(partitions)

    n_lo = min(k, 16)
    for b in range(partitions):
        sel = lin_states[hb == np.uint64(b)]
        if sel.size == 0:
            continue
        order = np.lexsort((rank[sel], head[sel]))
        s_sorted = sel[order]
        h_sorted = head[sel][order]
        chain_start = np.empty(len(s_sorted), dtype=bool)
        chain_start[0] = True
        chain_start[1:] = h_sorted[1:] != h_sorted[:-1]
        starts = np.flatnonzero(chain_start)
        chain_lens = np.diff(np.append(starts, len(s_sorted)))
        out_lens = chain_lens + (k - 1)
        out_off = np.zeros(len(starts) + 1, dtype=np.int64)
        np.cumsum(out_lens, out=out_off[1:])
        buf = np.empty(out_off[-1], dtype=np.uint8)

        # per-state LAST base, no rc loop: forward states end in klo & 3,
        # rc states in 3 - first_code (complement == 3 - code in the
        # T=0 G=1 C=2 A=3 encoding)
        node = s_sorted >> 1
        strand = s_sorted & 1
        khi_g = khi_u[node]
        klo_g = klo_u[node]
        if k > n_lo:
            first_code = (khi_g >> np.uint64(2 * (k - n_lo) - 2)) & np.uint64(3)
        else:
            first_code = (klo_g >> np.uint64(2 * k - 2)) & np.uint64(3)
        code = np.where(
            strand == 0, klo_g & np.uint64(3), np.uint64(3) - first_code
        )
        byte_np = _CODE_CHARS[code.astype(np.int64)]

        # chain prefixes: the head state's first k-1 bases (the rc loop
        # runs only for heads); its last base arrives via the byte lane
        # like any other state's, so body placement is uniform
        head_sids = s_sorted[starts]
        first_vals = _host_state_vals(khi_u, klo_u, k, head_sids)
        for j in range(k - 1):
            shift = np.uint64(2 * (k - 1 - j))
            buf[out_off[:-1] + j] = _CODE_CHARS[
                ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
            ]
        chain_id = np.cumsum(chain_start) - 1
        local_i = np.arange(len(s_sorted), dtype=np.int64) - starts[chain_id]
        buf[out_off[chain_id] + (k - 1) + local_i] = byte_np

        # twin chain's head = (this chain's last state) ^ 1: the
        # palindrome tiebreak needs no cross-bucket state
        last_sids = s_sorted[starts + chain_lens - 1]
        data = buf.tobytes()
        for c in range(len(starts)):
            u = data[out_off[c] : out_off[c + 1]].decode()
            rc_u = _rc_str(u)
            if u > rc_u:
                continue
            if u == rc_u and not int(head_sids[c]) < int(last_sids[c] ^ 1):
                continue
            out.append(u)
    return out


def _materialize_cycles(
    next_state: np.ndarray,
    head: np.ndarray,
    cyc_states: np.ndarray,
    vals_c: np.ndarray,
    k: int,
    node_counts,
) -> Tuple[List[str], List[int], List[int]]:
    """Vectorized cycle-unitig assembly (see _materialize's docstring).

    Ranks around each cycle come from host pointer doubling (the jump
    zeroes cycle ranks for cross-implementation determinism,
    dbg.pointer_jump), then the same flat-buffer assembly as linear
    chains spells every traversal at once.  Twin traversals (forward and
    reverse-complement strands of one unitig cycle) are deduped by their
    minimum member NODE id -- a traversal invariant, since edge u->v
    implies rc edge v^1->u^1, so both strand cycles visit exactly the
    twin state set.  vals_c: uint64 packed values aligned with
    cyc_states.
    """
    m = cyc_states.size
    n2 = next_state.shape[0]
    comp = np.full(n2, -1, dtype=np.int64)
    comp[cyc_states] = np.arange(m, dtype=np.int64)
    nxt_c = comp[next_state[cyc_states]]
    # in/out-degree <= 1 (unitig edge rule): cycle states form pure
    # permutation cycles, never rho shapes
    assert (nxt_c >= 0).all(), "cycle state links outside the cycle set"
    head_c = head[cyc_states].astype(np.int64)
    is_head = cyc_states == head_c
    pred_c = np.empty(m, dtype=np.int64)
    pred_c[nxt_c] = np.arange(m, dtype=np.int64)
    # head-absorbing predecessor doubling: rank[s] = distance from the
    # cycle's head (min state id) to s along next_state
    parent = np.where(is_head, np.arange(m, dtype=np.int64), pred_c)
    crank = (~is_head).astype(np.int64)
    while True:
        crank = crank + crank[parent]
        new_parent = parent[parent]
        if np.array_equal(new_parent, parent):
            break
        parent = new_parent

    order_c = np.lexsort((crank, head_c))
    s_c = cyc_states[order_c]  # global state ids in walk order
    v_c = vals_c[order_c]
    h_c = head_c[order_c]
    r_c = crank[order_c]
    start_mask = np.empty(m, dtype=bool)
    start_mask[0] = True
    start_mask[1:] = h_c[1:] != h_c[:-1]
    startsc = np.flatnonzero(start_mask)
    lens_c = np.diff(np.append(startsc, m))
    # one traversal per unitig cycle: first chain (ascending head order ==
    # the one the old ascending-head walk emitted) per min-member-node key
    min_node = np.minimum.reduceat(s_c >> 1, startsc)
    _, first_idx = np.unique(min_node, return_index=True)
    keep_idx = np.sort(first_idx)
    k_lens = lens_c[keep_idx]
    out_lens_c = k_lens + (k - 1)
    off_c = np.zeros(len(keep_idx) + 1, dtype=np.int64)
    np.cumsum(out_lens_c, out=off_c[1:])
    buf_c = np.empty(off_c[-1], dtype=np.uint8)
    first_vals = v_c[startsc[keep_idx]]
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        buf_c[off_c[:-1] + j] = _CODE_CHARS[
            ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
        ]
    chain_id_c = np.cumsum(start_mask) - 1
    kept_pos = np.full(len(startsc), -1, dtype=np.int64)
    kept_pos[keep_idx] = np.arange(len(keep_idx))
    sel = (kept_pos[chain_id_c] >= 0) & ~start_mask
    pos_c = off_c[kept_pos[chain_id_c[sel]]] + (k - 1) + r_c[sel]
    buf_c[pos_c] = _CODE_CHARS[(v_c[sel] & np.uint64(3)).astype(np.int64)]
    all_bytes_c = buf_c.tobytes()
    cycle_strings = [
        all_bytes_c[off_c[i] : off_c[i + 1]].decode()
        for i in range(len(keep_idx))
    ]
    cycle_sums: List[int] = []
    cycle_lens: List[int] = []
    if node_counts is not None:
        sums_all = np.add.reduceat(
            node_counts[s_c >> 1].astype(np.int64), startsc
        )
        cycle_sums = [int(x) for x in sums_all[keep_idx]]
        cycle_lens = [int(x) for x in k_lens]
    return cycle_strings, cycle_sums, cycle_lens


def _canonical_chain_strings(
    all_bytes: bytes,
    out_off: np.ndarray,
    chain_lens: np.ndarray,
    chain_sums,
    cycle_strings: List[str],
    cycle_sums: List[int],
    cycle_lens: List[int],
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Strand-canonicalize linear chains (keep the lexicographically
    smaller of the two strand spellings; dedup palindromes) and append
    the cycle results."""
    unitigs: List[str] = []
    occ_sums: List[int] = []
    n_kmers: List[int] = []
    seen_palindromes = set()
    for c in range(len(out_off) - 1):
        u = all_bytes[out_off[c] : out_off[c + 1]].decode()
        rc_u = _rc_str(u)
        if u == rc_u:
            # palindromic unitig: both strand chains spell the same string;
            # keep exactly one (whole unitigs of even length can be
            # palindromic even though odd-k k-mers cannot)
            if u in seen_palindromes:
                continue
            seen_palindromes.add(u)
        elif u >= rc_u:
            continue
        unitigs.append(u)
        if chain_sums is not None:
            occ_sums.append(int(chain_sums[c]))
            n_kmers.append(int(chain_lens[c]))
    unitigs.extend(cycle_strings)
    occ_sums.extend(cycle_sums)
    n_kmers.extend(cycle_lens)
    return (
        unitigs,
        np.asarray(occ_sums, dtype=np.int64),
        np.asarray(n_kmers, dtype=np.int64),
    )


def _materialize(
    khi: np.ndarray,
    klo: np.ndarray,
    valid: np.ndarray,
    graph: CompactedGraph,
    k: int,
    node_counts,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    khi = np.asarray(khi, dtype=np.uint64)
    klo = np.asarray(klo, dtype=np.uint64)
    valid = np.asarray(valid)
    next_state = np.asarray(graph.next_state)
    head = np.asarray(graph.head)
    rank = np.asarray(graph.rank).astype(np.int64)
    is_cycle = np.asarray(graph.is_cycle)

    n = khi.shape[0]
    n_lo = min(k, 16)
    value = (khi << np.uint64(2 * n_lo)) | klo  # full 2k-bit packed value
    kmask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)

    def rc_val(v):
        out = np.zeros_like(v)
        comp = kmask - v  # complement per 2-bit group == mask - v
        for j in range(k):
            out = (out << np.uint64(2)) | ((comp >> np.uint64(2 * j)) & np.uint64(3))
        return out

    state_val = np.empty(2 * n, dtype=np.uint64)
    state_val[0::2] = value
    state_val[1::2] = rc_val(value)
    node_valid = np.repeat(valid, 2)

    # --- cycles: vectorized, like the linear chains below.  Ranks around
    # each cycle come from host pointer doubling (the jump zeroes cycle
    # ranks for cross-implementation determinism, dbg.pointer_jump), then
    # the same flat-buffer assembly spells every traversal at once.  Twin
    # traversals (forward and reverse-complement strands of one unitig
    # cycle) are deduped by their minimum member NODE id -- a traversal
    # invariant, since edge u->v implies rc edge v^1->u^1, so both strand
    # cycles visit exactly the twin state set.  This replaces the old
    # one-state-at-a-time walk + O(L^2) rotation canonicalization, which
    # degenerated on repeat-dense genomes where cycles are long/common.
    cyc_states = np.flatnonzero(is_cycle & node_valid)
    if cyc_states.size:
        cycle_strings, cycle_sums, cycle_lens = _materialize_cycles(
            next_state, head, cyc_states, state_val[cyc_states], k,
            node_counts,
        )
    else:
        cycle_strings, cycle_sums, cycle_lens = [], [], []

    # --- linear chains: vectorized assembly ---
    lin_mask = node_valid & ~is_cycle
    lin_states = np.flatnonzero(lin_mask)
    if lin_states.size == 0:
        return (
            cycle_strings,
            np.asarray(cycle_sums, dtype=np.int64),
            np.asarray(cycle_lens, dtype=np.int64),
        )

    order = np.lexsort((rank[lin_states], head[lin_states]))
    s_sorted = lin_states[order]
    h_sorted = head[lin_states][order]
    chain_start = np.empty(len(s_sorted), dtype=bool)
    chain_start[0] = True
    chain_start[1:] = h_sorted[1:] != h_sorted[:-1]
    starts = np.flatnonzero(chain_start)
    chain_lens = np.diff(np.append(starts, len(s_sorted)))
    out_lens = chain_lens + (k - 1)

    # flat byte buffer: chain c occupies [out_off[c], out_off[c] + out_lens[c])
    out_off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_off[1:])
    buf = np.empty(out_off[-1], dtype=np.uint8)

    # first k characters of each chain: decode the head state's value
    first_vals = state_val[s_sorted[starts]]
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        buf[out_off[:-1] + j] = _CODE_CHARS[
            ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
        ]
    # subsequent states contribute their last base at position k-1+rank
    chain_id = np.cumsum(chain_start) - 1
    not_first = ~chain_start
    pos = out_off[chain_id[not_first]] + (k - 1) + rank[s_sorted[not_first]]
    buf[pos] = _CODE_CHARS[
        (state_val[s_sorted[not_first]] & np.uint64(3)).astype(np.int64)
    ]

    # per-chain coverage: occurrence counts summed over member nodes
    chain_sums = None
    if node_counts is not None:
        chain_sums = np.add.reduceat(
            node_counts[s_sorted >> 1].astype(np.int64), starts
        )

    return _canonical_chain_strings(
        buf.tobytes(), out_off, chain_lens, chain_sums,
        cycle_strings, cycle_sums, cycle_lens,
    )


_CHAR_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"TGCA"):
    _CHAR_CODE[_c] = _i


def unitig_member_nodes(
    khi: np.ndarray, klo: np.ndarray, unitigs: List[str], k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of each unitig's constituent canonical k-mer rows.

    khi/klo: the sorted node key lanes the graph was built over.  Returns
    (offsets [n_unitigs + 1], node_rows): unitig i's k-mers are the rows
    node_rows[offsets[i]:offsets[i+1]], in walk order.  Vectorized per
    unitig (sliding-window pack + binary search); every window must be
    present in the node table (asserted) -- a self-check that the
    materialized strings spell paths in the dBG.
    """
    khi = np.asarray(khi, dtype=np.uint64)
    klo = np.asarray(klo, dtype=np.uint64)
    n_lo = min(k, 16)
    packed = (khi << np.uint64(2 * n_lo)) | klo
    kmask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)

    offsets = np.zeros(len(unitigs) + 1, dtype=np.int64)
    rows_parts = []
    for i, u in enumerate(unitigs):
        codes = _CHAR_CODE[np.frombuffer(u.encode(), dtype=np.uint8)].astype(
            np.uint64
        )
        if codes.size < k:
            raise ValueError(f"unitig shorter than k: {u!r}")
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        shifts = (np.uint64(2) * (np.uint64(k - 1) - np.arange(k, dtype=np.uint64)))
        fwd = (win << shifts).sum(axis=1, dtype=np.uint64) & kmask
        comp = (np.uint64(3) - win)[:, ::-1]
        rev = (comp << shifts).sum(axis=1, dtype=np.uint64) & kmask
        canon = np.minimum(fwd, rev)
        pos = np.searchsorted(packed, canon)
        ok = (pos < packed.size) & (packed[np.minimum(pos, packed.size - 1)] == canon)
        if not ok.all():
            raise AssertionError(
                f"unitig {i} contains k-mers absent from the node table"
            )
        rows_parts.append(pos.astype(np.int64))
        offsets[i + 1] = offsets[i] + pos.size
    rows = (
        np.concatenate(rows_parts)
        if rows_parts
        else np.zeros(0, dtype=np.int64)
    )
    return offsets, rows


_RC_TABLE = str.maketrans("ACGT", "TGCA")


def _rc_str(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]
