"""Fully-partitioned dBG compaction: no replicated tables anywhere.

`parallel/shard_dbg.py` shards the *work* but replicates the key table and
re-replicates link tables each pointer-jump round -- fine while the table
fits one device's memory, impossible at chromosome scale.  Here everything is
partitioned:

  - The global sorted canonical key array is split into equal contiguous
    row ranges; shard ``s`` owns rows ``[s*rows, (s+1)*rows)`` (state ids
    and pointer-jump ownership follow this layout).
  - Membership lookups route each query key to its HASH owner via a
    capacity-padded ``all_to_all``, are answered with a local binary
    search over a once-redistributed (hash-partitioned, key-sorted) copy
    of the table carrying original global indices, and routed back to the
    slot they came from.  Hash (not range) ownership is essential: misses
    concentrate on whichever shard owns the widest key-value gap under
    range splitting (measured 25%+ of queries on one shard).
    This is the distributed-memory form of the reference's
    bin probing (find_kmer_extension, binning.c:477-559) -- except lookups
    are by value over the whole graph, so no neighbor is ever missed for
    being binned elsewhere (SURVEY.md 2.1.8).
  - Pointer jumping gathers (parent, rank, min) by *global index*; the
    owner of an index range answers.  Requests are deduplicated per shard
    before routing (chains converge onto few heads as doubling proceeds, so
    combining bounds the hot-owner load by the number of distinct chains,
    not states).

All routing reports psum'd overflow counters instead of silently dropping;
callers re-run with more ``slack`` if any counter is nonzero.

The flip-side in-degree test needs the *target's* oriented value; we avoid
a second index-routed fetch entirely: a successful candidate's query value
IS the target's entry-oriented value, so the flipped orientation is just
its reverse complement, computable locally.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from genome_assembly_tpu.ops import dbg, encode

SHARD_AXIS = "shards"


# ---------------------------------------------------------------------------
# routing primitives (run inside shard_map)
# ---------------------------------------------------------------------------


def _xchg(block, n_shards):
    # A tiled all_to_all over a singleton axis is the identity (split dim 0
    # into one piece, concat it back).  Skip the primitive in that case:
    # the 1-device path keeps the same memory profile (every block is
    # still materialized and staged) without any collective -- and with
    # n_shards passed STATICALLY the body needs no axis context at all,
    # so it runs under plain jit, outside shard_map (see _spmd).
    if n_shards == 1:
        return block
    return lax.all_to_all(block, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True)


def _axidx(n_shards):
    """This shard's index; a static 0 on a 1-device mesh (no axis env)."""
    if n_shards == 1:
        return jnp.int32(0)
    return lax.axis_index(SHARD_AXIS).astype(jnp.int32)


def _spmd(body, *, mesh, in_specs, out_specs):
    """jax.shard_map, except a 1-device mesh runs ``body`` directly.

    The routing bodies are axis-free at n_shards == 1 (_xchg and _axidx
    take the shard count statically), so the degenerate mesh needs no
    axis env and no SPMD partitioning: running the body directly is the
    same program without the partitioner's pass over it.  The body sees
    the full arrays as its local shard (rows == n) and returns the same
    [1, ...]-leading shapes; multi-device meshes are untouched.
    """
    if mesh.shape[SHARD_AXIS] == 1:
        return body
    return jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def _pack_by_owner(owner, active, payloads, fills, n_shards, cap):
    """Sort local queries by owner and scatter them into [n_shards, cap]
    capacity blocks (block j = queries for shard j).

    Returns (blocks, (o, s, ok, idx_s), overflow): the bookkeeping triple
    addresses answers coming back in the same [owner, slot] layout, and
    idx_s un-sorts them to the original query order.
    """
    q = owner.shape[0]
    idx = jnp.arange(q, dtype=jnp.int32)
    key = jnp.where(active, owner.astype(jnp.uint32), jnp.uint32(n_shards))
    # 2-key UNSTABLE sort == the stable single-key sort (idx breaks every
    # tie), in the same operand shape the in-core joins use; then a tiny
    # searchsorted and gathers -- no q-query binary search, no scan.
    sorted_ops = lax.sort((key, idx) + tuple(payloads), num_keys=2)
    key_s, idx_s = sorted_ops[0], sorted_ops[1]
    pay_s = sorted_ops[2:]
    # run start of each record's owner: gather from the (n_shards+1)-entry
    # starts table -- no big scan, no q-query binary search
    shard_ids0 = jnp.arange(n_shards + 1, dtype=key_s.dtype)
    starts0 = jnp.searchsorted(key_s, shard_ids0, side="left").astype(jnp.int32)
    first = starts0[jnp.clip(key_s, 0, n_shards).astype(jnp.int32)]
    slot = idx - first
    in_range = key_s < n_shards
    ok = (slot < cap) & in_range
    overflow = jnp.sum((slot >= cap) & in_range).astype(jnp.int32)
    o = jnp.where(ok, key_s.astype(jnp.int32), n_shards)
    s = jnp.where(ok, slot, 0)
    # gather-form block fill: run j occupies sorted rows
    # [starts[j], starts[j+1]), so block[j][c] = pay_s[starts[j] + c]
    # when in range.  Equivalent to the scatter buf.at[o, s].set(p)
    # (records are placed in identical slot order) with no scatter and
    # no [q, 2] index materialization -- flat/2D-iota shapes only (the
    # r4 tiling-padding lesson: keep per-record lanes flat).
    jj = lax.broadcasted_iota(jnp.int32, (n_shards, cap), 0)
    cc = lax.broadcasted_iota(jnp.int32, (n_shards, cap), 1)
    src = starts0[jj] + cc
    val = src < starts0[jj + 1]
    src = jnp.clip(src, 0, q - 1)
    blocks = []
    for p, fill in zip(pay_s, fills):
        blocks.append(jnp.where(val, p[src], jnp.asarray(fill, p.dtype)))
    return blocks, (o, s, ok, idx_s), overflow


def _unpack_answers(ans_blocks, bookkeeping, q, misses, n_shards):
    """Route answer blocks back and restore original query order."""
    o, s, ok, idx_s = bookkeeping
    outs = []
    for a, miss in zip(ans_blocks, misses):
        back = _xchg(a, n_shards)
        got = back[jnp.clip(o, 0, n_shards - 1), s]
        got = jnp.where(ok, got, miss)
        out = jnp.full((q,), miss, dtype=back.dtype)
        out = out.at[idx_s].set(got, mode="drop", unique_indices=True)
        outs.append(out)
    return outs


from genome_assembly_tpu.common import (
    LINK_HASH_A as _LINK_A,
    LINK_HASH_B as _LINK_B,
    fmix32 as _fmix32,
)


def _key_owner(qhi, qlo, n_shards):
    """Uniform shard assignment by (k-1)-mer boundary-key hash.

    Range partitioning is NOT used for lookups: queries that miss (most
    neighbor candidates at graph boundaries, and anything above the top
    key) would concentrate on whichever shard owns the widest value gap --
    measured 25%+ of all queries landing on one shard.  Uses the LINK
    hash constants + fmix32 diffusion: boundary keys of T-leading k-mers
    pack to the k-mer's own (hi, lo) pair, so sharing the COUNT phase's
    hash would correlate owners with count-partition-ordered inputs (see
    common.LINK_HASH_A).
    """
    h = _fmix32((qhi * _LINK_A) ^ (qlo * _LINK_B))
    return ((h >> 7) % jnp.uint32(n_shards)).astype(jnp.int32)


def _build_hash_table(khi_l, klo_l, valid_l, *, base, n_shards, cap):
    """Redistribute this shard's keys to their hash owners once.

    Returns (hkhi, hklo, hgidx) local arrays sorted by key with sentinel
    padding -- the lookup-side table -- plus overflow.
    """
    owner = _key_owner(khi_l, klo_l, n_shards)
    gidx = base + jnp.arange(khi_l.shape[0], dtype=jnp.int32)
    blocks, _, overflow = _pack_by_owner(
        owner,
        valid_l,
        (khi_l, klo_l, gidx),
        (jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF), jnp.int32(-1)),
        n_shards,
        cap,
    )
    r_khi = _xchg(blocks[0], n_shards).reshape(-1)
    r_klo = _xchg(blocks[1], n_shards).reshape(-1)
    r_gidx = _xchg(blocks[2], n_shards).reshape(-1)
    hkhi, hklo, hgidx = lax.sort((r_khi, r_klo, r_gidx), num_keys=2)
    return hkhi, hklo, hgidx, overflow


def _routed_lookup(hkhi, hklo, hgidx, qhi, qlo, active, *, n_shards, cap):
    """Global index of each query key in the hash-partitioned table, or -1.

    hkhi/hklo/hgidx: this shard's hash-owned keys (sorted, sentinel-padded)
    with their original global indices.  Queries hash-owned by this very
    shard are answered locally and never routed.
    Returns (global_idx[q], overflow).
    """
    owner = _key_owner(qhi, qlo, n_shards)
    me = _axidx(n_shards)
    is_local = owner == me

    def answer(xhi, xlo):
        pos = dbg.lookup2(hkhi, hklo, xhi, xlo)
        return jnp.where(pos >= 0, hgidx[jnp.clip(pos, 0, hgidx.shape[0] - 1)], -1)

    local_ans = answer(qhi, qlo).astype(jnp.int32)

    blocks, bk, overflow = _pack_by_owner(
        owner,
        active & ~is_local,
        (qhi, qlo),
        (jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF)),
        n_shards,
        cap,
    )
    r_qhi = _xchg(blocks[0], n_shards).reshape(-1)
    r_qlo = _xchg(blocks[1], n_shards).reshape(-1)
    glob = answer(r_qhi, r_qlo).astype(jnp.int32)
    (ans,) = _unpack_answers(
        [glob.reshape(n_shards, cap)], bk, qhi.shape[0], (jnp.int32(-1),), n_shards
    )
    return jnp.where(active & is_local, local_ans, ans), overflow


def _routed_gather(tables, parent, *, rows, n_shards, cap):
    """tables[t][parent] for global indices ``parent``, owner-routed with
    per-shard request combining (duplicates collapse to one query).

    tables: list of this shard's local [rows] arrays.  parent: [q] global
    indices, all in range.  Returns (list of gathered [q] arrays, overflow).
    """
    q = parent.shape[0]
    if n_shards == 1:
        # every request is structurally local: answer with one row
        # gather, no routing machinery (the scans and exchanges below
        # would compute the same rows the long way).
        tstack = jnp.stack(tables, axis=1)
        got = tstack[parent]
        return [got[:, t] for t in range(len(tables))], jnp.int32(0)
    base = _axidx(n_shards) * rows
    idx = jnp.arange(q, dtype=jnp.int32)
    par_s, idx_s = lax.sort((parent, idx), num_keys=1, is_stable=True)
    gs = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), par_s[1:] != par_s[:-1]]
    )
    owner = par_s // rows  # sorted parents => owner monotone
    me = base // rows
    is_local = owner == me  # answered locally; never routed (the hot-head
    # and self-loop load is structurally self-owned after a few rounds)

    # slot = rank among routed (remote) group-heads within this owner's run
    act = gs & ~is_local
    acti = act.astype(jnp.int32)
    c = lax.associative_scan(jnp.add, acti)
    # actives-before-this-owner's-run = exclusive count at the run start,
    # gathered through the tiny per-owner starts table (owner is sorted
    # with cardinality n_shards) -- replaces both the old q-query
    # searchsorted and the later cummax propagation
    starts_own = jnp.searchsorted(
        owner, jnp.arange(n_shards, dtype=owner.dtype), side="left"
    ).astype(jnp.int32)
    ce = c - acti
    run_start = starts_own[jnp.clip(owner, 0, n_shards - 1)]
    run_before = ce[jnp.clip(run_start, 0, q - 1)]
    slot = c - 1 - run_before
    ok = act & (slot < cap)
    overflow = jnp.sum(act & (slot >= cap)).astype(jnp.int32)
    o = jnp.where(ok, owner, n_shards)
    s = jnp.where(ok, slot, 0)
    qbuf = jnp.full((n_shards, cap), -1, dtype=jnp.int32)
    qbuf = qbuf.at[o, s].set(par_s, mode="drop")

    recv = _xchg(qbuf, n_shards).reshape(-1)
    loc = jnp.clip(recv - base, 0, rows - 1)
    # pack the local tables once: one row gather instead of T
    tstack = jnp.stack(tables, axis=1)  # [rows, T]
    got = jnp.where(recv[:, None] >= 0, tstack[loc], 0)  # [n_shards*cap, T]
    back = _xchg(got.reshape(n_shards, cap, -1), n_shards)

    head_pos = lax.associative_scan(
        jnp.maximum, jnp.where(gs, idx, -1)
    )  # position of each entry's group head
    loc_q = jnp.clip(par_s - base, 0, rows - 1)
    at_heads = back[jnp.clip(o, 0, n_shards - 1), s]  # [q, T]
    at_heads = jnp.where(ok[:, None], at_heads, 0)
    at_heads = jnp.where((is_local & gs)[:, None], tstack[loc_q], at_heads)
    all_sorted = at_heads[head_pos]
    out2 = jnp.zeros((q, len(tables)), dtype=at_heads.dtype)
    out2 = out2.at[idx_s].set(all_sorted, mode="drop", unique_indices=True)
    return [out2[:, t] for t in range(len(tables))], overflow


# ---------------------------------------------------------------------------
# link building
# ---------------------------------------------------------------------------


def _candidates(ohi, olo, *, k):
    """The 4 forward successor candidates of an oriented value, canonical
    form + whether the forward orientation was kept, per base."""
    n_lo = min(k, 16)
    n_hi = k - n_lo
    mask_lo = jnp.uint32((1 << (2 * n_lo)) - 1)
    mask_hi = jnp.uint32((1 << (2 * n_hi)) - 1) if n_hi else jnp.uint32(0)
    if n_hi > 0:
        suf_hi = ((ohi << 2) | (olo >> (2 * (n_lo - 1)))) & mask_hi
        suf_lo = (olo << 2) & mask_lo
    else:
        suf_hi = jnp.zeros_like(ohi)
        suf_lo = (olo << 2) & mask_lo
    out = []
    for b in range(4):
        chi = suf_hi
        clo = suf_lo | jnp.uint32(b)
        rchi, rclo = encode.reverse_complement_packed(chi, clo, k)
        fwd_le = (chi < rchi) | ((chi == rchi) & (clo <= rclo))
        qhi = jnp.where(fwd_le, chi, rchi)
        qlo = jnp.where(fwd_le, clo, rclo)
        out.append((qhi, qlo, fwd_le, chi, clo))
    return out


def _links_body(khi_l, klo_l, valid_l, *, k, n_shards, rows, cap, cap_tab):
    """Per-shard: links for this shard's 2*rows states, all lookups routed."""
    base = _axidx(n_shards) * rows

    hkhi, hklo, hgidx, ovf_tab = _build_hash_table(
        khi_l, klo_l, valid_l, base=base, n_shards=n_shards, cap=cap_tab
    )

    rhi_l, rlo_l = encode.reverse_complement_packed(khi_l, klo_l, k)
    # iota arithmetic, not repeat/tile: no [rows, 2] broadcast is
    # materialized
    sid2 = jnp.arange(2 * rows, dtype=jnp.int32)
    node_l = sid2 >> 1
    strand = sid2 & 1
    gid = 2 * (base + node_l) + strand
    ohi = jnp.where(strand == 0, khi_l[node_l], rhi_l[node_l])
    olo = jnp.where(strand == 0, klo_l[node_l], rlo_l[node_l])
    state_valid = valid_l[node_l]

    n_states = 2 * rows

    def batch_lookup(cands, active):
        qhi = jnp.concatenate([c[0] for c in cands])
        qlo = jnp.concatenate([c[1] for c in cands])
        act = jnp.concatenate([active] * 4)
        idx, ovf = _routed_lookup(
            hkhi,
            hklo,
            hgidx,
            qhi,
            qlo,
            act,
            n_shards=n_shards,
            cap=cap,
        )
        return idx.reshape(4, n_states), ovf

    cands = _candidates(ohi, olo, k=k)
    idx4, ovf1 = batch_lookup(cands, state_valid)

    out_deg = jnp.zeros(n_states, dtype=jnp.int32)
    succ_state = jnp.full(n_states, -1, dtype=jnp.int32)
    succ_ohi = jnp.zeros(n_states, dtype=jnp.uint32)
    succ_olo = jnp.zeros(n_states, dtype=jnp.uint32)
    for b in range(4):
        qhi, qlo, fwd_le, chi, clo = cands[b]
        idx = idx4[b]
        found = (idx >= 0) & state_valid
        t_state = jnp.where(fwd_le, 2 * idx, 2 * idx + 1).astype(jnp.int32)
        hairpin = t_state == (gid ^ 1)
        out_deg = out_deg + jnp.where(hairpin, 2, 1) * found.astype(jnp.int32)
        succ_state = jnp.where(found, t_state, succ_state)
        # entry-oriented value of the target == the candidate value itself
        succ_ohi = jnp.where(found, chi, succ_ohi)
        succ_olo = jnp.where(found, clo, succ_olo)

    unique_succ = (out_deg == 1) & state_valid

    # in-degree(t) == out-degree(flip(t)); flip(t)'s oriented value is the
    # reverse complement of t's entry-oriented value (known locally).
    f_ohi, f_olo = encode.reverse_complement_packed(succ_ohi, succ_olo, k)
    f_cands = _candidates(f_ohi, f_olo, k=k)
    f_idx4, ovf2 = batch_lookup(f_cands, unique_succ)

    flip_t = jnp.where(unique_succ, succ_state ^ 1, 0)
    t_deg = jnp.zeros(n_states, dtype=jnp.int32)
    for b in range(4):
        qhi, qlo, fwd_le, chi, clo = f_cands[b]
        idx = f_idx4[b]
        found = idx >= 0
        cand_state = jnp.where(fwd_le, 2 * idx, 2 * idx + 1).astype(jnp.int32)
        hairpin = cand_state == (flip_t ^ 1)
        t_deg = t_deg + jnp.where(hairpin, 2, 1) * found.astype(jnp.int32)

    next_state = jnp.where(unique_succ & (t_deg == 1), succ_state, -1)
    overflow = ovf_tab + ovf1 + ovf2
    return next_state[None], overflow[None]


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def partitioned_unitig_links(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    slack: float = 4.0,
):
    """next_state[2N] with BOTH the key table and the states partitioned.

    khi/klo: globally sorted canonical keys (sentinel-padded), length N
    divisible by the mesh size.  Returns (next_state [2N], overflow
    [n_shards]); any nonzero overflow means the routing capacity was
    exceeded -- re-run with a larger ``slack``.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n = khi.shape[0]
    n_shards = mesh.shape[SHARD_AXIS]
    if n % n_shards:
        raise ValueError(f"N={n} must divide mesh size {n_shards}")
    rows = n // n_shards
    # 8 queries per state per round, hash-spread over n_shards owners
    cap = max(1, int(np.ceil(8 * rows / n_shards * slack)))
    # one-time table redistribution: rows keys hash-spread over owners
    cap_tab = max(1, int(np.ceil(rows / n_shards * slack)))

    fn = _spmd(
        functools.partial(
            _links_body, k=k, n_shards=n_shards, rows=rows, cap=cap,
            cap_tab=cap_tab,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    links, overflow = fn(khi, klo, valid)
    return links.reshape(2 * n), overflow


def _boundary_records(khi_l, klo_l, valid_l, *, k, rows, gid):
    """The 4 per-node boundary records of this shard's states: OUT rows
    keyed by the oriented suffix, IN rows by the oriented prefix, payload
    = (side << 31) | gid.  Shared by the flat and two-level joins."""
    rhi_l, rlo_l = encode.reverse_complement_packed(khi_l, klo_l, k)
    # strand-major layout: [strand-0 states | strand-1].  Order is free
    # (records are hash-routed and sorted), and this avoids both the
    # repeat/tile [rows, 2] pad class and the khi[sid >> 1] generic
    # gathers (5 scalar-core gathers that cost the in-core join ~11% --
    # see dbg.build_unitig_links_join).  ``gid`` must arrive in the SAME
    # strand-major order (both callers build it that way).
    ohi = jnp.concatenate([khi_l, rhi_l])
    olo = jnp.concatenate([klo_l, rlo_l])
    state_valid = jnp.concatenate([valid_l, valid_l])

    n_lo = min(k, 16)
    n_hi = k - n_lo
    # suffix = v & mask(2k-2); prefix = v >> 2 (two-lane arithmetic); valid
    # key hi lanes stay < 2^30, so a sentinel hi lane marks padding.
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

    key_hi = jnp.concatenate([suf_hi, pre_hi])
    key_lo = jnp.concatenate([suf_lo, pre_lo])
    side = jnp.concatenate(
        [jnp.zeros(2 * rows, jnp.uint32), jnp.ones(2 * rows, jnp.uint32)]
    )
    payload = (side << 31) | jnp.concatenate([gid, gid])
    active = jnp.concatenate([state_valid, state_valid])
    return key_hi, key_lo, payload, active


def _pair_edges(r_khi, r_klo, r_pay):
    """Sort received boundary records and pair-test adjacent rows: a key
    group of exactly one OUT + one IN row (payload bit 31 = side) is a
    unitig edge.  Returns (edge mask, src state, dst state) in sorted
    order; hairpins (dst == src ^ 1) are excluded.  Shared by the flat
    and two-level joins (identical semantics => bit-identical edges)."""
    sent = jnp.uint32(0xFFFFFFFF)
    khi_s, klo_s, pay_s = lax.sort((r_khi, r_klo, r_pay), num_keys=3)
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
    return pair & ~hairpin, state_s, target


def _links_join_body(
    khi_l, klo_l, valid_l, *, k, n_shards, rows, cap_rec, cap_edge
):
    """Per-shard routed sort-join links (the distributed form of
    ops/dbg.py build_unitig_links_join).

    Each shard emits OUT (key = suffix) / IN (key = prefix) boundary
    records for its own 2*rows states, routes them to the key's HASH owner,
    pair-tests adjacent rows of the locally sorted records (all records of
    one (k-1)-mer land on one shard, so group adjacency is complete), and
    routes the resulting edges back to each source state's home shard.

    No table lookups anywhere: ~100x cheaper than the binary-search bodies
    above at scale.
    """
    base_node = _axidx(n_shards) * rows
    # strand-major gid halves, matching _boundary_records' state layout
    g0 = (2 * (base_node + jnp.arange(rows, dtype=jnp.int32))).astype(
        jnp.uint32
    )
    gid = jnp.concatenate([g0, g0 + 1])
    key_hi, key_lo, payload, active = _boundary_records(
        khi_l, klo_l, valid_l, k=k, rows=rows, gid=gid
    )

    sent = jnp.uint32(0xFFFFFFFF)
    owner = _key_owner(key_hi, key_lo, n_shards)
    blocks, _, ovf_rec = _pack_by_owner(
        owner, active, (key_hi, key_lo, payload), (sent, sent, sent),
        n_shards, cap_rec,
    )
    r_khi = _xchg(blocks[0], n_shards).reshape(-1)
    r_klo = _xchg(blocks[1], n_shards).reshape(-1)
    r_pay = _xchg(blocks[2], n_shards).reshape(-1)

    edge, state_s, target = _pair_edges(r_khi, r_klo, r_pay)

    # route each edge to its source state's home shard and scatter (at most
    # one OUT record per state => destinations unique)
    home = jnp.clip(state_s, 0, 2 * rows * n_shards - 1) // (2 * rows)
    eblocks, _, ovf_edge = _pack_by_owner(
        home, edge, (state_s, target), (jnp.int32(-1), jnp.int32(-1)),
        n_shards, cap_edge,
    )
    b_src = _xchg(eblocks[0], n_shards).reshape(-1)
    b_dst = _xchg(eblocks[1], n_shards).reshape(-1)
    base_state = 2 * base_node
    next_l = jnp.full(2 * rows, -1, dtype=jnp.int32)
    loc = jnp.where(b_src >= 0, b_src - base_state, 2 * rows)
    next_l = next_l.at[loc].set(b_dst, mode="drop", unique_indices=True)
    return next_l[None], (ovf_rec + ovf_edge)[None]


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def partitioned_unitig_links_join(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    slack: float = 4.0,
):
    """next_state[2N] via the routed (k-1)-mer sort-join; fully partitioned.

    The distributed default: identical results to
    ``dbg.build_unitig_links_join`` (differential-tested) with no key-table
    lookups at all -- each state's two boundary records are hash-routed to
    an owner shard, pair-tested there after one local sort, and the edges
    routed home.  Works for both the replicated-table and partitioned
    regimes since the join never touches the table.

    khi/klo: globally sorted canonical keys (sentinel-padded), length N
    divisible by the mesh size.  Returns (next_state [2N], overflow
    [n_shards]); nonzero overflow => re-run with larger ``slack``.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n = khi.shape[0]
    n_shards = mesh.shape[SHARD_AXIS]
    if n % n_shards:
        raise ValueError(f"N={n} must divide mesh size {n_shards}")
    rows = n // n_shards
    # 4*rows records per shard, hash-spread over n_shards owners
    cap_rec = max(1, int(np.ceil(4 * rows / n_shards * slack)))
    # at most one edge per state routed home
    cap_edge = max(1, int(np.ceil(2 * rows / n_shards * slack)))

    fn = _spmd(
        functools.partial(
            _links_join_body, k=k, n_shards=n_shards, rows=rows,
            cap_rec=cap_rec, cap_edge=cap_edge,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    links, overflow = fn(khi, klo, valid)
    return links.reshape(2 * n), overflow


# ---------------------------------------------------------------------------
# pointer jumping
# ---------------------------------------------------------------------------


def _jump_body(next_l, *, n2, n_shards, rows2, cap, steps):
    base = _axidx(n_shards) * rows2
    gids = base + jnp.arange(rows2, dtype=jnp.int32)

    # --- predecessor table: route (dest=next, src=gid) to dest's owner ---
    me = base // rows2
    dest = next_l
    owner = jnp.clip(dest, 0, n2 - 1) // rows2
    is_local = (dest >= 0) & (owner == me)
    active = (dest >= 0) & ~is_local
    blocks, _, ovf_pred = _pack_by_owner(
        owner,
        active,
        (dest, gids),
        (jnp.int32(-1), jnp.int32(-1)),
        n_shards,
        cap,
    )
    r_dest = _xchg(blocks[0], n_shards).reshape(-1)
    r_src = _xchg(blocks[1], n_shards).reshape(-1)
    pred_l = jnp.full(rows2, -1, dtype=jnp.int32)
    # in-degree <= 1 => destinations are globally unique
    loc_local = jnp.where(is_local, dest - base, rows2)
    pred_l = pred_l.at[loc_local].set(gids, mode="drop", unique_indices=True)
    loc = jnp.where(r_dest >= 0, r_dest - base, rows2)
    pred_l = pred_l.at[loc].set(r_src, mode="drop", unique_indices=True)

    parent = jnp.where(pred_l >= 0, pred_l, gids)
    rank = (pred_l >= 0).astype(jnp.int32)
    min_id = jnp.minimum(gids, parent)

    def round_body(_, carry):
        parent, rank, min_id, ovf = carry
        (p_par, p_rank, p_min), ovf_r = _routed_gather(
            [parent, rank, min_id], parent, rows=rows2, n_shards=n_shards, cap=cap
        )
        return p_par, rank + p_rank, jnp.minimum(min_id, p_min), ovf + ovf_r

    parent, rank, min_id, ovf_rounds = lax.fori_loop(
        # ovf_pred * 0 inherits the varying-axis type the carry needs
        0, steps, round_body, (parent, rank, min_id, ovf_pred * 0)
    )

    (p_pred,), ovf_final = _routed_gather(
        [pred_l], parent, rows=rows2, n_shards=n_shards, cap=cap
    )
    is_cycle = p_pred >= 0
    head = jnp.where(is_cycle, min_id, parent)
    rank = jnp.where(is_cycle, 0, rank)  # round-count-independent
    overflow = ovf_pred + ovf_rounds + ovf_final
    return head[None], rank[None], is_cycle[None], overflow[None]


@functools.partial(jax.jit, static_argnames=("mesh", "slack"))
def partitioned_pointer_jump(
    next_state: jnp.ndarray, *, mesh: Mesh, slack: float = 4.0
):
    """List ranking with states, links, and per-round gathers all sharded.

    Per-round request combining keeps the hot-head problem bounded: once a
    chain's states share a parent, each shard sends ONE request for it.
    Gather overflow inside the doubling loop falls back to... nothing --
    it is counted and returned; results are only trustworthy when the
    returned overflow is all zero (tests assert this; callers raise slack).

    Returns (CompactedGraph, overflow[n_shards]).
    """
    n2 = next_state.shape[0]
    n_shards = mesh.shape[SHARD_AXIS]
    if n2 % n_shards:
        raise ValueError("state count must divide mesh size")
    rows2 = n2 // n_shards
    steps = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
    cap = max(1, int(np.ceil(rows2 / n_shards * slack)))

    fn = _spmd(
        functools.partial(
            _jump_body,
            n2=n2,
            n_shards=n_shards,
            rows2=rows2,
            cap=cap,
            steps=steps,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),),
        out_specs=(P(SHARD_AXIS),) * 4,
    )
    head, rank, is_cycle, overflow = fn(next_state)
    graph = dbg.CompactedGraph(
        next_state=next_state,
        head=head.reshape(n2),
        rank=rank.reshape(n2),
        is_cycle=is_cycle.reshape(n2),
    )
    return graph, overflow


# ---------------------------------------------------------------------------
# wide (shard, local) state ids: beyond 2**31 states (BASELINE config 5)
# ---------------------------------------------------------------------------
#
# The int32 pipeline above carries GLOBAL state ids (and the join packs a
# side bit next to them: ``(side << 31) | gid``), so it tops out at 2**31
# states.  Config 5 (3 Gbp x 30x) has ~6e9 dBG states.  The wide variant
# never materializes a global id at all: a state is addressed by the pair
# ``(owner shard, local id)``, each an int32 lane.  Under the contiguous
# range layout (shard s owns local ids [0, 2*rows)), lexicographic
# (owner, local) order IS global-id order, so chain-head canonicalization
# stays traversal-invariant.  Chain ranks are 64-bit via two uint32 lanes
# with explicit carries (a single random-genome chain can exceed 2**32
# only past ~4.3 Gbp per strand; the lanes remove even that cliff).
# Routing is cheaper than the 32-bit form in two places: the routed
# gather's owner is the pair's own owner lane (no division), and the
# source shard of an exchanged record is recovered from the all_to_all
# block row (tiled all_to_all: received row j came from shard j) instead
# of riding as a payload lane.


class WideCompactedGraph(NamedTuple):
    """Chain assignment with (owner, local) wide state ids; all arrays
    are [2N] in global layout (shard s's states occupy rows
    [s*rows2, (s+1)*rows2) and have owner lane == s)."""

    next_owner: jnp.ndarray
    next_local: jnp.ndarray
    head_owner: jnp.ndarray
    head_local: jnp.ndarray
    rank_hi: jnp.ndarray  # 64-bit chain rank, upper uint32 lane
    rank_lo: jnp.ndarray
    is_cycle: jnp.ndarray


def _wide_min(ao, al, bo, bl):
    """Lexicographic min over (owner, local) pairs == global-id min."""
    lt = (ao < bo) | ((ao == bo) & (al < bl))
    return jnp.where(lt, ao, bo), jnp.where(lt, al, bl)


def _add64(ahi, alo, bhi, blo):
    """64-bit add over two uint32 lanes (explicit carry)."""
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    return ahi + bhi + carry, lo


def _src_owner_lanes(n_shards, cap, dtype=jnp.int32):
    """Owner-of-origin for each row of a received [n_shards, cap] block."""
    return lax.broadcasted_iota(dtype, (n_shards, cap), 0).reshape(-1)


def _links_join_body_wide(
    khi_l, klo_l, valid_l, *, k, n_shards, rows, cap_rec, cap_edge
):
    """Per-shard routed sort-join links over wide ids.

    Identical join semantics to ``_links_join_body`` (differential-tested);
    only the state addressing differs: records carry (side << 31) | LOCAL
    id (< 2*rows, always < 2**31), and the emitting shard -- the state's
    home by construction -- is recovered from the exchange block row.
    """
    # strand-major lid halves, matching _boundary_records' state layout
    l0 = (2 * jnp.arange(rows, dtype=jnp.int32)).astype(jnp.uint32)
    lid = jnp.concatenate([l0, l0 + 1])
    key_hi, key_lo, payload, active = _boundary_records(
        khi_l, klo_l, valid_l, k=k, rows=rows, gid=lid
    )

    sent = jnp.uint32(0xFFFFFFFF)
    owner = _key_owner(key_hi, key_lo, n_shards)
    blocks, _, ovf_rec = _pack_by_owner(
        owner, active, (key_hi, key_lo, payload), (sent, sent, sent),
        n_shards, cap_rec,
    )
    r_khi = _xchg(blocks[0], n_shards).reshape(-1)
    r_klo = _xchg(blocks[1], n_shards).reshape(-1)
    r_pay = _xchg(blocks[2], n_shards).reshape(-1)
    r_own = _src_owner_lanes(n_shards, cap_rec, jnp.uint32)

    # sort by (key, side|lid, src shard): OUT rows precede IN rows within a
    # key group (payload bit 31 = side); the owner key makes ties
    # deterministic across mesh shapes
    khi_s, klo_s, pay_s, own_s = lax.sort(
        (r_khi, r_klo, r_pay, r_own), num_keys=4
    )
    v_s = khi_s != sent
    side_s = (pay_s >> 31).astype(jnp.int32)
    lid_s = (pay_s & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    own_i = own_s.astype(jnp.int32)

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
    t_own = nxt(own_i, -1)
    t_lid = nxt(lid_s, -1)
    hairpin = (t_own == own_i) & (t_lid == (lid_s ^ 1))
    edge = pair & ~hairpin

    # route each edge home: the OUT record's emitting shard IS the source
    # state's home
    eblocks, _, ovf_edge = _pack_by_owner(
        own_i, edge,
        (lid_s, t_own, t_lid),
        (jnp.int32(-1), jnp.int32(-1), jnp.int32(-1)),
        n_shards, cap_edge,
    )
    b_src = _xchg(eblocks[0], n_shards).reshape(-1)
    b_to = _xchg(eblocks[1], n_shards).reshape(-1)
    b_tl = _xchg(eblocks[2], n_shards).reshape(-1)
    next_o = jnp.full(2 * rows, -1, dtype=jnp.int32)
    next_ll = jnp.full(2 * rows, -1, dtype=jnp.int32)
    loc = jnp.where(b_src >= 0, b_src, 2 * rows)
    next_o = next_o.at[loc].set(b_to, mode="drop", unique_indices=True)
    next_ll = next_ll.at[loc].set(b_tl, mode="drop", unique_indices=True)
    return next_o[None], next_ll[None], (ovf_rec + ovf_edge)[None]


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def partitioned_unitig_links_join_wide(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    slack: float = 4.0,
):
    """(next_owner, next_local)[2N] via the routed sort-join with wide ids.

    Same join as ``partitioned_unitig_links_join`` but structurally free of
    the 2**31 global-state limit: per-shard local ids never exceed 2*rows
    and no global id is ever formed.  Returns (next_owner [2N],
    next_local [2N], overflow [n_shards]); -1 owner marks "no unique edge".
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n = khi.shape[0]
    n_shards = mesh.shape[SHARD_AXIS]
    if n % n_shards:
        raise ValueError(f"N={n} must divide mesh size {n_shards}")
    rows = n // n_shards
    cap_rec = max(1, int(np.ceil(4 * rows / n_shards * slack)))
    cap_edge = max(1, int(np.ceil(2 * rows / n_shards * slack)))

    fn = _spmd(
        functools.partial(
            _links_join_body_wide, k=k, n_shards=n_shards, rows=rows,
            cap_rec=cap_rec, cap_edge=cap_edge,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    next_o, next_l, overflow = fn(khi, klo, valid)
    return next_o.reshape(2 * n), next_l.reshape(2 * n), overflow


def _routed_gather_wide(tables, par_o, par_l, *, rows, n_shards, cap):
    """tables[t][(par_o, par_l)] with owner routing straight off the owner
    lane (no index arithmetic) and per-shard request combining.

    tables: this shard's local [rows] int32 arrays (uint32 lanes ride as
    int32 bit patterns; two's-complement wrap is bit-preserving).  par_o /
    par_l: [q] wide indices, all valid.  Returns ([q] arrays, overflow).
    """
    q = par_o.shape[0]
    if n_shards == 1:
        # all-local answer (owner lane is uniformly 0); see _routed_gather
        tstack = jnp.stack(tables, axis=1)
        got = tstack[par_l]
        return [got[:, t] for t in range(len(tables))], jnp.int32(0)
    me = _axidx(n_shards)
    idx = jnp.arange(q, dtype=jnp.int32)
    o_s, l_s, idx_s = lax.sort((par_o, par_l, idx), num_keys=2, is_stable=True)
    gs = jnp.concatenate(
        [
            jnp.ones((1,), dtype=bool),
            (o_s[1:] != o_s[:-1]) | (l_s[1:] != l_s[:-1]),
        ]
    )
    is_local = o_s == me

    act = gs & ~is_local
    acti = act.astype(jnp.int32)
    c = lax.associative_scan(jnp.add, acti)
    # tiny per-owner starts table, as in _routed_gather
    starts_own = jnp.searchsorted(
        o_s, jnp.arange(n_shards, dtype=o_s.dtype), side="left"
    ).astype(jnp.int32)
    ce = c - acti
    run_start = starts_own[jnp.clip(o_s, 0, n_shards - 1)]
    run_before = ce[jnp.clip(run_start, 0, q - 1)]
    slot = c - 1 - run_before
    ok = act & (slot < cap)
    overflow = jnp.sum(act & (slot >= cap)).astype(jnp.int32)
    o = jnp.where(ok, o_s, n_shards)
    s = jnp.where(ok, slot, 0)
    qbuf = jnp.full((n_shards, cap), -1, dtype=jnp.int32)
    qbuf = qbuf.at[o, s].set(l_s, mode="drop")

    recv = _xchg(qbuf, n_shards).reshape(-1)
    loc = jnp.clip(recv, 0, rows - 1)
    tstack = jnp.stack(tables, axis=1)  # [rows, T]
    got = jnp.where(recv[:, None] >= 0, tstack[loc], 0)
    back = _xchg(got.reshape(n_shards, cap, -1), n_shards)

    head_pos = lax.associative_scan(jnp.maximum, jnp.where(gs, idx, -1))
    loc_q = jnp.clip(l_s, 0, rows - 1)
    at_heads = back[jnp.clip(o, 0, n_shards - 1), s]
    at_heads = jnp.where(ok[:, None], at_heads, 0)
    at_heads = jnp.where((is_local & gs)[:, None], tstack[loc_q], at_heads)
    all_sorted = at_heads[head_pos]
    out2 = jnp.zeros((q, len(tables)), dtype=at_heads.dtype)
    out2 = out2.at[idx_s].set(all_sorted, mode="drop", unique_indices=True)
    return [out2[:, t] for t in range(len(tables))], overflow


def _jump_body_wide(next_o_l, next_l_l, *, n_shards, rows2, cap, steps):
    me = _axidx(n_shards)
    lids = jnp.arange(rows2, dtype=jnp.int32)

    # --- predecessor table: route (dest_local, src_local) to dest owner ---
    valid_dest = next_o_l >= 0
    is_local = valid_dest & (next_o_l == me)
    blocks, _, ovf_pred = _pack_by_owner(
        next_o_l,
        valid_dest & ~is_local,
        (next_l_l, lids),
        (jnp.int32(-1), jnp.int32(-1)),
        n_shards,
        cap,
    )
    r_dl = _xchg(blocks[0], n_shards).reshape(-1)
    r_sl = _xchg(blocks[1], n_shards).reshape(-1)
    r_so = _src_owner_lanes(n_shards, cap)
    pred_o = jnp.full(rows2, -1, dtype=jnp.int32)
    pred_l = jnp.full(rows2, -1, dtype=jnp.int32)
    # in-degree <= 1 => destinations globally unique; local + remote disjoint
    loc_local = jnp.where(is_local, next_l_l, rows2)
    pred_o = pred_o.at[loc_local].set(me, mode="drop", unique_indices=True)
    pred_l = pred_l.at[loc_local].set(lids, mode="drop", unique_indices=True)
    loc = jnp.where(r_dl >= 0, r_dl, rows2)
    pred_o = pred_o.at[loc].set(r_so, mode="drop", unique_indices=True)
    pred_l = pred_l.at[loc].set(r_sl, mode="drop", unique_indices=True)

    has_pred = pred_o >= 0
    par_o = jnp.where(has_pred, pred_o, me)
    par_l = jnp.where(has_pred, pred_l, lids)
    rank_lo = has_pred.astype(jnp.uint32)
    rank_hi = rank_lo * 0  # *0 keeps the varying-axis type the carry needs
    me_col = jnp.full(rows2, me, dtype=jnp.int32)
    min_o, min_l = _wide_min(me_col, lids, par_o, par_l)

    def round_body(_, carry):
        par_o, par_l, rank_hi, rank_lo, min_o, min_l, ovf = carry
        lanes = [
            par_o,
            par_l,
            rank_hi.astype(jnp.int32),
            rank_lo.astype(jnp.int32),
            min_o,
            min_l,
        ]
        (p_po, p_pl, p_rh, p_rl, p_mo, p_ml), ovf_r = _routed_gather_wide(
            lanes, par_o, par_l, rows=rows2, n_shards=n_shards, cap=cap
        )
        rank_hi, rank_lo = _add64(
            rank_hi, rank_lo, p_rh.astype(jnp.uint32), p_rl.astype(jnp.uint32)
        )
        min_o, min_l = _wide_min(min_o, min_l, p_mo, p_ml)
        return p_po, p_pl, rank_hi, rank_lo, min_o, min_l, ovf + ovf_r

    par_o, par_l, rank_hi, rank_lo, min_o, min_l, ovf_rounds = lax.fori_loop(
        0,
        steps,
        round_body,
        (par_o, par_l, rank_hi, rank_lo, min_o, min_l, ovf_pred * 0),
    )

    (p_pred_o,), ovf_final = _routed_gather_wide(
        [pred_o], par_o, par_l, rows=rows2, n_shards=n_shards, cap=cap
    )
    is_cycle = p_pred_o >= 0
    head_o = jnp.where(is_cycle, min_o, par_o)
    head_l = jnp.where(is_cycle, min_l, par_l)
    rank_hi = jnp.where(is_cycle, jnp.uint32(0), rank_hi)
    rank_lo = jnp.where(is_cycle, jnp.uint32(0), rank_lo)
    overflow = ovf_pred + ovf_rounds + ovf_final
    return (
        head_o[None],
        head_l[None],
        rank_hi[None],
        rank_lo[None],
        is_cycle[None],
        overflow[None],
    )


@functools.partial(jax.jit, static_argnames=("mesh", "slack"))
def partitioned_pointer_jump_wide(
    next_owner: jnp.ndarray,
    next_local: jnp.ndarray,
    *,
    mesh: Mesh,
    slack: float = 4.0,
):
    """List ranking over wide (owner, local) state ids; no 2**31 limit.

    next_owner/next_local: [2N] global layout (shard s's slice holds its
    own states; the ids in the arrays refer to the SAME mesh partitioning).
    Returns (WideCompactedGraph, overflow [n_shards]).  Ranks are 64-bit
    (two uint32 lanes).  Heads of cyclic chains are the lexicographic
    (owner, local) minimum == the global-id minimum, so results are
    convertible 1:1 to ``partitioned_pointer_jump``'s whenever n2 < 2**31
    (differential-tested).
    """
    n2 = next_owner.shape[0]
    n_shards = mesh.shape[SHARD_AXIS]
    if n2 % n_shards:
        raise ValueError("state count must divide mesh size")
    rows2 = n2 // n_shards
    steps = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
    cap = max(1, int(np.ceil(rows2 / n_shards * slack)))

    fn = _spmd(
        functools.partial(
            _jump_body_wide,
            n_shards=n_shards,
            rows2=rows2,
            cap=cap,
            steps=steps,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(SHARD_AXIS),) * 6,
    )
    head_o, head_l, rank_hi, rank_lo, is_cycle, overflow = fn(
        next_owner, next_local
    )
    graph = WideCompactedGraph(
        next_owner=next_owner,
        next_local=next_local,
        head_owner=head_o.reshape(n2),
        head_local=head_l.reshape(n2),
        rank_hi=rank_hi.reshape(n2),
        rank_lo=rank_lo.reshape(n2),
        is_cycle=is_cycle.reshape(n2),
    )
    return graph, overflow
