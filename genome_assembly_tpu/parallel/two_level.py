"""DCN-aware two-level record routing (SURVEY.md section 5.8).

Multi-host jobs see two very different networks: the intra-host fabric
("ICI" below; NVLink on a GPU host -- fast, all-to-all friendly) and the
data-center network between hosts ("DCN"; slow, per-message overhead).
A host's devices form a "slice".  A flat all_to_all over the global mesh makes every
(device, device) pair a DCN message.  The hierarchical decomposition here
keeps DCN traffic aggregated:

  stage 1 (ICI):  within each source slice, route every record to the
                  local device whose intra-slice index equals the record
                  owner's intra-slice index.  After this, device (s, d)
                  holds exactly the records of slice s destined for the
                  d-th device of ANY slice.
  stage 2 (DCN):  all_to_all along the slice axis only: device (s, d)
                  sends its bucket for slice t to device (t, d).  Every
                  record crosses DCN exactly once, in one aggregated
                  per-(slice, slice) message per device column.

Ownership is the same multiplicative hash as the flat router
(shard_count.owner_of with n = S*D, global shard g = ds*D + dd), so the
two-level result is bit-identical to the flat-mesh result row for row --
the equality the tests check.  On a single-slice CPU
test mesh both axes are ICI, but the code path (two bucketize+exchange
stages over different mesh axes) is exactly what a real 2-slice job runs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from genome_assembly_tpu.ops import minimizer as minimizer_ops
from genome_assembly_tpu.ops.count import SENTINEL
from genome_assembly_tpu.parallel import shard_count

SLICE_AXIS = "slices"
SHARD_AXIS = "shards"  # intra-slice (ICI) axis; matches the flat router


def _bucket_exchange(lanes, bucket, n_buckets, cap, axis_name, fills=None):
    """Sort records by bucket, pack into [n_buckets, cap] blocks, exchange
    block j to position j along ``axis_name``.  Returns (lanes', overflow):
    flattened received lanes (sentinel mmer marks empty slots) and the
    count of records dropped for exceeding cap.

    lanes: tuple of equal-length 1-D arrays; lanes[0] must be the mmer
    lane (SENTINEL == invalid).
    """
    n = lanes[0].shape[0]
    order = lax.sort((bucket,) + tuple(lanes), num_keys=1, is_stable=True)
    bucket_s, lanes_s = order[0], order[1:]

    idx = jnp.arange(n, dtype=jnp.int32)
    # tiny per-bucket starts table (see shard_count._pack): buckets are
    # sorted, small cardinality -- no n-query search, no n-length scan
    starts = jnp.searchsorted(
        bucket_s, jnp.arange(n_buckets + 1, dtype=bucket_s.dtype),
        side="left",
    ).astype(jnp.int32)
    first_of = starts[jnp.clip(bucket_s, 0, n_buckets).astype(jnp.int32)]
    slot = idx - first_of
    real = bucket_s < n_buckets
    ok = (slot < cap) & real
    overflow = jnp.sum((slot >= cap) & real)

    b_idx = jnp.where(ok, bucket_s.astype(jnp.int32), n_buckets)
    s_idx = jnp.where(ok, slot, 0)

    if fills is None:
        fills = [SENTINEL] + [jnp.zeros((), lane.dtype) for lane in lanes_s[1:]]

    def scatter(vals, fill):
        buf = jnp.full((n_buckets, cap), fill, dtype=vals.dtype)
        return buf.at[b_idx, s_idx].set(vals, mode="drop")

    def xchg(x):
        return lax.all_to_all(
            x, axis_name, split_axis=0, concat_axis=0, tiled=True
        )

    out = tuple(
        xchg(scatter(vals, fill)).reshape(-1)
        for vals, fill in zip(lanes_s, fills)
    )
    return out, overflow


def _scan_route_2level(
    codes, lengths, read_ids, stream_offset, *, k, m, parity, n_slices,
    n_ici, cap1, cap2, ici_axis=SHARD_AXIS, n_lead=2,
):
    """Per-device body: local scan -> ICI stage -> DCN stage -> count.

    ici_axis may be a single mesh axis name or a TUPLE of axis names (a
    multi-axis ICI torus, e.g. the (x, y) axes of a (slices, x, y) mesh):
    jax collectives treat an axis-name tuple as one combined row-major
    axis, which matches the global shard numbering g = ds*n_ici + dd.
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

    n_total = n_slices * n_ici
    g = shard_count.owner_of(mmer, n_total)
    # stage 1: bucket by the owner's intra-slice index, exchange over ICI
    dd = jnp.where(valid, g % jnp.uint32(n_ici), jnp.uint32(n_ici))
    # fills match the flat router's scatter fills exactly (stream pads
    # with 0xFFFFFFFF) so results are bit-identical INCLUDING dead slots
    fills = (SENTINEL, jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
             jnp.uint32(0xFFFFFFFF))
    lanes, ovf1 = _bucket_exchange(
        (mmer, khi, klo, rid, stream), dd, n_ici, cap1, ici_axis,
        fills=fills,
    )
    mmer1 = lanes[0]
    # stage 2: bucket by the owner's slice, exchange over DCN
    valid1 = mmer1 != SENTINEL
    g1 = shard_count.owner_of(mmer1, n_total)
    ds = jnp.where(
        valid1, g1 // jnp.uint32(n_ici), jnp.uint32(n_slices)
    )
    lanes2, ovf2 = _bucket_exchange(
        lanes, ds, n_slices, cap2, SLICE_AXIS, fills=fills
    )
    m2, hi2, lo2, rid2, st2 = lanes2
    v2 = m2 != SENTINEL
    out = shard_count._local_count(
        m2, hi2, lo2, rid2, st2, v2, ovf1 + ovf2
    )
    # shard_map over an n_lead-axis mesh: _local_count's outputs carry one
    # leading [1] block dim (the flat router's convention); widen it to
    # [1]*n_lead so out_specs can shard every mesh axis
    return tuple(x.reshape((1,) * n_lead + x.shape[1:]) for x in out)


@functools.partial(
    jax.jit,
    static_argnames=("k", "m", "parity", "cutoff", "mesh", "slack"),
)
def sharded_count_two_level(
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
) -> shard_count.ShardedCount:
    """Distributed count+prune over a (slices, *ici_axes) mesh.

    Drop-in for shard_count.sharded_count with routing split into an
    intra-slice ICI stage and an inter-slice DCN stage.  Results are
    bit-identical to the flat router's: global shard g = ds*n_ici + dd
    owns the same minimizers, and the returned arrays are ordered
    slice-major, so row g matches flat row g exactly.

    The mesh's first axis must be SLICE_AXIS (DCN); ALL remaining axes
    form the intra-slice network -- a (2, 2, 2) (slices, x, y) mesh runs
    the ICI stage as one all_to_all over the combined (x, y) torus, the
    layout of a real 2-slice job whose slices are 2-D meshes.
    """
    axis_names = mesh.axis_names
    if axis_names[0] != SLICE_AXIS or len(axis_names) < 2:
        raise ValueError(
            f"two-level mesh must be (slices, *ici_axes), got {axis_names}"
        )
    ici_axes = axis_names[1:]
    ici_axis = ici_axes[0] if len(ici_axes) == 1 else ici_axes
    ici_shape = tuple(mesh.shape[a] for a in ici_axes)
    n_slices = mesh.shape[SLICE_AXIS]
    n_ici = int(np.prod(ici_shape))
    n_lead = 1 + len(ici_axes)
    n_total = n_slices * n_ici
    batch, max_len = codes.shape
    rows = batch // n_total
    n_win = max_len - k + 1
    n_local = rows * n_win
    # stage 1 packs per-destination-column blocks out of n_local records;
    # stage 2 packs per-slice blocks out of the <= n_ici*cap1 received
    cap1 = int(np.ceil(n_local / n_ici * slack))
    cap2 = int(np.ceil(n_local / n_slices * slack))
    lead = (n_slices,) + ici_shape
    offsets = (
        jnp.arange(n_total, dtype=jnp.uint32)[:, None] * jnp.uint32(n_local)
    ).reshape(lead + (1,))

    codes2 = codes.reshape(lead + (rows, max_len))
    lengths2 = lengths.reshape(lead + (rows,))
    rids2 = read_ids.reshape(lead + (rows,))
    zero = (0,) * n_lead

    def body(codes, lengths, rids, offs):
        return _scan_route_2level(
            codes[zero], lengths[zero], rids[zero], offs[zero],
            k=k, m=m, parity=parity, n_slices=n_slices, n_ici=n_ici,
            cap1=cap1, cap2=cap2, ici_axis=ici_axis, n_lead=n_lead,
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(*axis_names),) * 4,
        out_specs=P(*axis_names),
    )
    outs = fn(codes2, lengths2, rids2, offsets)
    # [S, *ici, cap] -> [S*n_ici, cap]: slice-major == global shard order
    m_s, hi_s, lo_s, id_s, st_s, v_s, gs, count, overflow = (
        x.reshape((n_total,) + x.shape[n_lead:]) for x in outs
    )
    keep = gs & v_s & (count > cutoff)
    return shard_count.ShardedCount(
        mmer=m_s, kmer_hi=hi_s, kmer_lo=lo_s, read_id=id_s, stream_idx=st_s,
        valid=v_s, group_start=gs, count=count, keep=keep, overflow=overflow,
    )


def _ici_index(ici_axis, ici_shape):
    """Combined row-major intra-slice device index for one axis name or a
    tuple of axis names (multi-axis ICI torus)."""
    if isinstance(ici_axis, str):
        return lax.axis_index(ici_axis).astype(jnp.int32)
    idx = lax.axis_index(ici_axis[0]).astype(jnp.int32)
    for a, size in zip(ici_axis[1:], ici_shape[1:]):
        idx = idx * size + lax.axis_index(a).astype(jnp.int32)
    return idx


def _links_join_body_2level(
    khi_l, klo_l, valid_l, *, k, n_slices, n_ici, ici_shape, rows,
    cap1, cap2, cap_e1, cap_e2, ici_axis, n_lead,
):
    """Per-device routed sort-join with the record exchange split into an
    intra-slice ICI stage and one aggregated inter-slice DCN stage (and
    the edges-home return trip split the same way).

    The global owner hash and the local pair test are the flat join's
    (part_dbg._key_owner / _pair_edges), and stage-2 delivery lands every
    record on the same global owner, so edges are BIT-IDENTICAL to
    partitioned_unitig_links_join over the equivalent flat mesh.
    """
    from genome_assembly_tpu.parallel import part_dbg

    ds = lax.axis_index(SLICE_AXIS).astype(jnp.int32)
    dd = _ici_index(ici_axis, ici_shape)
    g_me = ds * n_ici + dd
    base_node = g_me * rows
    # strand-major gid halves, matching _boundary_records' state layout
    g0 = (2 * (base_node + jnp.arange(rows, dtype=jnp.int32))).astype(
        jnp.uint32
    )
    gid = jnp.concatenate([g0, g0 + 1])
    key_hi, key_lo, payload, active = part_dbg._boundary_records(
        khi_l, klo_l, valid_l, k=k, rows=rows, gid=gid
    )

    n_total = n_slices * n_ici
    owner = part_dbg._key_owner(key_hi, key_lo, n_total)
    fills = (SENTINEL, SENTINEL, SENTINEL)
    # stage 1 (ICI): to the owner's intra-slice column
    dd_own = jnp.where(active, owner % n_ici, n_ici).astype(jnp.uint32)
    lanes1, ovf1 = _bucket_exchange(
        (key_hi, key_lo, payload), dd_own, n_ici, cap1, ici_axis,
        fills=fills,
    )
    # stage 2 (DCN): to the owner's slice, one aggregated message per pair
    v1 = lanes1[0] != SENTINEL
    own1 = part_dbg._key_owner(lanes1[0], lanes1[1], n_total)
    ds_own = jnp.where(v1, own1 // n_ici, n_slices).astype(jnp.uint32)
    lanes2, ovf2 = _bucket_exchange(
        lanes1, ds_own, n_slices, cap2, SLICE_AXIS, fills=fills
    )

    edge, state_s, target = part_dbg._pair_edges(*lanes2)

    # edges home, two-level in reverse: ICI to the home's column, DCN to
    # the home's slice.  Lanes ride as uint32 (state ids stay < 2^31).
    home = jnp.clip(state_s, 0, 2 * rows * n_total - 1) // (2 * rows)
    e_lanes = (
        jnp.where(edge, state_s, -1).astype(jnp.uint32),
        target.astype(jnp.uint32),
    )
    efills = (jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF))
    dd_home = jnp.where(edge, home % n_ici, n_ici).astype(jnp.uint32)
    el1, ovf3 = _bucket_exchange(
        e_lanes, dd_home, n_ici, cap_e1, ici_axis, fills=efills
    )
    src1 = el1[0].astype(jnp.int32)
    ev1 = el1[0] != jnp.uint32(0xFFFFFFFF)
    home1 = jnp.clip(src1, 0, 2 * rows * n_total - 1) // (2 * rows)
    ds_home = jnp.where(ev1, home1 // n_ici, n_slices).astype(jnp.uint32)
    el2, ovf4 = _bucket_exchange(
        el1, ds_home, n_slices, cap_e2, SLICE_AXIS, fills=efills
    )
    b_src = el2[0].astype(jnp.int32)
    b_dst = el2[1].astype(jnp.int32)
    ev2 = el2[0] != jnp.uint32(0xFFFFFFFF)

    base_state = 2 * base_node
    next_l = jnp.full(2 * rows, -1, dtype=jnp.int32)
    loc = jnp.where(ev2, b_src - base_state, 2 * rows)
    next_l = next_l.at[loc].set(b_dst, mode="drop", unique_indices=True)
    overflow = (ovf1 + ovf2 + ovf3 + ovf4).astype(jnp.int32)
    lead = (1,) * n_lead
    return next_l.reshape(lead + (2 * rows,)), overflow.reshape(lead)


def _links_join_body_2level_wide(
    khi_l, klo_l, valid_l, *, k, n_slices, n_ici, ici_shape, rows,
    cap1, cap2, cap_e1, cap_e2, ici_axis, n_lead,
):
    """Wide (owner, local) ids over the two-level router: config 5's
    >2**31-state extension on a multi-slice pod needs BOTH at once.

    The flat wide join recovers a record's home shard from the tiled
    all_to_all block row; after two hops that information is gone, so
    the home rides as an explicit uint32 lane instead (one extra lane on
    the wire -- extension_phase_model's wide=True prices exactly this).
    """
    from genome_assembly_tpu.parallel import part_dbg

    ds = lax.axis_index(SLICE_AXIS).astype(jnp.int32)
    dd = _ici_index(ici_axis, ici_shape)
    g_me = ds * n_ici + dd
    # strand-major lid halves, matching _boundary_records' state layout
    l0 = (2 * jnp.arange(rows, dtype=jnp.int32)).astype(jnp.uint32)
    lid = jnp.concatenate([l0, l0 + 1])
    key_hi, key_lo, payload, active = part_dbg._boundary_records(
        khi_l, klo_l, valid_l, k=k, rows=rows, gid=lid
    )
    home_lane = jnp.full(4 * rows, g_me, dtype=jnp.uint32)

    n_total = n_slices * n_ici
    owner = part_dbg._key_owner(key_hi, key_lo, n_total)
    fills = (SENTINEL, SENTINEL, SENTINEL, SENTINEL)
    dd_own = jnp.where(active, owner % n_ici, n_ici).astype(jnp.uint32)
    lanes1, ovf1 = _bucket_exchange(
        (key_hi, key_lo, payload, home_lane), dd_own, n_ici, cap1,
        ici_axis, fills=fills,
    )
    v1 = lanes1[0] != SENTINEL
    own1 = part_dbg._key_owner(lanes1[0], lanes1[1], n_total)
    ds_own = jnp.where(v1, own1 // n_ici, n_slices).astype(jnp.uint32)
    lanes2, ovf2 = _bucket_exchange(
        lanes1, ds_own, n_slices, cap2, SLICE_AXIS, fills=fills
    )

    # pair test with the home lane riding as a 4th sort key (ordering
    # within a key group is side-first via payload bit 31, as flat wide)
    sent = SENTINEL
    khi_s, klo_s, pay_s, home_s = lax.sort(lanes2, num_keys=4)
    v_s = khi_s != sent
    side_s = (pay_s >> 31).astype(jnp.int32)
    lid_s = (pay_s & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    own_i = home_s.astype(jnp.int32)

    def nxt(x, fill):
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    def prv(x, fill):
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    same_next = (nxt(khi_s, sent ^ 1) == khi_s) & (nxt(klo_s, sent ^ 1) == klo_s)
    same_prev = (prv(khi_s, sent ^ 1) == khi_s) & (prv(klo_s, sent ^ 1) == klo_s)
    pair = (
        ~same_prev & same_next & ~nxt(same_next, True)
        & (side_s == 0) & (nxt(side_s, 1) == 1) & v_s
    )
    t_own = nxt(own_i, -1)
    t_lid = nxt(lid_s, -1)
    hairpin = (t_own == own_i) & (t_lid == (lid_s ^ 1))
    edge = pair & ~hairpin

    # edges home, two-level by the home lane; 3 payload lanes
    efills = (SENTINEL, SENTINEL, SENTINEL, SENTINEL)
    e_lanes = (
        jnp.where(edge, own_i, -1).astype(jnp.uint32),
        lid_s.astype(jnp.uint32),
        t_own.astype(jnp.uint32),
        t_lid.astype(jnp.uint32),
    )
    dd_home = jnp.where(edge, own_i % n_ici, n_ici).astype(jnp.uint32)
    el1, ovf3 = _bucket_exchange(
        e_lanes, dd_home, n_ici, cap_e1, ici_axis, fills=efills
    )
    ev1 = el1[0] != sent
    home1 = el1[0].astype(jnp.int32)
    ds_home = jnp.where(ev1, home1 // n_ici, n_slices).astype(jnp.uint32)
    el2, ovf4 = _bucket_exchange(
        el1, ds_home, n_slices, cap_e2, SLICE_AXIS, fills=efills
    )
    ev2 = el2[0] != sent
    b_src = el2[1].astype(jnp.int32)
    b_to = el2[2].astype(jnp.int32)
    b_tl = el2[3].astype(jnp.int32)

    next_o = jnp.full(2 * rows, -1, dtype=jnp.int32)
    next_ll = jnp.full(2 * rows, -1, dtype=jnp.int32)
    loc = jnp.where(ev2, b_src, 2 * rows)
    next_o = next_o.at[loc].set(b_to, mode="drop", unique_indices=True)
    next_ll = next_ll.at[loc].set(b_tl, mode="drop", unique_indices=True)
    overflow = (ovf1 + ovf2 + ovf3 + ovf4).astype(jnp.int32)
    lead = (1,) * n_lead
    return (
        next_o.reshape(lead + (2 * rows,)),
        next_ll.reshape(lead + (2 * rows,)),
        overflow.reshape(lead),
    )


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def partitioned_unitig_links_join_two_level_wide(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    slack: float = 4.0,
):
    """(next_owner, next_local)[2N] over a (slices, *ici) mesh: the wide
    (shard, local) id join with DCN-aggregated record exchange -- both of
    config 5's structural requirements (>2**31 states, multi-slice pod)
    at once.  Same links as the flat wide join (differential-tested)."""
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    axis_names = mesh.axis_names
    if axis_names[0] != SLICE_AXIS or len(axis_names) < 2:
        raise ValueError(
            f"two-level mesh must be (slices, *ici_axes), got {axis_names}"
        )
    ici_axes = axis_names[1:]
    ici_axis = ici_axes[0] if len(ici_axes) == 1 else ici_axes
    ici_shape = tuple(mesh.shape[a] for a in ici_axes)
    n_slices = mesh.shape[SLICE_AXIS]
    n_ici = int(np.prod(ici_shape))
    n_total = n_slices * n_ici
    n = khi.shape[0]
    if n % n_total:
        raise ValueError(f"N={n} must divide mesh size {n_total}")
    rows = n // n_total
    n_lead = 1 + len(ici_axes)
    n_local = 4 * rows
    cap1 = max(1, int(np.ceil(n_local / n_ici * slack)))
    cap2 = max(1, int(np.ceil(n_local / n_slices * slack)))
    cap_e1 = max(1, int(np.ceil(2 * rows / n_ici * slack)))
    cap_e2 = max(1, int(np.ceil(2 * rows / n_slices * slack)))

    lead = (n_slices,) + ici_shape
    zero = (0,) * n_lead

    def body(khi_b, klo_b, valid_b):
        return _links_join_body_2level_wide(
            khi_b[zero], klo_b[zero], valid_b[zero],
            k=k, n_slices=n_slices, n_ici=n_ici, ici_shape=ici_shape,
            rows=rows,
            cap1=cap1, cap2=cap2, cap_e1=cap_e1, cap_e2=cap_e2,
            ici_axis=ici_axis, n_lead=n_lead,
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(*axis_names),) * 3,
        out_specs=(P(*axis_names),) * 3,
    )
    next_o, next_l, overflow = fn(
        khi.reshape(lead + (rows,)),
        klo.reshape(lead + (rows,)),
        valid.reshape(lead + (rows,)),
    )
    return (
        next_o.reshape(2 * n),
        next_l.reshape(2 * n),
        overflow.reshape(n_total),
    )


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def partitioned_unitig_links_join_two_level(
    khi: jnp.ndarray,
    klo: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    slack: float = 4.0,
):
    """next_state[2N] via the routed sort-join over a (slices, *ici) mesh.

    Drop-in for ``part_dbg.partitioned_unitig_links_join`` on multi-slice
    jobs: boundary records cross DCN exactly once in aggregated
    per-(slice, slice) messages (n_ici^2 fewer DCN messages than the flat
    all_to_all; `comm_model.two_level_split` quantifies per workload).
    Bit-identical links to the flat router.  The jump's routed gathers
    stay on the flat router by design: request combining already bounds
    their traffic by distinct chains (extension_phase_model: >=97%
    efficiency at 256 shards), so links -- 4 records/state -- are the
    phase DCN aggregation actually helps.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    axis_names = mesh.axis_names
    if axis_names[0] != SLICE_AXIS or len(axis_names) < 2:
        raise ValueError(
            f"two-level mesh must be (slices, *ici_axes), got {axis_names}"
        )
    ici_axes = axis_names[1:]
    ici_axis = ici_axes[0] if len(ici_axes) == 1 else ici_axes
    ici_shape = tuple(mesh.shape[a] for a in ici_axes)
    n_slices = mesh.shape[SLICE_AXIS]
    n_ici = int(np.prod(ici_shape))
    n_total = n_slices * n_ici
    n = khi.shape[0]
    if n % n_total:
        raise ValueError(f"N={n} must divide mesh size {n_total}")
    rows = n // n_total
    n_lead = 1 + len(ici_axes)
    n_local = 4 * rows  # boundary records per device
    cap1 = max(1, int(np.ceil(n_local / n_ici * slack)))
    cap2 = max(1, int(np.ceil(n_local / n_slices * slack)))
    cap_e1 = max(1, int(np.ceil(2 * rows / n_ici * slack)))
    cap_e2 = max(1, int(np.ceil(2 * rows / n_slices * slack)))

    lead = (n_slices,) + ici_shape
    zero = (0,) * n_lead

    def body(khi_b, klo_b, valid_b):
        return _links_join_body_2level(
            khi_b[zero], klo_b[zero], valid_b[zero],
            k=k, n_slices=n_slices, n_ici=n_ici, ici_shape=ici_shape,
            rows=rows,
            cap1=cap1, cap2=cap2, cap_e1=cap_e1, cap_e2=cap_e2,
            ici_axis=ici_axis, n_lead=n_lead,
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(*axis_names),) * 3,
        out_specs=(P(*axis_names), P(*axis_names)),
    )
    links, overflow = fn(
        khi.reshape(lead + (rows,)),
        klo.reshape(lead + (rows,)),
        valid.reshape(lead + (rows,)),
    )
    return links.reshape(2 * n), overflow.reshape(n_total)


def two_level_mesh(n_slices: int) -> Mesh:
    """(slices, shards) mesh over all devices, n_slices on the DCN axis."""
    devs = np.array(jax.devices())
    if len(devs) % n_slices:
        raise ValueError(
            f"{len(devs)} devices do not split into {n_slices} slices"
        )
    return Mesh(
        devs.reshape(n_slices, -1), (SLICE_AXIS, SHARD_AXIS)
    )


def two_level_mesh3(n_slices: int, x: int, y: int) -> Mesh:
    """(slices, x, y) mesh: DCN axis + a 2-D intra-slice torus.

    The shape of a real multi-slice job whose slices are 2-D ICI meshes
    (e.g. 2 x (2, 2) = a (2, 2, 2) mesh); sharded_count_two_level runs
    its ICI stage over the combined (x, y) axes.
    """
    devs = np.array(jax.devices())
    if len(devs) < n_slices * x * y:
        raise ValueError(
            f"need {n_slices * x * y} devices, have {len(devs)}"
        )
    return Mesh(
        devs[: n_slices * x * y].reshape(n_slices, x, y),
        (SLICE_AXIS, "x", "y"),
    )
