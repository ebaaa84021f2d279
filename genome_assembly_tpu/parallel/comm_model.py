"""Comm counters + analytic scaling model for multi-device validation.

Virtual CPU devices share the host's cores, so bench-scaling's timing
there says nothing about multi-device efficiency.
What CAN be computed exactly without hardware is the wire traffic: every
router in this package (minimizer-owner count routing, key-hash link-join
routing) is a deterministic function of the input, so the full
shard-to-shard exchange matrix -- and from it per-phase off-device bytes,
skew, and an interconnect-roofline efficiency prediction -- is available
on any backend.  A multi-device run validates the scaling target by
comparing its measured walls against this model instead of re-deriving
the traffic from scratch.

The counters intentionally recompute ownership OUTSIDE the shard_map hot
path (same hash functions, imported from the routers) so the production
collectives carry zero instrumentation overhead.

The one-device phase rates in ``Hardware`` and every ``HostLink`` rate
have no defaults: they are measurements of the device the prediction is
for, and the caller passes them in.  The only default is the interconnect:
NVLink on an H100 host, 450 GB/s each way per device, all to all
(NVIDIA data sheet).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from genome_assembly_tpu.ops import minimizer as minimizer_ops
from genome_assembly_tpu.ops import encode
from genome_assembly_tpu.parallel.shard_count import key_owner_of, owner_of
from genome_assembly_tpu.parallel.part_dbg import _key_owner
from genome_assembly_tpu.common import SENTINEL


class Hardware(NamedTuple):
    """Per-device hardware model for the efficiency prediction.

    The rates are measured on one device of the kind predicted for.
    """

    count_records_per_s: float  # scan+count+prune pipeline
    link_records_per_s: float  # 3-lane link-join sort rows/s
    # pointer-jump round rate; a partitioned round does the same
    # per-state work plus the request sort
    jump_states_per_s: float
    # per-device bandwidth of the network BETWEEN hosts (the two-level
    # router's outer stage); used only by two_level_phase_model
    dcn_bytes_per_s: float
    # intra-host fabric per device, each direction: H100 NVLink, 900 GB/s
    # total = 450 GB/s each way, all to all (NVIDIA data sheet)
    fabric_link_bytes_per_s: float = 450e9
    fabric_utilization: float = 0.8  # achievable fraction of peak

    @property
    def fabric_bytes_per_s(self) -> float:
        return self.fabric_link_bytes_per_s * self.fabric_utilization


def count_exchange_matrix(
    codes, lengths, *, k: int, m: int, n_shards: int, parity: bool = False,
    route_by: str = "mmer",
) -> np.ndarray:
    """[n_shards, n_shards] records routed src->dst by the count phase.

    Exactly the traffic ``shard_count.sharded_count`` generates: rows are
    block-sharded over shards, each valid window record goes to
    ``owner_of(mmer)`` (route_by="mmer") or ``key_owner_of(khi, klo)``
    (route_by="key", the fast-mode balance fix).  Diagonal entries stay
    on their device.
    """
    scan = minimizer_ops.parity_scan if parity else minimizer_ops.fast_scan
    recs = scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m)
    mmer = np.asarray(recs.mmer)
    valid = np.asarray(recs.valid)
    rows = mmer.shape[0]
    if rows % n_shards:
        raise ValueError(f"rows={rows} must divide n_shards={n_shards}")
    per = rows // n_shards
    if route_by == "key":
        owner = np.asarray(
            key_owner_of(recs.kmer_hi, recs.kmer_lo, n_shards)
        ).astype(np.int64)
    else:
        owner = np.asarray(owner_of(jnp.asarray(mmer), n_shards)).astype(np.int64)
    src = np.repeat(np.arange(n_shards, dtype=np.int64), per)[:, None]
    src = np.broadcast_to(src, mmer.shape)
    flat = (src * n_shards + owner)[valid]
    return np.bincount(flat, minlength=n_shards * n_shards).reshape(
        n_shards, n_shards
    )


def links_exchange_matrix(
    khi, klo, valid, *, k: int, n_shards: int
) -> np.ndarray:
    """[n_shards, n_shards] boundary records routed src->dst by the
    distributed sort-join (``part_dbg.partitioned_unitig_links_join``).

    Each shard emits 4 records per node (OUT/IN x both strands); the
    destination is the (k-1)-mer key's hash owner (``_key_owner``).  The
    edges-home return trip is bounded by one record per state and is
    counted separately by the caller (it is <= half this phase's volume).
    """
    khi = jnp.asarray(khi)
    klo = jnp.asarray(klo)
    valid_np = np.asarray(valid)
    n = khi.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} must divide n_shards={n_shards}")
    rows = n // n_shards

    n_lo = min(k, 16)
    n_hi = k - n_lo
    rhi, rlo = encode.reverse_complement_packed(khi, klo, k)

    def keys_for(ohi, olo):
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
        return (suf_hi, suf_lo), (pre_hi, pre_lo)

    mats = np.zeros((n_shards, n_shards), dtype=np.int64)
    node_src = (np.arange(n, dtype=np.int64) // rows)
    for ohi, olo in ((khi, klo), (rhi, rlo)):
        (shi, slo), (phi, plo) = keys_for(ohi, olo)
        for qhi, qlo in ((shi, slo), (phi, plo)):
            owner = np.asarray(_key_owner(qhi, qlo, n_shards)).astype(np.int64)
            flat = (node_src * n_shards + owner)[valid_np]
            mats += np.bincount(
                flat, minlength=n_shards * n_shards
            ).reshape(n_shards, n_shards)
    return mats


def jump_request_matrices(next_state, *, n_shards: int):
    """Exact per-phase request matrices of ``partitioned_pointer_jump``.

    Replicates the router's own logic in numpy: the predecessor-table
    build routes each (dest, src) edge to dest's range owner WITHOUT
    deduplication (``_pack_by_owner``), while every doubling round and the
    final cycle probe route one request per DISTINCT remote parent per
    shard (``_routed_gather``'s request combining).  Traffic is identical
    for the wide (shard, local) pipeline -- only the lane count differs.

    Returns (pred_matrix, [round matrices x steps], final_matrix), each
    [n_shards, n_shards] request counts (diagonal = answered locally,
    zero by construction since local requests are never routed).
    """
    ns = np.asarray(next_state, dtype=np.int64)
    n2 = ns.shape[0]
    if n2 % n_shards:
        raise ValueError(f"n2={n2} must divide n_shards={n_shards}")
    rows2 = n2 // n_shards
    ids = np.arange(n2, dtype=np.int64)
    shard_of = ids // rows2

    def req_matrix(dests, dedup):
        mat = np.zeros((n_shards, n_shards), dtype=np.int64)
        for s in range(n_shards):
            d = dests[s * rows2 : (s + 1) * rows2]
            d = d[d >= 0]
            if dedup:
                d = np.unique(d)
            owner = d // rows2
            owner = owner[owner != s]
            mat[s] += np.bincount(owner, minlength=n_shards)
        return mat

    pred_mat = req_matrix(np.where(ns >= 0, ns, -1), dedup=False)

    pred = np.full(n2, -1, dtype=np.int64)
    pred[ns[ns >= 0]] = ids[ns >= 0]
    parent = np.where(pred >= 0, pred, ids)

    steps = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
    round_mats = []
    for _ in range(steps):
        round_mats.append(req_matrix(parent, dedup=True))
        parent = parent[parent]
    final_mat = req_matrix(parent, dedup=True)
    return pred_mat, round_mats, final_mat


def gather_phase_model(
    matrix: np.ndarray,
    *,
    resp_lanes: int,
    states_per_shard: int,
    states_per_s: float,
    req_lanes: int = 1,
    hw: Hardware,
) -> dict:
    """One routed-gather phase: requests go src->dst (``req_lanes`` uint32
    each), responses return dst->src (``resp_lanes`` uint32 each).

    Unlike phase_model's one-way records, both directions ride the wire:
    per chip, send bytes = its outgoing requests + the responses it owes,
    recv bytes = the mirror.  Compute is the per-shard state update
    (sort + gather apply), bounded below by states_per_shard regardless
    of traffic.
    """
    n = matrix.shape[0]
    out_req = matrix.sum(axis=1).astype(np.float64)
    in_req = matrix.sum(axis=0).astype(np.float64)
    send = 4 * (req_lanes * out_req + resp_lanes * in_req)
    recv = 4 * (req_lanes * in_req + resp_lanes * out_req)
    wire = float(np.maximum(send, recv).max()) if n > 1 else 0.0
    t_comm = wire / hw.fabric_bytes_per_s
    t_comp = states_per_shard / states_per_s
    return {
        "requests_total": int(matrix.sum()),
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "t_serial_s": t_comp + t_comm,
        "t_overlap_s": max(t_comp, t_comm),
    }


def extension_phase_model(
    links_matrix: np.ndarray,
    next_state,
    *,
    n_shards: int,
    wide: bool = False,
    hw: Hardware,
) -> dict:
    """End-to-end distributed-extension efficiency: the routed link join
    plus every pointer-jump round's routed gather, from the routers' own
    exact traffic (``links_exchange_matrix`` + ``jump_request_matrices``).

    ``wide`` widens the payloads to the (shard, local) id pipeline's lane
    counts (config 5's >2**31-state form): link records 4 lanes, gather
    requests 1 lane (local index; the owner IS the routing key), gather
    responses 6 lanes (parent pair, 64-bit rank, min pair).
    """
    n2 = len(np.asarray(next_state))
    rows2 = n2 // n_shards
    link_lanes = 4 if wide else 3
    resp_lanes = 6 if wide else 3
    link_phase = phase_model(
        links_matrix, bytes_per_record=4 * link_lanes,
        records_per_s=hw.link_records_per_s, hw=hw,
    )
    pred_mat, round_mats, final_mat = jump_request_matrices(
        next_state, n_shards=n_shards
    )
    serial = link_phase["t_compute_s"] + link_phase["t_comm_s"]
    overlap = max(link_phase["t_compute_s"], link_phase["t_comm_s"])
    peak_pair = int(pred_mat.max())
    req_total = 0
    # pred build: one-way (dest_local, src) records, no response; rounds:
    # 1-lane requests, (parent, rank, min) responses; final cycle probe:
    # 1-lane requests, 1-lane pred response
    for mat, rq, rp in (
        [(pred_mat, 2, 0)]
        + [(m, 1, resp_lanes) for m in round_mats]
        + [(final_mat, 1, 1)]
    ):
        g = gather_phase_model(
            mat, req_lanes=rq, resp_lanes=rp, states_per_shard=rows2,
            states_per_s=hw.jump_states_per_s, hw=hw,
        )
        serial += g["t_serial_s"]
        overlap += g["t_overlap_s"]
        peak_pair = max(peak_pair, int(mat.max()))
        req_total += g["requests_total"]
    steps = len(round_mats)
    t_1chip = (
        int(links_matrix.sum()) / hw.link_records_per_s
        + (steps + 2) * n2 / hw.jump_states_per_s
    )
    return {
        "shards": n_shards,
        "jump_rounds": steps,
        "requests_total": req_total,
        "peak_pair_requests": peak_pair,
        "t_serial_s": serial,
        "t_overlap_s": overlap,
        "eff_serial": t_1chip / (n_shards * serial) if serial else 1.0,
        "eff_overlap": t_1chip / (n_shards * overlap) if overlap else 1.0,
    }


def two_level_split(
    matrix: np.ndarray, *, n_slices: int
) -> dict:
    """Split a flat exchange matrix into ICI vs DCN volumes under the
    two-level router (parallel/two_level.py).

    Devices are slice-major (global shard g = slice * n_ici + intra), as
    the two-level mesh lays them out.  Stage 1 moves every off-device
    record once over ICI (to the owner's intra-slice column); stage 2
    moves records whose owner sits on another slice exactly once over
    DCN, aggregated per (slice, slice) pair per column.  A flat
    all_to_all would instead push ALL cross-slice records as individual
    (device, device) DCN messages -- same bytes, n_ici^2 more messages --
    so the interesting numbers are the DCN byte volume and the message
    aggregation factor.
    """
    n = matrix.shape[0]
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    n_ici = n // n_slices
    src_slice = np.arange(n) // n_ici
    cross = src_slice[:, None] != src_slice[None, :]
    # stage 1 moves a record over ICI iff its owner's intra-slice index
    # differs from its source device's
    src_intra = np.arange(n) % n_ici
    cross_intra = src_intra[:, None] != src_intra[None, :]
    ici_records = int(matrix[cross_intra].sum())
    dcn_records = int(matrix[cross].sum())
    # per-source-device DCN load (stage 2 sends from the stage-1 owner
    # column, which holds ~1/n_ici of its slice's cross-slice records)
    slice_cross = matrix.reshape(n_slices, n_ici, n_slices, n_ici).sum(
        axis=(1, 3)
    )
    np.fill_diagonal(slice_cross, 0)
    per_device_dcn = slice_cross.sum(axis=1) / n_ici  # balanced by hash
    return {
        "n_slices": n_slices,
        "n_ici": n_ici,
        "ici_records": ici_records,
        "dcn_records": dcn_records,
        "dcn_fraction": dcn_records / max(int(matrix.sum()), 1),
        "dcn_records_max_device": float(per_device_dcn.max()),
        "dcn_messages_two_level": n_slices * (n_slices - 1) * n_ici,
        "dcn_messages_flat": int(cross.sum()),  # one per device pair
    }


def two_level_phase_model(
    matrix: np.ndarray,
    *,
    n_slices: int,
    bytes_per_record: int,
    records_per_s: float,
    n_batches: int = 1,
    hw: Hardware,
) -> dict:
    """Pod-scale efficiency under the two-level ICI/DCN router.

    Exact per-device stage traffic from the exchange matrix, with devices
    laid out slice-major (global shard g = slice * n_ici + intra) as
    two_level.two_level_mesh does:

      stage 1 (ICI, within each slice): device d sends the records it
        holds for global owner o to device (slice(d), intra(o)).
      stage 2 (DCN, across slices): staging device (s, j) forwards the
        records owned by (s', j), s' != s -- ONE aggregated message per
        destination slice per column.
      count: the final owner processes everything it received.

    Walls are per-device bottleneck maxima over send/recv bytes at the
    stage's fabric bandwidth (intra-host derated, inter-host an input --
    see Hardware.dcn_bytes_per_s).  ``n_batches`` > 1 applies the same
    software-pipeline schedule as pipeline_model with the wire term being
    the SUM of both stages (they serialize on the same records):
    T = c + (B-1) * max(c, w) + w.
    """
    n = matrix.shape[0]
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    n_ici = n // n_slices
    dev_slice = np.arange(n) // n_ici
    dev_intra = np.arange(n) % n_ici

    # stage 1 per-device send/recv (records)
    same_intra = dev_intra[:, None] == dev_intra[None, :]
    send1 = (matrix * ~same_intra).sum(axis=1)
    # recv at (s, j): records from any d in slice s owned by any o with
    # intra(o) == j (excluding what d itself already holds for j == its own)
    recv1 = np.zeros(n)
    for s in range(n_slices):
        rows = matrix[dev_slice == s]  # [n_ici, n]
        src_intra = dev_intra[dev_slice == s]
        for j in range(n_ici):
            cols = rows[:, dev_intra == j]  # owners in column j
            recv1[s * n_ici + j] = cols.sum() - cols[src_intra == j].sum()

    # stage 2 per-device send/recv (records), from staging column to the
    # owner's slice
    send2 = np.zeros(n)
    recv2 = np.zeros(n)
    for s in range(n_slices):
        rows = matrix[dev_slice == s]
        for j in range(n_ici):
            col_owners = (dev_intra == j)
            for s2 in range(n_slices):
                vol = rows[:, col_owners & (dev_slice == s2)].sum()
                if s2 != s:
                    send2[s * n_ici + j] += vol
                    recv2[s2 * n_ici + j] += vol

    recv_final = matrix.sum(axis=0)
    total = int(matrix.sum())
    t_comp = float(recv_final.max()) / records_per_s
    t_ici = (
        float(np.maximum(send1, recv1).max()) * bytes_per_record
        / hw.fabric_bytes_per_s
    )
    t_dcn = (
        float(np.maximum(send2, recv2).max()) * bytes_per_record
        / hw.dcn_bytes_per_s
    )
    t_wire = t_ici + t_dcn
    t_comp_1chip = total / records_per_s
    B = max(n_batches, 1)
    c, w = t_comp / B, t_wire / B
    t_pipe = c + (B - 1) * max(c, w) + w
    return {
        "shards": n,
        "n_slices": n_slices,
        "t_compute_s": t_comp,
        "t_ici_s": t_ici,
        "t_dcn_s": t_dcn,
        "eff_serial": t_comp_1chip / (n * (t_comp + t_wire)),
        "eff_overlap": t_comp_1chip / (n * max(t_comp, t_wire)),
        "eff_pipelined": t_comp_1chip / (n * t_pipe),
        "n_batches": B,
    }


def pipeline_model(
    matrix: np.ndarray,
    *,
    n_batches: int,
    bytes_per_record: int,
    records_per_s: float,
    hw: Hardware,
) -> dict:
    """Scaling efficiency of the SOFTWARE-PIPELINED multi-batch count
    (shard_count.sharded_count_batches pipelined=True).

    The stream is split into n_batches equal batches; each dispatched
    program exchanges batch i-1 while scanning batch i, so the steady
    state costs max(t_scan_b, t_comm_b) per batch and only the fill/drain
    edges pay one un-overlapped scan and exchange:

        T = t_scan_b + (B-1) * max(t_scan_b, t_comm_b) + t_comm_b

    As B grows this converges to phase_model's eff_overlap; at B=1 it IS
    eff_serial.  The reported ``eff_pipelined`` is the engineered number
    the >=80% multi-host scaling target is judged against.

    matrix is the FULL stream's exchange matrix; per-batch traffic is
    matrix/B (minimizer ownership is stream-position-independent, so the
    split is exact in expectation and the skew term is unchanged).
    """
    n = matrix.shape[0]
    base = phase_model(
        matrix, bytes_per_record=bytes_per_record,
        records_per_s=records_per_s, hw=hw,
    )
    t_comp_b = base["t_compute_s"] / n_batches
    t_comm_b = base["t_comm_s"] / n_batches
    t_total = t_comp_b + max(0, n_batches - 1) * max(t_comp_b, t_comm_b) + t_comm_b
    t_comp_1chip = int(matrix.sum()) / records_per_s
    return {
        **base,
        "n_batches": n_batches,
        "t_pipelined_s": t_total,
        "eff_pipelined": t_comp_1chip / (n * t_total) if t_total else 1.0,
    }


def phase_model(
    matrix: np.ndarray,
    *,
    bytes_per_record: int,
    records_per_s: float,
    hw: Hardware,
) -> dict:
    """Per-phase comm/compute seconds and predicted scaling efficiency.

    matrix[i, j] = records shard i sends shard j (diagonal = stays local).
    Efficiency is reported as a band:
      eff_overlap   -- compute and comm fully overlapped (max of the two)
      eff_serial    -- no overlap (sum), the pessimistic bound
    both against a perfect n-chip split of the single-chip compute time.
    """
    n = matrix.shape[0]
    total = int(matrix.sum())
    offchip = matrix.sum(axis=1) - np.diag(matrix)
    inbound = matrix.sum(axis=0) - np.diag(matrix)
    wire = np.maximum(offchip, inbound)  # per-chip bottleneck direction
    max_wire_bytes = float(wire.max()) * bytes_per_record if n > 1 else 0.0
    recv = matrix.sum(axis=0)
    t_comp_1chip = total / records_per_s
    t_comp = float(recv.max()) / records_per_s  # skew-aware per-chip compute
    t_comm = max_wire_bytes / hw.fabric_bytes_per_s
    t_overlap = max(t_comp, t_comm)
    t_serial = t_comp + t_comm
    return {
        "shards": n,
        "records_total": total,
        "offchip_records_max": int(wire.max()) if n > 1 else 0,
        "offchip_fraction": (
            float(offchip.sum()) / total if total else 0.0
        ),
        "recv_skew": float(recv.max() / max(recv.mean(), 1e-9)),
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "eff_overlap": t_comp_1chip / (n * t_overlap) if t_overlap else 1.0,
        "eff_serial": t_comp_1chip / (n * t_serial) if t_serial else 1.0,
    }


class HostLink(NamedTuple):
    """Host<->device path model for SINGLE-chip out-of-core phases.

    The parked link build (and the out-of-core count) are not
    collective-bound -- they are bound by the host<->device path: one
    host round-trip per dispatched jit, streamed key uploads, and (with
    parked links) per-partition edge readback.  Every rate is measured
    on the machine predicted for; none has a default.
    """

    dispatch_s: float  # host round-trip per dispatched jit
    upload_bytes_per_s: float
    readback_bytes_per_s: float
    sort4_rows_per_s: float  # 4-lane extraction sort
    sort3_rows_per_s: float  # 3-lane partition sort-join
    scatter_rows_per_s: float  # device link scatter (no parking)


def parked_links_model(
    n_nodes: int,
    *,
    partitions: int,
    chunk_nodes: int = 1 << 23,
    group_size: int | None = None,
    group_budget_bytes: int = 5 << 30,
    park_keys: bool = True,
    park_links: bool = True,
    link: HostLink,
) -> dict:
    """Wall budget for ops/dbg.build_unitig_links_parked.

    Mirrors the builder's own pass arithmetic (same range_group_plan
    call, so G and the pass count are EXACTLY what the builder will use;
    pinned by tests/test_comm_model.py against the builder's on_event
    stream) and prices each pass from the HostLink rates:

      pass sweep  = n_chunks x (dispatch + key upload + extraction sort)
      partition   = dispatch + 3-lane sort-join + edge readback/scatter
      total       = ceil(P/G) x sweep + P x partition

    Which term dominates depends on the host link: with a slow readback
    the parked-edge readback (2N x 8 B) and the dispatch round-trips
    outweigh the sorts; over PCIe the phase is sort-bound.
    """
    from genome_assembly_tpu.ops import outofcore

    n_chunks = int(np.ceil(n_nodes / chunk_nodes))
    rec_per_chunk = 4 * chunk_nodes
    cap_bp, G = outofcore.range_group_plan(
        n_chunks, rec_per_chunk, partitions=partitions,
        bytes_per_record=12, budget_bytes=group_budget_bytes,
        group_size=group_size, sigma_scale=2.9,
    )
    n_passes = int(np.ceil(partitions / G))
    upload_bytes = chunk_nodes * 9 if park_keys else 0
    t_chunk_dispatch = link.dispatch_s
    t_chunk_upload = upload_bytes / link.upload_bytes_per_s
    t_chunk_sort = rec_per_chunk / link.sort4_rows_per_s
    t_sweep = n_chunks * (t_chunk_dispatch + t_chunk_upload + t_chunk_sort)

    recs_per_part = 4.0 * n_nodes / partitions
    edges_per_part = 2.0 * n_nodes / partitions  # <= one out-edge/state
    t_part_sort = recs_per_part / link.sort3_rows_per_s
    t_part_io = (
        edges_per_part * 8 / link.readback_bytes_per_s
        if park_links
        else edges_per_part / link.scatter_rows_per_s
    )
    t_part = link.dispatch_s + t_part_sort + t_part_io

    t_dispatch_total = (
        n_passes * n_chunks * t_chunk_dispatch + partitions * link.dispatch_s
    )
    total = n_passes * t_sweep + partitions * t_part
    return {
        "n_nodes": n_nodes,
        "partitions": partitions,
        "chunk_nodes": chunk_nodes,
        "n_chunks": n_chunks,
        "group_size": int(G),
        "cap_bp": int(cap_bp),
        "n_passes": n_passes,
        "t_pass_sweep_s": t_sweep,
        "t_partition_s": t_part,
        "t_dispatch_total_s": t_dispatch_total,
        "t_total_s": total,
        "dispatch_fraction": t_dispatch_total / total,
    }
