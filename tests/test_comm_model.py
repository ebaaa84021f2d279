"""Comm counters match the traffic the real collectives carry.

The exchange matrices are computed OUTSIDE the shard_map hot path with
the same ownership hashes the routers import; these tests pin that the
model's numbers equal what sharded_count / the link join actually route
on the 8-device mesh.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from genome_assembly_tpu.ops import count as count_ops
from genome_assembly_tpu.ops import minimizer
from genome_assembly_tpu.parallel import comm_model, mesh as mesh_lib
from genome_assembly_tpu.parallel import shard_count


K, M = 21, 5

# Stand-in one-device rates: the model takes measured rates as inputs, and
# these tests check its arithmetic, not any device's speed.
HW = comm_model.Hardware(
    count_records_per_s=5e8, link_records_per_s=3e8,
    jump_states_per_s=1.5e8, dcn_bytes_per_s=25e9,
)
SLOW_LINK = comm_model.HostLink(
    dispatch_s=0.4, upload_bytes_per_s=150e6, readback_bytes_per_s=10e6,
    sort4_rows_per_s=250e6, sort3_rows_per_s=300e6, scatter_rows_per_s=150e6,
)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    reads = 256
    codes = rng.integers(0, 4, size=(reads, 64), dtype=np.uint8)
    lengths = np.full((reads,), 64, dtype=np.int32)
    return codes, lengths


def test_count_matrix_matches_sharded_count(batch):
    """Column sums of the model's matrix == records each shard actually
    received (sharded_count's per-shard valid rows)."""
    codes, lengths = batch
    n = 8
    assert jax.device_count() == n
    mat = comm_model.count_exchange_matrix(
        codes, lengths, k=K, m=M, n_shards=n
    )
    mesh = mesh_lib.make_mesh(n)
    sc = shard_count.sharded_count(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.arange(codes.shape[0], dtype=jnp.uint32),
        k=K, m=M, parity=False, cutoff=1, mesh=mesh,
    )
    assert int(np.asarray(sc.overflow).sum()) == 0
    received = np.asarray(sc.valid).reshape(n, -1).sum(axis=1)
    assert np.array_equal(mat.sum(axis=0), received)
    # row sums: every shard's valid scan records all get routed somewhere
    recs = minimizer.fast_scan(jnp.asarray(codes), jnp.asarray(lengths),
                               k=K, m=M)
    per_shard_valid = np.asarray(recs.valid).reshape(n, -1).sum(axis=1)
    assert np.array_equal(mat.sum(axis=1), per_shard_valid)


def test_links_matrix_row_sums(batch):
    """Every valid node emits exactly 4 boundary records from its home
    shard; totals and row sums must say so."""
    codes, lengths = batch
    recs = minimizer.fast_scan(jnp.asarray(codes), jnp.asarray(lengths),
                               k=K, m=M)
    kc = count_ops.count_keys(recs, cutoff=0)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    n = 8
    mat = comm_model.links_exchange_matrix(khi, klo, valid, k=K, n_shards=n)
    valid_np = np.asarray(valid)
    rows = valid_np.shape[0] // n
    per_shard_nodes = valid_np.reshape(n, rows).sum(axis=1)
    assert np.array_equal(mat.sum(axis=1), 4 * per_shard_nodes)
    assert mat.sum() == 4 * valid_np.sum()


def test_phase_model_bounds():
    n = 8
    rng = np.random.default_rng(0)
    mat = rng.integers(100, 1000, size=(n, n)).astype(np.int64)
    out = comm_model.phase_model(
        mat, bytes_per_record=20, records_per_s=5e8, hw=HW
    )
    assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0 + 1e-9
    assert out["records_total"] == int(mat.sum())
    assert 0.0 <= out["offchip_fraction"] <= 1.0
    # single shard: no communication, perfect efficiency
    solo = comm_model.phase_model(
        mat[:1, :1], bytes_per_record=20, records_per_s=5e8, hw=HW
    )
    assert solo["t_comm_s"] == 0.0
    assert solo["eff_overlap"] == pytest.approx(1.0)
    assert solo["eff_serial"] == pytest.approx(1.0)


def test_two_level_split_counts(batch):
    """ICI/DCN split of the count matrix matches a direct recount of
    which records cross intra-slice columns vs slices."""
    codes, lengths = batch
    n, n_slices = 8, 2
    mat = comm_model.count_exchange_matrix(
        codes, lengths, k=K, m=M, n_shards=n
    )
    out = comm_model.two_level_split(mat, n_slices=n_slices)
    n_ici = n // n_slices
    src = np.arange(n)
    dcn = sum(
        int(mat[i, j])
        for i in src for j in src
        if i // n_ici != j // n_ici
    )
    ici = sum(
        int(mat[i, j])
        for i in src for j in src
        if i % n_ici != j % n_ici
    )
    assert out["dcn_records"] == dcn
    assert out["ici_records"] == ici
    assert out["n_ici"] == n_ici
    # aggregation: two-level sends one DCN message per (slice pair,
    # column); flat sends one per cross-slice device pair -- n_ici x more
    assert out["dcn_messages_flat"] == n_ici * out["dcn_messages_two_level"]


def test_pipeline_model_band():
    """pipeline_model interpolates the phase_model band: B=1 equals the
    serial bound, large B converges to the overlap bound, and efficiency
    is monotone in B."""
    import numpy as np

    from genome_assembly_tpu.parallel import comm_model

    rng = np.random.default_rng(3)
    n = 16
    mat = rng.integers(1000, 2000, (n, n)).astype(np.int64)
    kw = dict(bytes_per_record=20, records_per_s=5e8, hw=HW)
    base = comm_model.phase_model(mat, **kw)
    p1 = comm_model.pipeline_model(mat, n_batches=1, **kw)
    assert abs(p1["eff_pipelined"] - base["eff_serial"]) < 1e-12
    prev = 0.0
    for b in (1, 2, 4, 16, 64, 1024):
        pb = comm_model.pipeline_model(mat, n_batches=b, **kw)
        assert pb["eff_pipelined"] >= prev - 1e-12
        prev = pb["eff_pipelined"]
    assert abs(prev - base["eff_overlap"]) < 0.05 * base["eff_overlap"]


def test_two_level_phase_model_consistency(batch):
    """The pod-scale ICI/DCN phase model's per-device stage volumes must
    sum to two_level_split's totals, every record must be processed
    exactly once, and with an infinitely fast DCN the model reduces to a
    flat one-stage wire bound no worse than phase_model's."""
    codes, lengths = batch
    n, n_slices = 8, 2
    mat = comm_model.count_exchange_matrix(
        codes, lengths, k=K, m=M, n_shards=n
    )
    out = comm_model.two_level_phase_model(
        mat, n_slices=n_slices, bytes_per_record=20, records_per_s=5e8, hw=HW
    )
    assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0
    assert out["eff_serial"] <= out["eff_pipelined"] <= out["eff_overlap"]
    # stage volumes: recompute totals independently
    split = comm_model.two_level_split(mat, n_slices=n_slices)
    hw = HW
    # t_dcn uses the bottleneck device; the TOTAL stage-2 records equal
    # split's dcn_records -- verify via a uniform matrix where bottleneck
    # x devices == total exactly
    uni = np.full((n, n), 1000, dtype=np.int64)
    u = comm_model.two_level_phase_model(
        uni, n_slices=n_slices, bytes_per_record=1, records_per_s=1e9,
        hw=HW,
    )
    usplit = comm_model.two_level_split(uni, n_slices=n_slices)
    # per-device DCN send under uniformity = dcn_records / n
    want_tdcn = (usplit["dcn_records"] / n) / hw.dcn_bytes_per_s
    assert abs(u["t_dcn_s"] - want_tdcn) < 1e-12
    want_tici = (usplit["ici_records"] / n) / hw.fabric_bytes_per_s
    assert abs(u["t_ici_s"] - want_tici) < 1e-12
    # pipelining helps (or matches) at any B
    b8 = comm_model.two_level_phase_model(
        mat, n_slices=n_slices, bytes_per_record=20, records_per_s=5e8,
        n_batches=8, hw=HW,
    )
    assert b8["eff_pipelined"] >= out["eff_serial"] - 1e-12


def _jump_test_graph(n2=512):
    """Long cross-shard chain + a cycle + short chains (the same shape the
    wide-jump differential test uses)."""
    next_state = np.full(n2, -1, dtype=np.int32)
    chain = np.arange(0, n2, 9)
    for a, b in zip(chain[:-1], chain[1:]):
        next_state[a] = b
    cyc = np.arange(100, 116)
    cyc = cyc[~np.isin(cyc, chain)]
    for a, b in zip(cyc, np.roll(cyc, -1)):
        next_state[a] = b
    for a in range(480, 500, 2):
        if next_state[a] < 0 and a + 1 not in chain:
            next_state[a] = a + 1
    return next_state


def test_jump_matrices_pin_routing_caps():
    """The jump traffic model's peak per-(src,dst) request count is EXACTLY
    the implementation's overflow threshold: a routing capacity equal to
    the model's peak runs clean, one below overflows.  This pins every
    phase the model enumerates (non-deduplicated pred build, per-round
    deduplicated gathers, final cycle probe) to what
    partitioned_pointer_jump actually routes."""
    from genome_assembly_tpu.parallel import part_dbg

    n_shards = 8
    mesh = mesh_lib.make_mesh(n_shards)
    next_state = _jump_test_graph()
    rows2 = next_state.shape[0] // n_shards

    pred_mat, round_mats, final_mat = comm_model.jump_request_matrices(
        next_state, n_shards=n_shards
    )
    R = max(int(m.max()) for m in [pred_mat, final_mat] + round_mats)
    assert R >= 2, "test graph too sparse to distinguish capacities"

    ns = jnp.asarray(next_state)
    _, ovf_ok = part_dbg.partitioned_pointer_jump(
        ns, mesh=mesh, slack=R * n_shards / rows2
    )
    assert int(np.sum(np.asarray(ovf_ok))) == 0
    _, ovf_low = part_dbg.partitioned_pointer_jump(
        ns, mesh=mesh, slack=(R - 1) * n_shards / rows2
    )
    assert int(np.sum(np.asarray(ovf_low))) > 0


def test_extension_phase_model_bounds(batch):
    """Extension-phase efficiency stays in (0, 1], overlap >= serial, and
    the wide pipeline's extra lanes only add wire time."""
    codes, lengths = batch
    recs = minimizer.fast_scan(
        jnp.asarray(codes), jnp.asarray(lengths), k=K, m=M
    )
    kc = count_ops.count_keys(recs, cutoff=0)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    from genome_assembly_tpu.ops import dbg

    links = np.asarray(
        dbg.build_unitig_links_join(khi, klo, valid, k=K)
    )
    n_shards = 8
    lmat = comm_model.links_exchange_matrix(
        khi, klo, valid, k=K, n_shards=n_shards
    )
    narrow = comm_model.extension_phase_model(
        lmat, links, n_shards=n_shards, wide=False, hw=HW
    )
    wide = comm_model.extension_phase_model(
        lmat, links, n_shards=n_shards, wide=True, hw=HW
    )
    for out in (narrow, wide):
        assert 0 < out["eff_serial"] <= out["eff_overlap"] <= 1.0 + 1e-9
        assert out["t_serial_s"] >= out["t_overlap_s"] > 0
    assert wide["t_serial_s"] >= narrow["t_serial_s"]
    assert wide["requests_total"] == narrow["requests_total"]


def test_parked_links_model_pins_builder_pass_structure(batch):
    """parked_links_model's pass arithmetic (G, pass count, chunks per
    sweep, partitions) is EXACTLY what build_unitig_links_parked
    performs -- pinned through the builder's on_event stream, so a
    group-plan change that shifts the real pass structure breaks this
    test before it silently invalidates SCALE.md's link budget."""
    codes, lengths = batch
    recs = minimizer.fast_scan(
        jnp.asarray(codes), jnp.asarray(lengths), k=K, m=M
    )
    kc = count_ops.count_keys(recs, cutoff=0)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    from genome_assembly_tpu.ops import dbg

    want = np.asarray(dbg.build_unitig_links_join(khi, klo, valid, k=K))

    partitions, chunk_nodes = 5, 1 << 10
    budget = 64 << 10
    events = []
    links, ovf = dbg.build_unitig_links_parked(
        np.asarray(khi), np.asarray(klo), np.asarray(valid), k=K,
        partitions=partitions, chunk_nodes=chunk_nodes,
        group_budget_bytes=budget, park_links=True,
        on_event=lambda kind, **kw: events.append((kind, kw)),
    )
    assert ovf == 0
    np.testing.assert_array_equal(np.asarray(links), want)

    model = comm_model.parked_links_model(
        int(khi.shape[0]), partitions=partitions, chunk_nodes=chunk_nodes,
        group_budget_bytes=budget, link=SLOW_LINK,
    )
    passes = [kw for kind, kw in events if kind == "link_pass"]
    parts = [kw for kind, kw in events if kind == "link_partition"]
    assert len(passes) == model["n_passes"]
    assert all(p["chunks"] == model["n_chunks"] for p in passes)
    assert len(parts) == partitions
    assert all(p["n_edges"] >= 0 for p in parts)
    # predicted walls are positive, and a faster host link predicts a
    # shorter wall
    assert model["t_total_s"] > 0
    pcie = comm_model.parked_links_model(
        int(khi.shape[0]), partitions=partitions, chunk_nodes=chunk_nodes,
        group_budget_bytes=budget,
        link=SLOW_LINK._replace(
            dispatch_s=1e-3, upload_bytes_per_s=10e9,
            readback_bytes_per_s=10e9,
        ),
    )
    assert pcie["t_total_s"] < model["t_total_s"]
