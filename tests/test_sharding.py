"""Multi-device paths on the 8-device virtual CPU mesh.

Same shard_map code runs on a multi-GPU mesh; here we assert the
distributed results equal the single-device ones exactly (deterministic
sharding -- SURVEY.md section 4 item 3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.io import datagen, reads as reads_io
from genome_assembly_tpu.models.pipeline import ParityAssembler
from genome_assembly_tpu.ops import encode
from genome_assembly_tpu.parallel import halo, mesh as mesh_lib, shard_count


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return mesh_lib.make_mesh(8)


def _batch(reads, max_len, pad_to):
    (b,) = reads_io.batch_reads(reads, max_len)
    return reads_io.pad_batch(b, pad_to)


@pytest.mark.parametrize("parity", [True, False])
def test_sharded_counts_equal_single_device(mesh8, parity):
    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=800, read_len=48, coverage=6, seed=2, with_reverse=not parity
    )
    b = _batch(reads, 64, 8 * ((len(reads) + 7) // 8))
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        k=k,
        m=m,
        parity=parity,
        cutoff=cutoff,
        mesh=mesh8,
    )
    assert int(np.sum(np.asarray(sc.overflow))) == 0
    got = shard_count.sharded_to_host_dict(sc, k, m)

    # single-device reference
    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import minimizer as minimizer_ops
    from genome_assembly_tpu.parity import table as table_ops

    scan = minimizer_ops.parity_scan if parity else minimizer_ops.fast_scan
    recs = scan(jnp.asarray(b.codes), jnp.asarray(b.lengths), k=k, m=m)
    counted = count_ops.count_and_prune(
        recs, jnp.asarray(b.read_ids), cutoff=cutoff
    )
    host = table_ops.extract_groups(counted, pruned=True)
    want = table_ops.decode_table(host, k, m)
    if parity:
        assert got == want
    else:
        # fast mode read-id list order inside equal-count groups can differ
        # across routing; compare keys and counts
        assert {kk: sorted(v) for kk, v in got.items()} == {
            kk: sorted(v) for kk, v in want.items()
        }


def test_sharded_count_overflow_detection(mesh8):
    """Tiny slack must trip the overflow counter, not silently drop."""
    reads = ["A" * 48] * 64  # all identical minimizers -> one hot owner
    b = _batch(reads, 64, 64)
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        k=11,
        m=5,
        parity=False,
        cutoff=1,
        mesh=mesh8,
        slack=0.05,
    )
    assert int(np.sum(np.asarray(sc.overflow))) > 0


def test_halo_exchange_covers_every_window(mesh8):
    k = 11
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), size=1000))
    codes = encode.encode_str(genome)
    segments, lens = halo.split_sequence(codes, 8, k)
    ext, ext_lens = halo.haloed_segments(
        jnp.asarray(segments), jnp.asarray(lens), k=k, mesh=mesh8
    )
    ext = np.asarray(ext)
    ext_lens = np.asarray(ext_lens)
    # reassemble all windows scanned per shard; must equal the full
    # sequence's window set exactly once each
    windows = []
    for s in range(8):
        seg = ext[s, : ext_lens[s]]
        for i in range(len(seg) - k + 1):
            windows.append(encode.decode_str(seg[i : i + k]))
    want = [genome[i : i + k] for i in range(len(genome) - k + 1)]
    assert sorted(windows) == sorted(want)
    assert len(windows) == len(want)


def test_sharded_dbg_matches_single_device(mesh8):
    """Sharded link building + pointer jumping == single-device results."""
    from genome_assembly_tpu.ops import dbg, encode
    from genome_assembly_tpu.parallel import shard_dbg

    k = 11
    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want_links = dbg.build_unitig_links(hi, lo, valid, k=k)
    got_links = shard_dbg.sharded_unitig_links(hi, lo, valid, k=k, mesh=mesh8)
    assert np.array_equal(np.asarray(got_links), np.asarray(want_links))

    want_graph = dbg.pointer_jump(want_links)
    got_graph = shard_dbg.sharded_pointer_jump(got_links, mesh=mesh8)
    assert np.array_equal(np.asarray(got_graph.head), np.asarray(want_graph.head))
    assert np.array_equal(np.asarray(got_graph.rank), np.asarray(want_graph.rank))
    assert np.array_equal(
        np.asarray(got_graph.is_cycle), np.asarray(want_graph.is_cycle)
    )


def test_distributed_parity_exact_unitigs(mesh8, reference_file):
    """Distributed counting + native replay == golden unitigs, exact order."""
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    lines, _ = asm.assemble(reads, mesh=mesh8)
    import pathlib

    golden = (
        pathlib.Path(__file__).parent / "golden/input_k6m3_unitigs.txt"
    ).read_text().splitlines()
    assert lines == golden


@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_distributed_parity_multibatch_exact(mesh8, routing):
    """Multi-batch distributed parity (reads spanning several device
    batches, groups spanning batches) == single-device output exactly,
    under both padded and ragged routing."""
    from genome_assembly_tpu.io import datagen

    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=500, read_len=30, coverage=8, seed=21, with_reverse=False
    )
    cfg = PipelineConfig(k=8, m=4, max_read_len=32, batch_reads=40)
    asm = ParityAssembler(cfg)
    assert len(reads) > cfg.batch_reads  # really multi-batch
    want, _ = asm.assemble(reads)
    got, _ = asm.assemble(reads, mesh=mesh8, routing=routing)
    assert got == want


@pytest.mark.parametrize("wide", [False, True])
def test_distributed_fast_pipeline_equals_single_device(mesh8, wide):
    """Full fast pipeline over the mesh == single-device unitig set.

    wide=True forces the (shard, local) wide-id extension (config 5's
    >2**31-state representation) end-to-end through the library surface,
    including the int64 host materialization."""
    from genome_assembly_tpu.models.pipeline import FastAssembler

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=700, read_len=48, coverage=8, seed=13, with_reverse=True
    )
    cfg = PipelineConfig(
        k=11, m=5, parity=False, max_read_len=64, batch_reads=4096,
        wide_state_ids=wide,
    )
    single, _ = FastAssembler(cfg).unitigs(reads)
    sharded, _ = FastAssembler(cfg).unitigs(reads, mesh=mesh8)
    assert sorted(single) == sorted(sharded)


def test_parity_pipeline_via_sharded_count(mesh8, reference_file):
    """Sharded counting feeds the same parity replay and still matches the
    golden unitigs on input.txt."""
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    b = _batch(reads, 32, 24)
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        k=6,
        m=3,
        parity=True,
        cutoff=-1,  # keep everything: replay does its own pruning
        mesh=mesh8,
    )
    assert int(np.sum(np.asarray(sc.overflow))) == 0
    got = shard_count.sharded_to_host_dict(sc, 6, 3)
    # pre-prune dict must match the single-device pre-prune table
    from genome_assembly_tpu.parity import model

    want_all = model.count_table(model.scan_reads(reads, 6, 3), -1)
    assert got == want_all


def test_partitioned_dbg_matches_single_device(mesh8):
    """Fully-partitioned links + pointer jumping (no replicated tables,
    routed lookups/gathers) == single-device results, zero overflow."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    k = 11
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=900))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want_links = dbg.build_unitig_links(hi, lo, valid, k=k)
    got_links, ovf = part_dbg.partitioned_unitig_links(hi, lo, valid, k=k, mesh=mesh8)
    assert int(np.sum(np.asarray(ovf))) == 0
    assert np.array_equal(np.asarray(got_links), np.asarray(want_links))

    want_g = dbg.pointer_jump(want_links)
    got_g, ovf2 = part_dbg.partitioned_pointer_jump(want_links, mesh=mesh8)
    assert int(np.sum(np.asarray(ovf2))) == 0
    assert np.array_equal(np.asarray(got_g.head), np.asarray(want_g.head))
    assert np.array_equal(np.asarray(got_g.rank), np.asarray(want_g.rank))
    assert np.array_equal(np.asarray(got_g.is_cycle), np.asarray(want_g.is_cycle))


@pytest.mark.parametrize("k", [5, 11, 17, 31])
def test_partitioned_links_join_matches_single_device(mesh8, k):
    """Routed sort-join links (the distributed default) == the single-chip
    sort-join == the binary-search builder, zero overflow, across key
    widths spanning both two-lane layouts."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want = np.asarray(dbg.build_unitig_links_join(hi, lo, valid, k=k))
    got, ovf = part_dbg.partitioned_unitig_links_join(
        hi, lo, valid, k=k, mesh=mesh8
    )
    assert int(np.sum(np.asarray(ovf))) == 0
    assert np.array_equal(np.asarray(got), want)
    # and against the independent binary-search formulation
    assert np.array_equal(
        want, np.asarray(dbg.build_unitig_links(hi, lo, valid, k=k))
    )


@pytest.mark.parametrize("k", [5, 31])
def test_wide_links_join_matches_int32(mesh8, k):
    """Wide (owner, local) routed sort-join == the int32 global-id join.

    The wide form is config 5's extension representation (6e9 states
    exceed int32, SCALE.md section 1); below 2**31 the two must agree
    exactly under global_id = owner * (2 * rows) + local."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    rng = np.random.default_rng(100 + k)
    genome = "".join(rng.choice(list("ACGT"), size=700))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want, ovf0 = part_dbg.partitioned_unitig_links_join(
        hi, lo, valid, k=k, mesh=mesh8
    )
    assert int(np.sum(np.asarray(ovf0))) == 0
    no, nl, ovf = part_dbg.partitioned_unitig_links_join_wide(
        hi, lo, valid, k=k, mesh=mesh8
    )
    assert int(np.sum(np.asarray(ovf))) == 0
    rows2 = 2 * pad // 8  # states per shard
    no, nl = np.asarray(no), np.asarray(nl)
    got = np.where(no >= 0, no * rows2 + nl, -1)
    assert np.array_equal(got, np.asarray(want))
    # and the single-chip join agrees too
    assert np.array_equal(
        np.asarray(want), np.asarray(dbg.build_unitig_links_join(hi, lo, valid, k=k))
    )


def test_wide_pointer_jump_matches_single_device(mesh8):
    """Wide-id list ranking == dbg.pointer_jump on a graph with long
    chains, a cycle, self-contained pairs, and isolated states."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    n2 = 512
    rows2 = n2 // 8
    next_state = np.full(n2, -1, dtype=np.int32)
    # one long chain crossing every shard: 0 -> 9 -> 18 -> ... (stride 9)
    chain = np.arange(0, n2, 9)
    for a, b in zip(chain[:-1], chain[1:]):
        next_state[a] = b
    # a 16-cycle living on two shards
    cyc = np.arange(100, 116)
    cyc = cyc[~np.isin(cyc, chain)]
    for a, b in zip(cyc, np.roll(cyc, -1)):
        next_state[a] = b
    # short two-state chains in the tail
    for a in range(480, 500, 2):
        if next_state[a] < 0 and a + 1 not in chain:
            next_state[a] = a + 1

    want = dbg.pointer_jump(jnp.asarray(next_state))
    no = jnp.asarray(np.where(next_state >= 0, next_state // rows2, -1).astype(np.int32))
    nl = jnp.asarray(np.where(next_state >= 0, next_state % rows2, -1).astype(np.int32))
    g, ovf = part_dbg.partitioned_pointer_jump_wide(no, nl, mesh=mesh8)
    assert int(np.sum(np.asarray(ovf))) == 0
    head = np.asarray(g.head_owner) * rows2 + np.asarray(g.head_local)
    assert np.array_equal(head, np.asarray(want.head))
    assert np.array_equal(np.asarray(g.rank_lo), np.asarray(want.rank).astype(np.uint32))
    assert not np.any(np.asarray(g.rank_hi))
    assert np.array_equal(np.asarray(g.is_cycle), np.asarray(want.is_cycle))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_wide_pointer_jump_fuzz(mesh8, seed):
    """Wide ranking == dbg.pointer_jump on random partial permutations
    (in-degree <= 1 by construction; permutation cycles fully inside the
    kept subset become real cycles, the rest break into chains)."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    rng = np.random.default_rng(seed)
    n2 = 512
    rows2 = n2 // 8
    sigma = rng.permutation(n2)
    keep = rng.random(n2) < rng.uniform(0.3, 0.9)
    next_state = np.where(keep, sigma, -1).astype(np.int32)

    want = dbg.pointer_jump(jnp.asarray(next_state))
    no = jnp.asarray(
        np.where(next_state >= 0, next_state // rows2, -1).astype(np.int32)
    )
    nl = jnp.asarray(
        np.where(next_state >= 0, next_state % rows2, -1).astype(np.int32)
    )
    g, ovf = part_dbg.partitioned_pointer_jump_wide(no, nl, mesh=mesh8)
    assert int(np.sum(np.asarray(ovf))) == 0
    head = np.asarray(g.head_owner) * rows2 + np.asarray(g.head_local)
    assert np.array_equal(head, np.asarray(want.head))
    assert np.array_equal(
        np.asarray(g.rank_lo), np.asarray(want.rank).astype(np.uint32)
    )
    assert np.array_equal(np.asarray(g.is_cycle), np.asarray(want.is_cycle))


def test_wide_rank_carry():
    """The 64-bit rank lanes carry across the 2**32 boundary (config 5
    chains can exceed uint32 only past ~4.3 Gbp/strand; the lanes remove
    the cliff entirely)."""
    from genome_assembly_tpu.parallel.part_dbg import _add64

    ahi = jnp.asarray(np.array([0, 0, 7], dtype=np.uint32))
    alo = jnp.asarray(np.array([0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32))
    bhi = jnp.asarray(np.array([0, 0, 0], dtype=np.uint32))
    blo = jnp.asarray(np.array([1, 1, 0xFFFFFFFF], dtype=np.uint32))
    rhi, rlo = _add64(ahi, alo, bhi, blo)
    want = [
        (a << 32 | b) + (c << 32 | d)
        for a, b, c, d in zip([0, 0, 7], [0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF], [0, 0, 0], [1, 1, 0xFFFFFFFF])
    ]
    got = [(int(h) << 32) | int(l) for h, l in zip(np.asarray(rhi), np.asarray(rlo))]
    assert got == want


@pytest.mark.parametrize("parity", [True, False])
def test_ragged_routing_equals_padded(mesh8, parity):
    """sharded_count(routing="ragged") == routing="padded" (on CPU the
    ragged collective runs through its dense emulation with identical
    semantics; on a GPU mesh the same code path uses
    lax.ragged_all_to_all)."""
    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=48, coverage=6, seed=3, with_reverse=not parity
    )
    b = _batch(reads, 64, 8 * ((len(reads) + 7) // 8))
    kw = dict(k=k, m=m, parity=parity, cutoff=cutoff, mesh=mesh8)
    a = shard_count.sharded_count(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), jnp.asarray(b.read_ids), **kw
    )
    r = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        routing="ragged",
        **kw,
    )
    assert int(np.sum(np.asarray(a.overflow))) == 0
    assert int(np.sum(np.asarray(r.overflow))) == 0
    got = shard_count.sharded_to_host_dict(r, k, m)
    want = shard_count.sharded_to_host_dict(a, k, m)
    if parity:
        assert got == want
    else:
        assert {kk: sorted(v) for kk, v in got.items()} == {
            kk: sorted(v) for kk, v in want.items()
        }


def test_ragged_routing_capacity_clamp(mesh8):
    """Receiver budget exhaustion must clamp deterministically and report
    the dropped count, never write out of bounds."""
    reads = ["A" * 48] * 64  # one hot owner
    b = _batch(reads, 64, 64)
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        k=11,
        m=5,
        parity=False,
        cutoff=1,
        mesh=mesh8,
        slack=0.05,
        routing="ragged",
    )
    assert int(np.sum(np.asarray(sc.overflow))) > 0


@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_sharded_count_batches_pipelined_equals_unpipelined(mesh8, routing):
    """The software-pipelined multi-batch stream (exchange batch i-1 inside
    the same program that scans batch i) is bit-identical to the serial
    form -- same ops, different program boundaries."""
    k, m, cutoff = 11, 5, 1
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=9, with_reverse=True
    )
    rows = 24  # 3 batches of 24 rows over 8 shards
    batches = [
        reads_io.pad_batch(b, rows)
        for b in reads_io.batch_reads(reads, 64, rows)
    ]
    assert len(batches) >= 3
    results = {}
    for pipelined in (False, True):
        sc = shard_count.sharded_count_batches(
            batches, k=k, m=m, parity=False, cutoff=cutoff, mesh=mesh8,
            routing=routing, pipelined=pipelined,
        )
        assert int(np.sum(np.asarray(sc.overflow))) == 0
        results[pipelined] = sc
    for lane in type(results[True])._fields:
        a = np.asarray(getattr(results[True], lane))
        b = np.asarray(getattr(results[False], lane))
        assert np.array_equal(a, b), lane


def test_pipelined_exchange_is_scan_independent(mesh8):
    """Overlap is structural, not hoped-for: inside the fused
    exchange+bucketize program, the all_to_all's operands must not depend
    on the current batch's inputs -- XLA is then free to run the
    collective asynchronously under the scan.  Checked on the jaxpr's
    dependence closure (observable on any backend)."""
    k, m = 11, 5
    n_shards = 8
    rows, max_len = 24, 64
    n_local = (rows // n_shards) * (max_len - k + 1)
    cap = shard_count._routing_cap(n_local, n_shards, 4.0, "padded")
    codes = jnp.zeros((rows, max_len), jnp.uint8)
    lengths = jnp.full((rows,), max_len, jnp.int32)
    rids = jnp.zeros((rows,), jnp.uint32)
    offsets = jnp.zeros((n_shards, 1), jnp.uint32)
    staged = shard_count._bucketize_batch(
        codes, lengths, rids, offsets,
        k=k, m=m, parity=False, mesh=mesh8, slack=4.0, routing="padded",
    )
    jaxpr = jax.make_jaxpr(
        lambda s, c, le, r, o: shard_count._exchange_and_bucketize_batch(
            s, c, le, r, o, k=k, m=m, parity=False, mesh=mesh8, slack=4.0,
            routing="padded",
        )
    )(staged, codes, lengths, rids, offsets)

    import jax.extend.core as jex_core

    # taint-propagate from the BATCH inputs (positions 6..9: codes,
    # lengths, rids, offsets -- staged occupies the first 6 vars) through
    # every eqn, descending into inner jaxprs via their invar mapping
    def check(jaxpr, tainted):
        hits = []

        def var_tainted(v):
            return not isinstance(v, jex_core.Literal) and v in tainted

        for eqn in jaxpr.eqns:
            any_taint = any(var_tainted(v) for v in eqn.invars)
            inner = [
                v for key, v in eqn.params.items()
                if key in ("jaxpr", "call_jaxpr")
            ]
            if inner and any(
                isinstance(x, (jex_core.Jaxpr, jex_core.ClosedJaxpr))
                for x in inner
            ):
                for sub in inner:
                    sub_j = sub.jaxpr if hasattr(sub, "jaxpr") else sub
                    sub_taint = {
                        iv
                        for iv, ov in zip(sub_j.invars, eqn.invars)
                        if var_tainted(ov)
                    }
                    sub_hits, sub_out_taint = check(sub_j, sub_taint)
                    hits.extend(sub_hits)
                    for ov, sub_ov in zip(eqn.outvars, sub_j.outvars):
                        if (not isinstance(sub_ov, jex_core.Literal)
                                and sub_ov in sub_out_taint):
                            tainted.add(ov)
                    continue
            if "all_to_all" in str(eqn.primitive) and any_taint:
                hits.append(eqn)
            if any_taint:
                tainted.update(eqn.outvars)
        return hits, tainted

    flat_in = jaxpr.jaxpr.invars
    assert len(flat_in) == 10, len(flat_in)  # 6 staged lanes + 4 batch args
    tainted = set(flat_in[6:])
    hits, _ = check(jaxpr.jaxpr, tainted)
    assert hits == [], "all_to_all depends on the current batch's scan"


def test_sharded_count_batches_checkpoint_resume(tmp_path, mesh8):
    """Sharded checkpoint (utils/checkpoint.save_count_shards): a partial
    run's per-shard files + manifest resume into (a) the same mesh without
    re-routing finished batches and (b) a DIFFERENT shard count, where
    records re-route host-side by the ownership hash.  Final tables equal
    the uncheckpointed runs exactly."""
    k, m, cutoff = 11, 5, 1
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=33, with_reverse=True
    )
    rows = 24
    batches = [
        reads_io.pad_batch(b, rows)
        for b in reads_io.batch_reads(reads, 64, rows)
    ]
    assert len(batches) >= 4
    kw = dict(k=k, m=m, parity=False, cutoff=cutoff, mesh=mesh8)
    want = shard_count.sharded_count_batches(batches, **kw)
    want_dict = shard_count.sharded_to_host_dict(want, k, m)

    # partial run: only the first 2 batches, checkpointed
    ckpt = str(tmp_path / "ck")
    shard_count.sharded_count_batches(
        batches[:2], checkpoint_dir=ckpt, **kw
    )

    # resume on the same mesh: batches 0-1 must not be re-routed
    calls = {"bucketize": 0, "exchange": 0}
    orig_b, orig_x = (
        shard_count._bucketize_batch, shard_count._exchange_and_bucketize_batch
    )

    def count_b(*a, **k2):
        calls["bucketize"] += 1
        return orig_b(*a, **k2)

    def count_x(*a, **k2):
        calls["exchange"] += 1
        return orig_x(*a, **k2)

    shard_count._bucketize_batch = count_b
    shard_count._exchange_and_bucketize_batch = count_x
    try:
        got = shard_count.sharded_count_batches(
            batches, checkpoint_dir=ckpt, **kw
        )
    finally:
        shard_count._bucketize_batch = orig_b
        shard_count._exchange_and_bucketize_batch = orig_x
    n_new = len(batches) - 2
    assert calls["bucketize"] == 1 and calls["exchange"] == n_new - 1
    assert int(np.sum(np.asarray(got.overflow))) == 0
    assert shard_count.sharded_to_host_dict(got, k, m) == want_dict

    # resume the 2-batch checkpoint onto a 4-shard mesh (different shape)
    mesh4 = mesh_lib.make_mesh(4)
    ckpt2 = str(tmp_path / "ck2")
    shard_count.sharded_count_batches(batches[:2], checkpoint_dir=ckpt2, **kw)
    kw4 = dict(kw, mesh=mesh4)
    got4 = shard_count.sharded_count_batches(
        batches, checkpoint_dir=ckpt2, **kw4
    )
    want4 = shard_count.sharded_count_batches(batches, **kw4)
    assert (
        shard_count.sharded_to_host_dict(got4, k, m)
        == shard_count.sharded_to_host_dict(want4, k, m)
        == want_dict
    )

    # a manifest from different run parameters must refuse, not resume
    with pytest.raises(ValueError, match="different run"):
        shard_count.sharded_count_batches(
            batches, checkpoint_dir=ckpt, k=13, m=m, parity=False,
            cutoff=cutoff, mesh=mesh8,
        )


def test_key_routed_count_equals_single_device(mesh8):
    """route_by="key" (canonical-key ownership, the fast-mode balance fix
    for heavy-tailed minimizer mass at high shard counts) must produce
    exactly the single-device count: same kept keys, counts, and read-id
    multisets.  Also pins the comm model's key-routing matrix to the
    router's real traffic and its balance claim (recv skew ~1)."""
    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=800, read_len=48, coverage=6, seed=9, with_reverse=True
    )
    b = _batch(reads, 64, 8 * ((len(reads) + 7) // 8))
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), jnp.asarray(b.read_ids),
        k=k, m=m, parity=False, cutoff=cutoff, mesh=mesh8, route_by="key",
    )
    assert int(np.sum(np.asarray(sc.overflow))) == 0
    got = shard_count.sharded_to_host_dict(sc, k, m)

    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import minimizer as minimizer_ops
    from genome_assembly_tpu.parity import table as table_ops

    recs = minimizer_ops.fast_scan(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), k=k, m=m
    )
    counted = count_ops.count_and_prune(
        recs, jnp.asarray(b.read_ids), cutoff=cutoff
    )
    host = table_ops.extract_groups(counted, pruned=True)
    want = table_ops.decode_table(host, k, m)
    assert {kk: sorted(v) for kk, v in got.items()} == {
        kk: sorted(v) for kk, v in want.items()
    }

    # the model's matrix is the router's real traffic: row sums must equal
    # each source shard's valid record count, and key routing must balance
    # received records where minimizer routing skews
    from genome_assembly_tpu.parallel import comm_model

    mat = comm_model.count_exchange_matrix(
        b.codes, b.lengths, k=k, m=m, n_shards=8, route_by="key"
    )
    n_valid = int(np.asarray(recs.valid).sum())
    assert int(mat.sum()) == n_valid
    recv = mat.sum(axis=0)
    # key ownership balances: records cluster per key with multiplicity
    # ~coverage (6 here), so the per-shard deviation is sqrt(coverage)
    # larger than iid -- ~475 +- 65 over 8 shards; 1.35 is ~4 cluster
    # sigma while minimizer routing's heavy tail skews far past it at
    # high shard counts
    assert recv.max() / recv.mean() < 1.35


def test_key_routed_batches_pipelined_equals_mmer_routed(mesh8):
    """sharded_count_batches(route_by="key", pipelined) must yield the
    same kept (key -> count) table as minimizer routing -- ownership is a
    layout decision, never a semantic one."""
    from genome_assembly_tpu.io import reads as reads_io

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=48, coverage=5, seed=11, with_reverse=True
    )
    per = 16
    batches = []
    for i in range(0, min(len(reads), 48), per):
        chunk = reads[i : i + per]
        (bb,) = reads_io.batch_reads(chunk, 64, start_id=i)
        batches.append(reads_io.pad_batch(bb, per))
    kw = dict(k=11, m=5, parity=False, cutoff=1, mesh=mesh8)

    def table(sc):
        keep = np.asarray(sc.keep)
        out = {}
        for s in range(keep.shape[0]):
            for g in np.flatnonzero(keep[s]):
                kk = (int(np.asarray(sc.kmer_hi)[s, g]),
                      int(np.asarray(sc.kmer_lo)[s, g]))
                out[kk] = int(np.asarray(sc.count)[s, g])
        return out

    a = shard_count.sharded_count_batches(batches, route_by="key", **kw)
    assert int(np.sum(np.asarray(a.overflow))) == 0
    b2 = shard_count.sharded_count_batches(batches, route_by="mmer", **kw)
    assert table(a) == table(b2)


def test_key_routing_rejects_parity(mesh8):
    """Parity mode requires signature-grouped tables; route_by="key" must
    be refused loudly, not silently mis-group."""
    b = _batch(["ACGTACGTACGTACGT"] * 8, 32, 8)
    with pytest.raises(ValueError, match="parity"):
        shard_count.sharded_count(
            jnp.asarray(b.codes), jnp.asarray(b.lengths),
            jnp.asarray(b.read_ids),
            k=11, m=5, parity=True, cutoff=1, mesh=mesh8, route_by="key",
        )


def test_key_routed_checkpoint_resume_across_mesh_shapes(tmp_path, mesh8):
    """A key-routed partial checkpoint must resume onto a DIFFERENT mesh
    shape by re-routing with the KEY ownership hash (the manifest records
    route_by), and a route_by mismatch must refuse, not silently
    mis-group."""
    k, m, cutoff = 11, 5, 1
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=700, read_len=48, coverage=6, seed=21, with_reverse=True
    )
    rows = 24
    batches = [
        reads_io.pad_batch(b, rows)
        for b in reads_io.batch_reads(reads, 64, rows)
    ]
    assert len(batches) >= 3
    kw = dict(k=k, m=m, parity=False, cutoff=cutoff, route_by="key")
    want = shard_count.sharded_count_batches(batches, mesh=mesh8, **kw)
    want_dict = shard_count.sharded_to_host_dict(want, k, m)

    ckpt = str(tmp_path / "ck_key")
    shard_count.sharded_count_batches(
        batches[:2], checkpoint_dir=ckpt, mesh=mesh8, **kw
    )
    mesh4 = mesh_lib.make_mesh(4)
    got4 = shard_count.sharded_count_batches(
        batches, checkpoint_dir=ckpt, mesh=mesh4, **kw
    )
    assert int(np.sum(np.asarray(got4.overflow))) == 0
    assert shard_count.sharded_to_host_dict(got4, k, m) == want_dict

    with pytest.raises(ValueError, match="different run"):
        shard_count.sharded_count_batches(
            batches, checkpoint_dir=ckpt, mesh=mesh8,
            k=k, m=m, parity=False, cutoff=cutoff, route_by="mmer",
        )


@pytest.mark.parametrize("mesh3", [False, True])
def test_two_level_links_join_equals_flat(mesh8, mesh3):
    """Routed sort-join links over a (slices, *ici) mesh == the flat
    partitioned join bit for bit (same owner hash, same pair test; the
    records just cross DCN once in aggregated messages), on both a
    (2, 4) two-axis and a (2, 2, 2) three-axis mesh."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg, two_level

    k = 11
    rng = np.random.default_rng(31)
    genome = "".join(rng.choice(list("ACGT"), size=800))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want, ovf0 = part_dbg.partitioned_unitig_links_join(
        hi, lo, valid, k=k, mesh=mesh8
    )
    assert int(np.sum(np.asarray(ovf0))) == 0
    mesh = (
        two_level.two_level_mesh3(2, 2, 2) if mesh3
        else two_level.two_level_mesh(2)
    )
    got, ovf = two_level.partitioned_unitig_links_join_two_level(
        hi, lo, valid, k=k, mesh=mesh
    )
    assert int(np.sum(np.asarray(ovf))) == 0
    assert np.array_equal(np.asarray(got), np.asarray(want))
    # and the single-chip join agrees
    assert np.array_equal(
        np.asarray(want),
        np.asarray(dbg.build_unitig_links_join(hi, lo, valid, k=k)),
    )


def test_two_level_wide_links_join_equals_flat_wide(mesh8):
    """Wide (owner, local) links over the two-level router == the flat
    wide join -- config 5's two structural requirements (>2**31 states,
    multi-slice DCN pod) composed.  The home shard rides as an explicit
    lane (the flat wide join's block-row recovery dies after two hops)."""
    from genome_assembly_tpu.parallel import part_dbg, two_level

    k = 17
    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), size=900))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    wo, wl, ovf0 = part_dbg.partitioned_unitig_links_join_wide(
        hi, lo, valid, k=k, mesh=mesh8
    )
    assert int(np.sum(np.asarray(ovf0))) == 0
    for mesh in (two_level.two_level_mesh(2), two_level.two_level_mesh3(2, 2, 2)):
        go, gl, ovf = two_level.partitioned_unitig_links_join_two_level_wide(
            hi, lo, valid, k=k, mesh=mesh
        )
        assert int(np.sum(np.asarray(ovf))) == 0
        assert np.array_equal(np.asarray(go), np.asarray(wo))
        assert np.array_equal(np.asarray(gl), np.asarray(wl))


def test_two_level_links_overflow_detection():
    """Tiny routing capacity must trip the two-level join's overflow
    counters, never silently drop records."""
    from genome_assembly_tpu.parallel import two_level

    k = 11
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=700))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    _, ovf = two_level.partitioned_unitig_links_join_two_level(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k,
        mesh=two_level.two_level_mesh(2), slack=0.02,
    )
    assert int(np.sum(np.asarray(ovf))) > 0


@pytest.mark.parametrize("wide", [False, True])
def test_distributed_coverage_equals_single_device(mesh8, wide):
    """unitigs_with_coverage(mesh=...) == the in-core coverage channel
    exactly (strings, occurrence sums, and k-mer counts), for both id
    widths -- the distributed counts ride the same 3-lane device sort."""
    from genome_assembly_tpu.models.pipeline import FastAssembler

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=48, coverage=9, seed=17, with_reverse=True
    )
    cfg = PipelineConfig(
        k=11, m=5, parity=False, max_read_len=64, wide_state_ids=wide
    )
    su, so, sn, _ = FastAssembler(
        PipelineConfig(k=11, m=5, parity=False, max_read_len=64)
    ).unitigs_with_coverage(reads)
    du, do, dn, _ = FastAssembler(cfg).unitigs_with_coverage(reads, mesh=mesh8)
    want = sorted(zip(su, so.tolist(), sn.tolist()))
    got = sorted(zip(du, do.tolist(), dn.tolist()))
    assert got == want


def test_distributed_read_ids_equal_single_device(mesh8):
    """unitigs_with_read_ids(mesh=...) == the in-core provenance channel:
    same unitigs, same sorted-distinct supporting read ids per unitig."""
    from genome_assembly_tpu.models.pipeline import FastAssembler

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=500, read_len=40, coverage=8, seed=33, with_reverse=True
    )
    cfg = PipelineConfig(k=11, m=5, parity=False, max_read_len=64)
    su, sids, _ = FastAssembler(cfg).unitigs_with_read_ids(reads)
    du, dids, _ = FastAssembler(cfg).unitigs_with_read_ids(reads, mesh=mesh8)
    want = sorted((u, tuple(i.tolist())) for u, i in zip(su, sids))
    got = sorted((u, tuple(i.tolist())) for u, i in zip(du, dids))
    assert got == want


def test_partitioned_engines_on_one_device_mesh():
    """A singleton shards axis bypasses all_to_all in _xchg (the identity
    by tiled-collective semantics); links join + jump, int32 AND wide,
    must still equal the single-device builders exactly.  This is the
    run_scale --ext-mode part|wide configuration (the one-device memory
    profile)."""
    from genome_assembly_tpu.ops import dbg
    from genome_assembly_tpu.parallel import part_dbg

    mesh1 = mesh_lib.make_mesh(1)
    k = 11
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=700))
    keys = sorted(
        {
            min(
                encode.pack_str(genome[i : i + k]),
                encode.pack_str(
                    genome[i : i + k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
                ),
            )
            for i in range(len(genome) - k + 1)
        }
    )
    pad = 1024
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)

    want = np.asarray(dbg.build_unitig_links_join(hi, lo, valid, k=k))
    got, ovf = part_dbg.partitioned_unitig_links_join(
        hi, lo, valid, k=k, mesh=mesh1
    )
    assert int(np.sum(np.asarray(ovf))) == 0
    assert np.array_equal(np.asarray(got), want)

    no, nl, wovf = part_dbg.partitioned_unitig_links_join_wide(
        hi, lo, valid, k=k, mesh=mesh1
    )
    assert int(np.sum(np.asarray(wovf))) == 0
    flat = np.where(
        np.asarray(no) >= 0,
        np.asarray(no).astype(np.int64) * (2 * pad) + np.asarray(nl),
        -1,
    )
    assert np.array_equal(flat, want.astype(np.int64))

    want_g = dbg.pointer_jump(jnp.asarray(want))
    got_g, jovf = part_dbg.partitioned_pointer_jump(
        jnp.asarray(want), mesh=mesh1
    )
    assert int(np.sum(np.asarray(jovf))) == 0
    assert np.array_equal(np.asarray(got_g.head), np.asarray(want_g.head))
    assert np.array_equal(np.asarray(got_g.rank), np.asarray(want_g.rank))
    assert np.array_equal(np.asarray(got_g.is_cycle), np.asarray(want_g.is_cycle))

    wg, wjovf = part_dbg.partitioned_pointer_jump_wide(no, nl, mesh=mesh1)
    assert int(np.sum(np.asarray(wjovf))) == 0
    head = np.asarray(wg.head_owner).astype(np.int64) * (2 * pad) + np.asarray(
        wg.head_local
    )
    assert np.array_equal(head, np.asarray(want_g.head).astype(np.int64))
    assert np.array_equal(
        np.asarray(wg.rank_lo), np.asarray(want_g.rank).astype(np.uint32)
    )
    assert not np.any(np.asarray(wg.rank_hi))
    assert np.array_equal(np.asarray(wg.is_cycle), np.asarray(want_g.is_cycle))


def test_pack_by_owner_matches_numpy_oracle():
    """The gather-form capacity pack (round-5 rewrite) must place records
    exactly like the original scatter form: block[j][c] = the c-th record
    (in stable sorted order) whose owner is j, fills elsewhere, and the
    overflow counter = records past cap in any run."""
    from genome_assembly_tpu.parallel.part_dbg import _pack_by_owner

    rng = np.random.default_rng(7)
    q, n_shards, cap = 4096, 8, 40  # cap tight enough to force overflow
    owner = rng.integers(0, n_shards, size=q).astype(np.int32)
    active = rng.random(q) < 0.8
    pay_a = rng.integers(0, 2**31, size=q).astype(np.uint32)
    pay_b = rng.integers(0, 2**31, size=q).astype(np.int32)

    blocks, (o, s, ok, idx_s), ovf = jax.jit(
        _pack_by_owner, static_argnums=(4, 5)
    )(
        jnp.asarray(owner), jnp.asarray(active),
        (jnp.asarray(pay_a), jnp.asarray(pay_b)),
        (np.uint32(0xFFFFFFFF), np.int32(-1)),
        n_shards, cap,
    )

    exp_a = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    exp_b = np.full((n_shards, cap), -1, np.int32)
    exp_ovf = 0
    for j in range(n_shards):
        rows = np.flatnonzero((owner == j) & active)  # original order ==
        # stable sort order within one owner
        exp_ovf += max(0, rows.size - cap)
        take = rows[:cap]
        exp_a[j, : take.size] = pay_a[take]
        exp_b[j, : take.size] = pay_b[take]
    assert exp_ovf > 0, "fixture must exercise the overflow path"
    np.testing.assert_array_equal(np.asarray(blocks[0]), exp_a)
    np.testing.assert_array_equal(np.asarray(blocks[1]), exp_b)
    assert int(ovf) == exp_ovf
    # bookkeeping addresses answers coming back at [o, s]: placed rows
    # (ok) must point at the block slot holding their own payload
    o_np, s_np, ok_np, idx_np = (np.asarray(x) for x in (o, s, ok, idx_s))
    placed = np.flatnonzero(ok_np)
    np.testing.assert_array_equal(
        np.asarray(blocks[0])[o_np[placed], s_np[placed]],
        pay_a[idx_np[placed]],
    )


def test_safe_scan_matches_monolithic_across_chunk_boundaries():
    """The routed gathers' inclusive scans are plain lax.associative_scan
    (the chunked _safe_scan, a compile workaround, is gone): add and max
    scans equal numpy's at sizes around the former 1000-element chunk
    boundary, forward and reversed."""
    from jax import lax

    rng = np.random.default_rng(3)
    for n in (999, 1000, 1001, 4096, 10007):
        x = rng.integers(-50, 50, size=n).astype(np.int32)
        xj = jnp.asarray(x)
        np.testing.assert_array_equal(
            np.asarray(lax.associative_scan(jnp.add, xj)), np.cumsum(x)
        )
        np.testing.assert_array_equal(
            np.asarray(lax.associative_scan(jnp.maximum, xj)),
            np.maximum.accumulate(x),
        )
        np.testing.assert_array_equal(
            np.asarray(lax.associative_scan(jnp.minimum, xj, reverse=True)),
            np.minimum.accumulate(x[::-1])[::-1],
        )


def test_partitioned_jump_with_forced_safe_scan_chunking(mesh8):
    """The multi-shard routed gather's cumulative scans under shard_map on
    the 8-device mesh: many short chains (one break every 37 states) pin
    equality with the single-device jump."""
    import genome_assembly_tpu.parallel.part_dbg as pd
    from genome_assembly_tpu.ops import dbg

    n2 = 1 << 12
    ids = np.arange(n2, dtype=np.int32)
    nxt = np.where((ids + 1) % 37 == 0, -1, ids + 1)
    nxt[-1] = -1
    links = jnp.asarray(nxt)
    g_p, ovf = pd.partitioned_pointer_jump(links, mesh=mesh8, slack=4.0)
    assert int(np.sum(np.asarray(ovf))) == 0
    g_1 = dbg.pointer_jump(links)
    np.testing.assert_array_equal(np.asarray(g_p.head), np.asarray(g_1.head))
    np.testing.assert_array_equal(np.asarray(g_p.rank), np.asarray(g_1.rank))
    np.testing.assert_array_equal(
        np.asarray(g_p.is_cycle), np.asarray(g_1.is_cycle)
    )


@pytest.mark.parametrize(
    "platform,routing,native",
    [("gpu", "ragged", True), ("gpu", "padded", False),
     ("cpu", "ragged", False)],
)
def test_ragged_native_choice_keyed_on_mesh_platform(platform, routing, native):
    """The native ragged_all_to_all is taken exactly on a GPU mesh; CPU
    meshes (no XLA:CPU implementation) take the dense emulation."""
    import types

    from genome_assembly_tpu.parallel import ragged

    mesh = types.SimpleNamespace(
        devices=np.array([types.SimpleNamespace(platform=platform)] * 2)
    )
    assert shard_count._is_ragged_native(mesh, routing) is native
    assert ragged.has_native(mesh) is (platform == "gpu")
