"""Exact parity on reads containing non-ACGT bytes.

The reference accepts any byte: unknown characters (including lowercase
bases) score as 'A' (getval default, binning.c:107-109) but are stored and
printed VERBATIM when the k-mer is not complemented (binning.c:1023-1028).
The device groups by packed codes, so raw-byte keys are recovered by the
exception path (parity/nonacgt.py): spec-scan dirty reads, re-key their
occurrences, split groups by exact stored string.

Layers tested: regrouped pruned table == executable-spec table; python
replay == native replay (override channel); live reference binary ==
assemble() on an N/lowercase-bearing read set.
"""

import numpy as np
import pytest

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.models.pipeline import ParityAssembler
from genome_assembly_tpu.parity import model, nonacgt


def _dirty_reads(seed=7, n=40, length=30):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]
    # inject junk BEFORE duplicating so dirty k-mers also survive pruning:
    # an N, a lowercase base (reference getval treats it as unknown too),
    # a fully lowercase read, and a stray letter
    reads[0] = reads[0][:5] + "N" + reads[0][6:]
    reads[1] = reads[1][:3] + "n" + reads[1][4:]
    reads[2] = reads[2].lower()
    reads[3] = reads[3][:10] + "X" + reads[3][11:]
    # N adjacent to where a signature window will sit
    reads[4] = "N" + reads[4][1:]
    return reads + reads  # every window occurs twice -> survives cutoff 1


def _cfg(batch=64):
    return PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=batch)


def test_regrouped_table_matches_spec():
    """pruned_table_groups (device count + exception regroup) equals the
    executable spec's table exactly -- keys with raw bytes, counts, and
    descending id order all included."""
    reads = _dirty_reads()
    asm = ParityAssembler(_cfg())
    groups = asm.pruned_table_groups(reads)
    got = {(s, km): list(reversed(ids)) for s, km, ids in groups}
    want = model.count_table(model.scan_reads(reads, 6, 3), 1)
    assert got == want
    # the fixture really exercises raw keys
    assert any(
        not frozenset("ACGT").issuperset(s + km) for s, km in got
    ), "no raw-byte keys in the pruned table; fixture too clean"


def test_regrouped_table_matches_spec_multibatch():
    """Same equality across the multi-batch merge path (streams must stay
    global across batches)."""
    reads = _dirty_reads()
    asm = ParityAssembler(_cfg(batch=16))
    groups = asm.pruned_table_groups(reads)
    got = {(s, km): list(reversed(ids)) for s, km, ids in groups}
    assert got == model.count_table(model.scan_reads(reads, 6, 3), 1)


def test_nonacgt_cross_engine():
    """python replay == native replay (raw-key override channel), for both
    print formats."""
    reads = _dirty_reads()
    asm = ParityAssembler(_cfg())
    py_lines, _ = asm.assemble(reads, engine="python")
    nat_lines, _ = asm.assemble(reads, engine="native")
    assert py_lines == nat_lines
    assert any(not frozenset("ACGT").issuperset(l) for l in py_lines)
    py_v, _ = asm.assemble(reads, engine="python", verbose=True)
    nat_v, _ = asm.assemble(reads, engine="native", verbose=True)
    assert py_v == nat_v


def test_clean_reads_unaffected():
    """A pure-ACGT read set takes the unchanged fast path and the
    exception path agrees with it bit for bit."""
    reads = [r for r in _dirty_reads() if frozenset("ACGT").issuperset(r)]
    asm = ParityAssembler(_cfg())
    clean_lines, _ = asm.assemble(reads, engine="native")
    groups, _ = asm._nonacgt_groups(reads)
    from genome_assembly_tpu.native import replay_native

    forced = replay_native.assemble_groups(groups, 6, 3, 1)
    assert forced == clean_lines


@pytest.mark.oracle
def test_nonacgt_live_oracle():
    """assemble() on an N/lowercase-bearing read set == the reference
    binary's output, line for line including raw bytes."""
    import pathlib
    import sys
    import tempfile

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools import oracle

    reads = _dirty_reads()
    with tempfile.TemporaryDirectory() as td:
        reads_file = pathlib.Path(td) / "reads.txt"
        reads_file.write_text("".join(r + "\n" for r in reads))
        binary = oracle.build_oracle(
            pathlib.Path("/tmp/oracle_build"), k=6, m=3
        )
        want = oracle.run_oracle(binary, reads_file, "unitigs").splitlines()

    asm = ParityAssembler(_cfg())
    # 30-bp lines are consumed whole by fgets(101): no truncation quirk
    lines, _ = asm.assemble(reads, engine="native")
    assert lines == want
    lines_py, _ = asm.assemble(reads, engine="python")
    assert lines_py == want


def test_dirty_rejected_on_unsupported_paths():
    reads = _dirty_reads()
    asm = ParityAssembler(_cfg())
    with pytest.raises(NotImplementedError):
        asm.pruned_table(reads)


def test_dirty_detection():
    assert not nonacgt.has_non_acgt(["ACGT", ""])
    assert nonacgt.has_non_acgt(["ACGN"])
    assert nonacgt.has_non_acgt(["acgt"])  # lowercase is unknown to getval


def _ooc_cfg(batch=64, budget=30_000):
    # 80 dirty reads / batch 64 -> 2 batches, 3456 slots * 20 B > budget:
    # forces the 5-lane partitioned out-of-core parity count
    return PipelineConfig(
        k=6, m=3, max_read_len=32, batch_reads=batch,
        outofcore_bytes=budget,
    )


def test_nonacgt_ooc_matches_incore():
    """Dirty reads through the out-of-core 5-lane count == the in-core exception path, both
    engines, both print formats."""
    reads = _dirty_reads()
    asm_ooc = ParityAssembler(_ooc_cfg())
    assert asm_ooc._needs_outofcore(reads), "fixture no longer forces ooc"
    asm_inc = ParityAssembler(_cfg())
    for engine in ("python", "native"):
        ooc_lines, _ = asm_ooc.assemble(reads, engine=engine)
        inc_lines, _ = asm_inc.assemble(reads, engine=engine)
        assert ooc_lines == inc_lines
    ooc_v, _ = asm_ooc.assemble(reads, engine="native", verbose=True)
    inc_v, _ = asm_inc.assemble(reads, engine="native", verbose=True)
    assert ooc_v == inc_v
    assert any(not frozenset("ACGT").issuperset(l) for l in ooc_v)


def test_parity_ooc_streams_roundtrip(tmp_path):
    """partitioned_count_parity(with_streams=True): streams align with
    read_ids, and a resume from partitions saved WITHOUT the stream lane
    recounts them instead of failing."""
    import jax.numpy as jnp

    from genome_assembly_tpu.ops import outofcore

    rng = np.random.default_rng(3)
    n, batches = 96, 2
    mm = [rng.integers(0, 5, n).astype(np.uint32) for _ in range(batches)]
    hi = [rng.integers(0, 3, n).astype(np.uint32) for _ in range(batches)]
    lo = [rng.integers(0, 7, n).astype(np.uint32) for _ in range(batches)]
    rid = [rng.integers(0, 50, n).astype(np.uint32) for _ in range(batches)]
    strm = [
        (np.arange(n, dtype=np.uint32) + b * n) for b in range(batches)
    ]

    def recs(b):
        return tuple(
            jnp.asarray(a[b]) for a in (mm, hi, lo, rid, strm)
        )

    ck = str(tmp_path / "ck")
    # pass 1: no streams, checkpointed
    host0, nw0, ovf0 = outofcore.partitioned_count_parity(
        recs, batches, partitions=4, cutoff=-1, checkpoint_dir=ck
    )
    assert ovf0 == 0
    # pass 2: with streams, SAME dir -- stream-less partitions recount
    host1, streams, nw1, ovf1 = outofcore.partitioned_count_parity(
        recs, batches, partitions=4, cutoff=-1, checkpoint_dir=ck,
        with_streams=True,
    )
    assert nw1 == nw0 and ovf1 == 0
    np.testing.assert_array_equal(host1.mmer, host0.mmer)
    np.testing.assert_array_equal(host1.first_seen, host0.first_seen)
    stream_of = {}
    for b in range(batches):
        for j in range(n):
            stream_of[(int(mm[b][j]), int(hi[b][j]), int(lo[b][j]),
                       int(strm[b][j]))] = int(rid[b][j])
    for g in range(len(host1.mmer)):
        assert len(streams[g]) == len(host1.read_ids[g])
        assert list(streams[g]) == sorted(streams[g])
        assert int(streams[g][0]) == int(host1.first_seen[g])
        for s, r in zip(streams[g], host1.read_ids[g]):
            key = (int(host1.mmer[g]), int(host1.kmer_hi[g]),
                   int(host1.kmer_lo[g]), int(s))
            assert stream_of[key] == int(r)
    # pass 3: resume again purely from the upgraded checkpoints
    host2, streams2, _, _ = outofcore.partitioned_count_parity(
        recs, batches, partitions=4, cutoff=-1, checkpoint_dir=ck,
        with_streams=True,
    )
    for a, b2 in zip(streams, streams2):
        np.testing.assert_array_equal(a, b2)


@pytest.mark.oracle
def test_nonacgt_truncation_ooc_live_oracle(tmp_path):
    """All three quirk systems composed: non-ACGT
    bytes + fgets truncation (>100-char lines) + the out-of-core 5-lane
    parity count, byte-equal to the live reference binary on a fixture no
    golden has seen."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools import oracle

    rng = np.random.default_rng(11)
    lines = []
    for i in range(30):
        ln = "".join(rng.choice(list("ACGT"), size=150 if i % 3 else 230))
        lines.append(ln)
    # inject the quirk bytes: N, lowercase base, whole-lower chunk, stray
    lines[0] = lines[0][:40] + "N" + lines[0][41:]
    lines[1] = lines[1][:120] + "n" + lines[1][121:]  # in the 2nd chunk
    lines[2] = lines[2][:30].lower() + lines[2][30:]
    lines[3] = lines[3][:101] + "X" + lines[3][102:]  # chunk-boundary area
    lines = lines + lines  # duplicate so dirty k-mers survive cutoff 1
    reads_file = tmp_path / "dirty_long.txt"
    reads_file.write_text("".join(l + "\n" for l in lines))

    binary = oracle.build_oracle(pathlib.Path("/tmp/oracle_build"), k=6, m=3)
    want = oracle.run_oracle(binary, reads_file, "unitigs").splitlines()

    cfg = PipelineConfig(
        k=6, m=3, max_read_len=128, batch_reads=64,
        outofcore_bytes=200_000,
    )
    asm = ParityAssembler(cfg)
    reads = asm.load(str(reads_file))
    # the loader's fgets emulation really split lines (truncation quirk on)
    assert len(reads) > len(lines)
    assert asm._needs_outofcore(reads), "fixture no longer forces ooc"
    got, _ = asm.assemble(reads, engine="native")
    assert got == want
    got_py, _ = asm.assemble(reads, engine="python")
    assert got_py == want


def test_lowercase_run_stale_signature_scoring():
    """Lowercase c/g/t must score 3 ('A') on device exactly as the
    reference getval does (binning.c:91-111).  The lenient fast-mode
    table regressed this: one wrongly-scored base corrupts the stale
    signature of LATER clean windows in the same read, splitting their
    occurrences away from the clean reads' device group and duplicating
    table entries the reference merges.  This fixture (coverage overlap
    + 8-base lowercase runs) is wrong under the lenient table."""
    rng = np.random.default_rng(1)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = []
    for _ in range(60):
        p = int(rng.integers(0, len(genome) - 50))
        reads.append(genome[p : p + 50])
    for j in range(0, 60, 7):
        r = reads[j]
        pos = int(rng.integers(0, 30))
        reads[j] = r[:pos] + r[pos : pos + 8].lower() + r[pos + 8 :]

    cfg = PipelineConfig(k=21, m=4, max_read_len=64, batch_reads=64)
    asm = ParityAssembler(cfg)
    groups = asm.pruned_table_groups(reads)
    got = sorted((s, km, tuple(ids)) for s, km, ids in groups)
    want = model.count_table(model.scan_reads(reads, 21, 4), 1)
    spec = sorted(
        (s, km, tuple(reversed(v))) for (s, km), v in want.items()
    )
    assert got == spec


def test_nonacgt_sharded_matches_single_device():
    """Dirty reads through the distributed parity count (mesh path): the
    sharded record lanes carry global streams, so the exception regroup
    runs on the merged table and the output equals the single-device
    dirty path exactly -- multi-batch, both print formats."""
    import os

    import jax
    from jax.sharding import Mesh

    assert jax.device_count() == 8, "virtual mesh missing"
    mesh = Mesh(np.array(jax.devices()), ("shards",))

    reads = _dirty_reads()  # 80 reads
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=24)
    asm = ParityAssembler(cfg)
    want, _ = asm.assemble(reads)
    got, _ = asm.assemble(reads, mesh=mesh)
    assert got == want
    want_v, _ = asm.assemble(reads, verbose=True)
    got_v, _ = asm.assemble(reads, mesh=mesh, verbose=True)
    assert got_v == want_v
    assert any(not frozenset("ACGT").issuperset(l) for l in got)


def test_pruned_table_dict_dirty():
    """pruned_table_dict is the documented dirty-capable table surface
    (pruned_table's reject message points here): it must equal the
    executable spec's table on a dirty read set instead of raising."""
    reads = _dirty_reads()
    asm = ParityAssembler(_cfg())
    got = asm.pruned_table_dict(reads)
    want = model.count_table(model.scan_reads(reads, 6, 3), 1)
    assert got == want


def test_pruned_table_dict_dirty_ooc():
    """The review caught pruned_table_dict staging dirty past-HBM sets
    in-core; _nonacgt_groups now routes them through the partitioned
    count.  Same spec equality through the forced-ooc config."""
    reads = _dirty_reads()
    asm = ParityAssembler(_ooc_cfg())
    assert asm._needs_outofcore(reads)
    got = asm.pruned_table_dict(reads)
    want = model.count_table(model.scan_reads(reads, 6, 3), 1)
    assert got == want
