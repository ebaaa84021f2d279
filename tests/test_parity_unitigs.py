"""End-to-end bit-parity: unitig output vs the reference binary.

These assert EXACT line order (not just multiset equality): the replay
simulates the reference's hash-table layout dynamics, so even the
(mmer-bin, bucket, chain) print order matches (binning.c:827-843).
"""

import gzip
import pathlib

import pytest

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.models.pipeline import ParityAssembler

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _golden_lines(name):
    path = GOLDEN / name
    if path.suffix == ".gz":
        return gzip.decompress(path.read_bytes()).decode().splitlines()
    return path.read_text().splitlines()


@pytest.mark.parametrize("engine", ["python", "native"])
def test_input_k6m3_unitigs_exact(engine, reference_file):
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    lines, _ = asm.assemble(reads, engine=engine)
    assert lines == _golden_lines("input_k6m3_unitigs.txt")
    assert len(lines) == 61


@pytest.mark.parametrize("engine", ["python", "native"])
def test_input_k6m3_outofcore_exact(engine, reference_file):
    """Out-of-core parity counting (hash-partitioned multi-pass,
    ops/outofcore.partitioned_count_parity) is bit-exact: same golden
    unitigs in the same order as the in-core path.
    outofcore_bytes is forced below the record size so the partitioned
    path engages (6 partitions here -> 2 re-scan passes)."""
    cfg = PipelineConfig(
        k=6, m=3, max_read_len=32, batch_reads=64, outofcore_bytes=20_000
    )
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    assert asm._needs_outofcore(reads)
    lines, stats = asm.assemble(reads, engine=engine)
    assert lines == _golden_lines("input_k6m3_unitigs.txt")
    assert stats.n_windows > 0


def test_outofcore_multibatch_matches_incore():
    """Multi-batch out-of-core parity == in-core, including the pruned
    table artifact, on generated reads spanning several device batches."""
    from genome_assembly_tpu.io import datagen

    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=30, coverage=6, seed=9, with_reverse=False
    )
    base = dict(k=8, m=4, max_read_len=32, batch_reads=32)
    incore = ParityAssembler(PipelineConfig(**base))
    ooc = ParityAssembler(
        PipelineConfig(**base, outofcore_bytes=50_000)
    )
    assert not incore._needs_outofcore(reads)
    assert ooc._needs_outofcore(reads)
    want, _ = incore.assemble(reads)
    got, _ = ooc.assemble(reads)
    assert got == want
    assert incore.pruned_table_dict(reads) == ooc.pruned_table_dict(reads)


@pytest.mark.parametrize("engine", ["python", "native"])
def test_input_k6m3_verbose_exact(engine, reference_file):
    """print_kmer_read_ids format -- feeds the reference's plot harness."""
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    text, _ = asm.assemble(reads, engine=engine, verbose=True)
    assert text == (GOLDEN / "input_k6m3_verbose.txt").read_text()


@pytest.mark.slow
def test_reads_k31m4_unitigs_exact(reference_file):
    cfg = PipelineConfig(k=31, m=4, max_read_len=128, batch_reads=16384)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("reads.txt"))
    lines, stats = asm.assemble(reads, engine="native")
    assert lines == _golden_lines("reads_k31m4_unitigs.txt.gz")
    assert len(lines) == 14567


@pytest.mark.slow
def test_reads_k6m3_unitigs_exact(reference_file):
    cfg = PipelineConfig(k=6, m=3, max_read_len=128, batch_reads=16384)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("reads.txt"))
    lines, _ = asm.assemble(reads, engine="native")
    assert lines == _golden_lines("reads_k6m3_unitigs.txt.gz")
    assert len(lines) == 2469


@pytest.mark.oracle
def test_synthetic_reads_match_live_oracle():
    """Fresh synthetic read set vs a live oracle run (not a stored golden):
    guards against overfitting to the shipped fixtures."""
    import pathlib
    import subprocess
    import sys
    import tempfile

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools import oracle

    from genome_assembly_tpu.io import datagen

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=2000, read_len=50, coverage=8, seed=123
    )
    with tempfile.TemporaryDirectory() as td:
        reads_file = pathlib.Path(td) / "reads.txt"
        datagen.write_reads(reads, str(reads_file))
        binary = oracle.build_oracle(pathlib.Path("/tmp/oracle_build"), k=21, m=4)
        want = oracle.run_oracle(binary, reads_file, "unitigs").splitlines()

    cfg = PipelineConfig(k=21, m=4, max_read_len=64, batch_reads=1024)
    asm = ParityAssembler(cfg)
    # 50-bp lines are consumed whole by fgets(101): no truncation quirk,
    # so the in-memory reads equal what the oracle parses.
    lines, _ = asm.assemble(reads, engine="native")
    assert lines == want


def test_expanded_table_artifact_cross_engine(reference_file):
    """expanded_table: native-engine text parse == python replay's internal
    expanded state, and per-bp structure is K lists of descending ids."""
    from genome_assembly_tpu.config import PipelineConfig
    from genome_assembly_tpu.models.pipeline import ParityAssembler

    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    native = asm.expanded_table(reads, engine="native")
    python = asm.expanded_table(reads, engine="python")
    assert native == python
    assert len(native) > 0
    for (mmer, key), per_bp in native.items():
        assert len(mmer) == 3
        assert len(per_bp) == len(key)
        for ids in per_bp:
            assert ids == sorted(ids, reverse=True)
