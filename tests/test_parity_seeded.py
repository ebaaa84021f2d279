"""Parity on seeded generated reads: the same behaviours as the fixture
tests of test_parity_counts.py / test_parity_unitigs.py, without the
reference tree.

The references are the executable spec (parity/model.py) for the pruned
table and the Python replay (parity/replay.py) for the native engine's
output, compared exactly, in line order.
"""

import pytest

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.models.pipeline import ParityAssembler
from genome_assembly_tpu.parity import model

KM = [(6, 3), (8, 4), (11, 5)]


def _reads(tmp_path, k, m):
    """Reads as the parity loader sees them (fgets quirks included).

    The seed avoids read sets on which the native engine stops at the
    reference's undefined behaviour (binning.c:710's dead branch)."""
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=400, read_len=30, coverage=6, seed=1
    )
    path = tmp_path / "reads.txt"
    datagen.write_reads(reads, str(path))
    return ParityAssembler(_cfg(k, m)).load(str(path))


def _cfg(k, m, **kw):
    return PipelineConfig(k=k, m=m, max_read_len=32, batch_reads=64, **kw)


@pytest.mark.parametrize("k,m", KM)
def test_seeded_postprune_parity(tmp_path, k, m):
    reads = _reads(tmp_path, k, m)
    asm = ParityAssembler(_cfg(k, m))
    recs = model.scan_reads(reads, k, m)
    want = model.count_table(recs, 1)
    assert asm.pruned_table_dict(reads) == want
    _, stats = asm.pruned_table(reads)
    assert stats.entries_pre_prune == len(model.count_table(recs, -1))
    assert stats.entries_post_prune == len(want)


@pytest.mark.parametrize("k,m", KM)
def test_seeded_multi_batch_merge_equals_single_batch(tmp_path, k, m):
    reads = _reads(tmp_path, k, m)
    multi = ParityAssembler(PipelineConfig(
        k=k, m=m, max_read_len=32, batch_reads=7))
    assert multi.pruned_table_dict(reads) == ParityAssembler(
        _cfg(k, m)).pruned_table_dict(reads)


@pytest.mark.parametrize("k,m", KM)
def test_seeded_unitigs_native_equals_python(tmp_path, k, m):
    reads = _reads(tmp_path, k, m)
    asm = ParityAssembler(_cfg(k, m))
    native, _ = asm.assemble(reads, engine="native")
    python, _ = asm.assemble(reads, engine="python")
    assert native == python
    assert len(native) > 0


@pytest.mark.parametrize("k,m", KM)
def test_seeded_outofcore_equals_incore(tmp_path, k, m):
    """outofcore_bytes below the record size forces the hash-partitioned
    multi-pass count; the replay output is unchanged, line for line."""
    reads = _reads(tmp_path, k, m)
    incore = ParityAssembler(_cfg(k, m))
    ooc = ParityAssembler(_cfg(k, m, outofcore_bytes=20_000))
    assert not incore._needs_outofcore(reads)
    assert ooc._needs_outofcore(reads)
    want, _ = incore.assemble(reads, engine="python")
    got, _ = ooc.assemble(reads, engine="native")
    assert got == want


@pytest.mark.parametrize("k,m", KM)
def test_seeded_verbose_native_equals_python(tmp_path, k, m):
    """print_kmer_read_ids format, native against Python, byte for byte."""
    reads = _reads(tmp_path, k, m)
    asm = ParityAssembler(_cfg(k, m))
    native, _ = asm.assemble(reads, engine="native", verbose=True)
    python, _ = asm.assemble(reads, engine="python", verbose=True)
    assert native == python
    assert native


def test_seeded_expanded_table_cross_engine(tmp_path):
    k, m = KM[0]
    reads = _reads(tmp_path, k, m)
    asm = ParityAssembler(_cfg(k, m))
    native = asm.expanded_table(reads, engine="native")
    assert native == asm.expanded_table(reads, engine="python")
    assert native
    for (mmer, key), per_bp in native.items():
        assert len(mmer) == m
        assert len(per_bp) == len(key)
        for ids in per_bp:
            assert ids == sorted(ids, reverse=True)
