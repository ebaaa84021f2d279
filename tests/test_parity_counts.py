"""Golden-parity tests for the counting phases vs the reference C oracle.

The pruned table is order-independent (a multiset keyed by (signature, kmer)
with read-id lists), so parity here is exact dict equality against the
oracle's phase dumps.  Verified oracle milestones (SURVEY.md section 6):
reads.txt K=31/M=4: 102,717 -> 15,298 entries; input.txt K=6/M=3: 97 -> 89.
"""

import gzip
import pathlib

import pytest

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.models.pipeline import ParityAssembler

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _golden_table(name):
    path = GOLDEN / name
    if path.suffix == ".gz":
        text = gzip.decompress(path.read_bytes()).decode()
    else:
        text = path.read_text()
    table = {}
    for line in text.splitlines():
        if not line:
            continue
        mmer, kmer, ids = line.split("\t")
        key = (mmer, kmer)
        assert key not in table
        table[key] = [int(x) for x in ids.split(",")] if ids else []
    return table


def test_input_k6m3_postprune_parity(reference_file):
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    got = asm.pruned_table_dict(reads)
    want = _golden_table("input_k6m3_postprune.txt")
    assert got == want
    assert len(want) == 89


def test_input_k6m3_entry_counts(reference_file):
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("input.txt"))
    _, stats = asm.pruned_table(reads)
    assert stats.entries_pre_prune == 97
    assert stats.entries_post_prune == 89


@pytest.mark.slow
def test_reads_k31m4_postprune_parity(reference_file):
    cfg = PipelineConfig(k=31, m=4, max_read_len=128, batch_reads=16384)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("reads.txt"))
    # fgets quirk: 5000 100-bp lines -> 10000 consumed read ids
    assert len(reads) == 10000
    assert all(len(r) in (0, 99) for r in reads)
    host, stats = asm.pruned_table(reads)
    assert stats.entries_pre_prune == 102717
    assert stats.entries_post_prune == 15298
    from genome_assembly_tpu.parity.table import decode_table

    got = decode_table(host, 31, 4)
    want = _golden_table("reads_k31m4_postprune.txt.gz")
    assert got == want


@pytest.mark.slow
def test_reads_k6m3_postprune_parity(reference_file):
    cfg = PipelineConfig(k=6, m=3, max_read_len=128, batch_reads=16384)
    asm = ParityAssembler(cfg)
    reads = asm.load(reference_file("reads.txt"))
    got = asm.pruned_table_dict(reads)
    want = _golden_table("reads_k6m3_postprune.txt.gz")
    assert got == want


def test_multi_batch_merge_equals_single_batch(reference_file):
    """Batch boundaries must not change the table (merge path)."""
    cfg_small = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=7)
    cfg_big = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    reads = ParityAssembler(cfg_big).load(reference_file("input.txt"))
    got_multi = ParityAssembler(cfg_small).pruned_table_dict(reads)
    got_single = ParityAssembler(cfg_big).pruned_table_dict(reads)
    assert got_multi == got_single
