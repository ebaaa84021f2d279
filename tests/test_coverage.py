"""Fast-mode per-unitig coverage and read-id provenance.

The reference carries per-BP read-id lists through every merge
(binning.c:154-195, 857-888); fast mode's payload-free count used to
discard them.  These tests differential-check the new channels against
first-principles string oracles.
"""

import numpy as np

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.models.pipeline import FastAssembler
from test_dbg import canon, genome_kmers


def _oracle_counts(reads, k):
    counts = {}
    for r in reads:
        for x in genome_kmers(r, k):
            c = canon(x)
            counts[c] = counts.get(c, 0) + 1
    return counts


def test_coverage_matches_string_oracle():
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=1200, read_len=60, coverage=9, seed=17, with_reverse=True
    )
    k, m = 11, 5
    cfg = PipelineConfig(k=k, m=m, parity=False, max_read_len=64, batch_reads=256)
    asm = FastAssembler(cfg)
    unitigs, occ, nk, stats = asm.unitigs_with_coverage(reads)

    plain, _ = FastAssembler(cfg).unitigs(reads)
    assert sorted(unitigs) == sorted(plain)

    counts = _oracle_counts(reads, k)
    assert len(unitigs) == len(occ) == len(nk)
    for u, s, n in zip(unitigs, occ, nk):
        want_n = len(u) - k + 1
        assert n == want_n
        want_sum = sum(counts[canon(x)] for x in genome_kmers(u, k))
        assert s == want_sum
        assert s / n >= 2  # cutoff 1 keeps only count >= 2 k-mers


def test_coverage_multi_batch():
    """Coverage counts must aggregate across device batches."""
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=700, read_len=50, coverage=8, seed=23
    )
    k = 13
    cfg = PipelineConfig(
        k=k, m=5, parity=False, max_read_len=64, batch_reads=64
    )  # forces several batches
    unitigs, occ, nk, _ = FastAssembler(cfg).unitigs_with_coverage(reads)
    counts = _oracle_counts(reads, k)
    for u, s, n in zip(unitigs, occ, nk):
        assert s == sum(counts[canon(x)] for x in genome_kmers(u, k))
        assert n == len(u) - k + 1


def test_read_ids_match_string_oracle():
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=500, read_len=50, coverage=7, seed=9, with_reverse=True
    )
    k = 11
    cfg = PipelineConfig(k=k, m=5, parity=False, max_read_len=64, batch_reads=128)
    asm = FastAssembler(cfg)
    unitigs, per_unitig, stats = asm.unitigs_with_read_ids(reads)

    plain, _ = FastAssembler(cfg).unitigs(reads)
    assert sorted(unitigs) == sorted(plain)

    # oracle: reads supporting a unitig = reads sharing >= 1 canonical kmer
    read_kmers = [
        {canon(x) for x in genome_kmers(r, k)} for r in reads
    ]
    for u, ids in zip(unitigs, per_unitig):
        u_set = {canon(x) for x in genome_kmers(u, k)}
        want = sorted(
            i for i, ks in enumerate(read_kmers) if ks & u_set
        )
        assert list(ids) == want


def test_coverage_cli_tsv(tmp_path, capsys):
    from genome_assembly_tpu.cli import main

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=400, read_len=40, coverage=8, seed=3
    )
    f = tmp_path / "reads.txt"
    f.write_text("\n".join(reads) + "\n")
    rc_ = main(
        [
            "assemble", str(f), "--mode", "fast", "--coverage",
            "--k", "11", "--m", "5", "--max-read-len", "48",
            "--batch-reads", "128", "--cpu",
        ]
    )
    assert rc_ == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out
    counts = _oracle_counts(reads, 11)
    for line in out:
        u, n, cov = line.split("\t")
        n = int(n)
        assert n == len(u) - 11 + 1
        want = sum(counts[canon(x)] for x in genome_kmers(u, 11)) / n
        assert abs(float(cov) - want) < 5e-3
