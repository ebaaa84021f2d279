"""chip_smoke.py's references on the CPU: the numpy count and the
exactly-once unitig check against FastAssembler, and the order-free graph
digest.  The GPU phases themselves run only through ``python
chip_smoke.py`` on a card."""

import numpy as np
import pytest

import jax.numpy as jnp

import chip_smoke
from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.ops import count as count_ops
from genome_assembly_tpu.ops import dbg, minimizer


@pytest.mark.parametrize(
    "k,m,cutoff", [(31, 7, 1), (21, 7, 1), (15, 5, 0), (21, 7, 2)]
)
def test_fast_assembler_matches_numpy_reference(tmp_path, k, m, cutoff):
    log = chip_smoke.fast_exact(
        tmp_path, genome_len=3000, coverage=12, read_len=60,
        configs=((k, m),), cutoff=cutoff, seed=k + cutoff,
    )
    assert len(log) == 3


def test_exactly_once_catches_planted_duplicate():
    genome, _, _ = datagen.generate_coverage_reads(
        genome_len=500, read_len=40, coverage=1, seed=3
    )
    k = 21
    kept, _ = chip_smoke.kept_reference(
        chip_smoke.sequence_keys([genome], k), 0
    )
    assert len(kept) == len(genome) - k + 1  # no repeats in the genome
    log: list = []
    chip_smoke.check_exactly_once([genome], kept, k, log)
    # the same k-mer again, on the other strand: a duplicate
    rc = genome[:k].translate(str.maketrans("ACGT", "TGCA"))[::-1]
    with pytest.raises(chip_smoke.CheckFailed, match="repeated"):
        chip_smoke.check_exactly_once([genome, rc], kept, k, [])
    # one k-mer short: the kept set is not covered
    with pytest.raises(chip_smoke.CheckFailed, match="kept set"):
        chip_smoke.check_exactly_once([genome[1:]], kept, k, [])


@pytest.mark.parametrize("k", [5, 16, 31])
def test_window_keys_match_fast_scan(k):
    """The numpy canonical keys equal the device scan's (hi, lo) lanes,
    including the strand choice."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(16, 48), dtype=np.uint8)
    recs = minimizer.fast_scan(
        jnp.asarray(codes), jnp.full((16,), 48, jnp.int32), k=k, m=3
    )
    want = (np.asarray(recs.kmer_hi).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(recs.kmer_lo).astype(np.uint64)
    )
    assert np.array_equal(chip_smoke.window_keys(codes, k), want)
    rc = (3 - codes[:, ::-1]).astype(np.uint8)
    assert np.array_equal(chip_smoke.window_keys(rc, k), want[:, ::-1])


def test_graph_digest_ignores_node_order():
    """The same kept set in another node order (as the out-of-core count
    delivers it) gives the same digests; a different graph does not."""
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=2000, read_len=60, coverage=10, seed=4, with_reverse=True
    )
    k = 21
    keys = chip_smoke.sequence_keys(reads, k)
    kept, _ = chip_smoke.kept_reference(keys, 1)

    def digest(order):
        # sentinel-padded to one fixed node count, as the pipeline pads
        pad = np.full(4096 - len(order), 0xFFFFFFFF, np.uint32)
        khi = np.concatenate(
            [(kept[order] >> np.uint64(32)).astype(np.uint32), pad])
        klo = np.concatenate(
            [(kept[order] & np.uint64(0xFFFFFFFF)).astype(np.uint32), pad])
        valid = khi != np.uint32(0xFFFFFFFF)
        links = dbg.build_unitig_links_join(
            jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid), k=k
        )
        graph = dbg.pointer_jump(links)
        return chip_smoke.graph_digest(khi, klo, valid, graph)

    base = digest(np.arange(len(kept)))
    shuffled = digest(np.random.default_rng(0).permutation(len(kept)))
    assert shuffled == base
    fewer = digest(np.arange(len(kept) - 1))
    assert fewer["keys"] != base["keys"]
    assert fewer["links"] != base["links"]


def test_kept_reference_matches_count_keys():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(64, 40), dtype=np.uint8)
    codes[32:] = codes[:32]  # repeated rows put counts on both sides of 2
    codes[0, :10] = 0
    recs = minimizer.fast_scan(
        jnp.asarray(codes), jnp.full((64,), 40, jnp.int32), k=11, m=4
    )
    kc = count_ops.count_keys(recs, cutoff=2)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    kept, n_distinct = chip_smoke.kept_reference(
        chip_smoke.window_keys(codes, 11).reshape(-1), 2
    )
    assert np.array_equal(chip_smoke.device_keys(khi, klo, valid), kept)
    assert n_distinct == int(np.sum(np.asarray(kc.group_start & kc.valid)))
