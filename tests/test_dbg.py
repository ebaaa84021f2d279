"""Fast-mode dBG compaction vs a brute-force Python oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from genome_assembly_tpu.ops import dbg, encode

RC = str.maketrans("ACGT", "TGCA")


def rc(s):
    return s.translate(RC)[::-1]


def canon(s):
    return min(s, rc(s), key=encode.pack_str)


def genome_kmers(genome, k):
    return [genome[i : i + k] for i in range(len(genome) - k + 1)]


def brute_force_unitigs(kmers, k):
    """Textbook bidirectional dBG compaction over canonical k-mers.

    Returns (linear, cycles): linear as strand-canonical strings, cycles as
    rotation+strand-canonical period strings.
    """
    nodes = {canon(x) for x in kmers}

    def present(s):
        return canon(s) in nodes

    def fwd_deg(s):
        # hairpin edges (continuation == rc(s)) are port loops: degree 2
        d = 0
        for b in "ACGT":
            t = s[1:] + b
            if present(t):
                d += 2 if t == rc(s) else 1
        return d

    def bwd_deg(s):
        return fwd_deg(rc(s))

    def fwd_exts(s):
        return [b for b in "ACGT" if present(s[1:] + b)]

    def bwd_exts(s):
        return [b for b in "ACGT" if present(b + s[:-1])]

    def unitig_edge(s):
        if fwd_deg(s) != 1:
            return None
        t = s[1:] + fwd_exts(s)[0]
        if bwd_deg(t) != 1:
            return None
        return t

    states = set()
    for x in nodes:
        states.add(x)
        states.add(rc(x))

    def has_unitig_pred(s):
        preds = bwd_exts(s)
        if len(preds) != 1:
            return False
        return unitig_edge(preds[0] + s[:-1]) == s

    linear = set()
    visited = set()
    for s in sorted(states):
        if has_unitig_pred(s):
            continue
        seq = s
        visited.add(s)
        cur = s
        while True:
            t = unitig_edge(cur)
            if t is None or t == s:
                break
            seq += t[-1]
            visited.add(t)
            cur = t
        linear.add(min(seq, rc(seq)))

    cycles = set()
    remaining = states - visited
    while remaining:
        s = sorted(remaining)[0]
        seq = s
        cur = s
        members = [s]
        while True:
            t = unitig_edge(cur)
            assert t is not None, "non-cycle state left over"
            if t == s:
                break
            seq += t[-1]
            members.append(t)
            cur = t
        for t in members:
            remaining.discard(t)
            remaining.discard(rc(t))
        body = seq[k - 1 :]
        rc_body = rc(seq)[k - 1 :]
        cycles.add(
            min(
                min(body[i:] + body[:i] for i in range(len(body))),
                min(rc_body[i:] + rc_body[:i] for i in range(len(rc_body))),
            )
        )
    return linear, cycles


def run_device_compaction(kmers, k):
    keys = sorted({encode.pack_str(canon(x)) for x in kmers})
    n = len(keys)
    pad = max(8, 1 << int(np.ceil(np.log2(max(n, 2)))))
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    links = dbg.build_unitig_links(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
    )
    graph = dbg.pointer_jump(links)
    return dbg.materialize_unitigs(hi, lo, valid, graph, k)


def split_device_output(unitigs, k, want_cycles):
    """Classify device unitigs into (linear set, cycle-period set) using
    the brute-force cycle periods for identification."""
    linear = set()
    cycles = set()
    for u in unitigs:
        body = u[k - 1 :]
        rc_body = rc(u)[k - 1 :]
        cands = {body[i:] + body[:i] for i in range(len(body))} | {
            rc_body[i:] + rc_body[:i] for i in range(len(rc_body))
        }
        hit = cands & want_cycles
        if hit:
            cycles.add(next(iter(hit)))
        else:
            linear.add(min(u, rc(u)))
    return linear, cycles


def check_exact_coverage(unitigs, kmers, k):
    """Every canonical k-mer appears in exactly one unitig exactly once."""
    ms = {}
    for u in unitigs:
        for x in genome_kmers(u, k):
            c = canon(x)
            ms[c] = ms.get(c, 0) + 1
    assert set(ms) == {canon(x) for x in kmers}
    assert all(v == 1 for v in ms.values()), "k-mer repeated across unitigs"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [5, 7, 11])
def test_compaction_matches_brute_force_random_genome(seed, k):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=200))
    kmers = genome_kmers(genome, k)
    want_linear, want_cycles = brute_force_unitigs(kmers, k)
    got = run_device_compaction(kmers, k)
    got_linear, got_cycles = split_device_output(got, k, want_cycles)
    assert got_linear == want_linear
    assert got_cycles == want_cycles
    check_exact_coverage(got, kmers, k)


def test_with_reverse_complement_reads():
    """Mixed-strand input must collapse to the same canonical graph."""
    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    k = 9
    kmers_fwd = genome_kmers(genome, k)
    kmers_mixed = [x if i % 2 else rc(x) for i, x in enumerate(kmers_fwd)]
    assert run_device_compaction(kmers_fwd, k) == run_device_compaction(
        kmers_mixed, k
    )


def test_simple_linear_genome():
    # A/G-only genome: reverse complements are T/C-only, so no hairpins or
    # palindromic junctions -- must compact to one unitig.
    genome = "AAGGAGAGGGAAGAGGA"
    k = 7
    assert len(set(genome_kmers(genome, k))) == len(genome) - k + 1
    got = run_device_compaction(genome_kmers(genome, k), k)
    assert len(got) == 1
    assert got[0] in (genome, rc(genome))


def test_palindromic_junction_splits():
    # contains the palindromic 6-mer GGATCC: the hairpin rule must split
    # deterministically and identically to the oracle
    genome = "ACGTGCAATCGGATCCA"
    k = 7
    kmers = genome_kmers(genome, k)
    want_linear, want_cycles = brute_force_unitigs(kmers, k)
    got = run_device_compaction(kmers, k)
    got_linear, got_cycles = split_device_output(got, k, want_cycles)
    assert got_linear == want_linear
    assert got_cycles == want_cycles
    check_exact_coverage(got, kmers, k)


def test_branch_splits_unitigs():
    k = 5
    reads = ["AAACGTTTCC", "GGACGTTTAA"]
    kmers = [x for r in reads for x in genome_kmers(r, k)]
    got = run_device_compaction(kmers, k)
    want_linear, want_cycles = brute_force_unitigs(kmers, k)
    got_linear, got_cycles = split_device_output(got, k, want_cycles)
    assert got_linear == want_linear
    assert got_cycles == want_cycles
    check_exact_coverage(got, kmers, k)


def test_cycle_genome():
    k = 5
    period = "ACGGTCA"
    s = period * 3
    kmers = sorted({canon(s[i : i + k]) for i in range(len(period))})
    want_linear, want_cycles = brute_force_unitigs(kmers, k)
    got = run_device_compaction(kmers, k)
    got_linear, got_cycles = split_device_output(got, k, want_cycles)
    assert got_linear == want_linear
    assert got_cycles == want_cycles


def test_self_loop_homopolymer():
    # AAAAA's canonical kmer has a self edge; must not hang or duplicate
    k = 5
    kmers = ["AAAAA", "AAAAC", "AACGT"]
    got = run_device_compaction(kmers, k)
    ms = set()
    for u in got:
        for x in genome_kmers(u, k):
            ms.add(canon(x))
    assert ms == {canon(x) for x in kmers}


def test_join_builder_matches_candidate_builder():
    """build_unitig_links_join (sort-join form) == build_unitig_links
    (candidate-lookup form) across k widths, including hairpin-rich small-k
    key sets (SURVEY.md 2.1.8 neighbor semantics, sort-join formulation)."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        k = [3, 5, 11, 17, 31][trial % 5]
        glen = [30, 80, 300, 1200][trial % 4]
        genome = "".join(rng.choice(list("ACGT"), size=glen))
        keys = sorted({encode.pack_str(canon(x)) for x in genome_kmers(genome, k)})
        pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
        n_lo = min(k, 16)
        hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        valid = np.zeros(pad, dtype=bool)
        for i, v in enumerate(keys):
            hi[i] = v >> (2 * n_lo)
            lo[i] = v & ((1 << (2 * n_lo)) - 1)
            valid[i] = True
        hi, lo, valid = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)
        a = np.asarray(dbg.build_unitig_links(hi, lo, valid, k=k))
        b = np.asarray(dbg.build_unitig_links_join(hi, lo, valid, k=k))
        assert np.array_equal(a, b), (trial, k, glen)


def test_pointer_jump_bulk_matches_fused():
    """pointer_jump_bulk (per-round donated-buffer variant for huge
    graphs) == pointer_jump on chains, cycles, and isolated states."""
    rng = np.random.default_rng(3)
    for glen, k in [(60, 5), (400, 11), (1200, 31)]:
        genome = "".join(rng.choice(list("ACGT"), size=glen))
        keys = sorted({encode.pack_str(canon(x)) for x in genome_kmers(genome, k)})
        pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
        n_lo = min(k, 16)
        hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        valid = np.zeros(pad, dtype=bool)
        for i, v in enumerate(keys):
            hi[i] = v >> (2 * n_lo)
            lo[i] = v & ((1 << (2 * n_lo)) - 1)
            valid[i] = True
        links = dbg.build_unitig_links_join(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
        )
        a = dbg.pointer_jump(links)
        b = dbg.pointer_jump_bulk(links)
        assert np.array_equal(np.asarray(a.head), np.asarray(b.head))
        assert np.array_equal(np.asarray(a.rank), np.asarray(b.rank))
        assert np.array_equal(np.asarray(a.is_cycle), np.asarray(b.is_cycle))
        # low-memory chunked rounds (with a non-dividing chunk count, so
        # self-absorbed padding is exercised and sliced back out)
        c = dbg.pointer_jump_bulk(links, lowmem_chunks=3)
        assert np.array_equal(np.asarray(a.head), np.asarray(c.head))
        assert np.array_equal(np.asarray(a.rank), np.asarray(c.rank))
        assert np.array_equal(np.asarray(a.is_cycle), np.asarray(c.is_cycle))
        assert c.head.shape == a.head.shape

    # explicit cycle: the repeated period from test_cycle_genome
    k = 5
    period = "ACGGTCA"
    s = period * 3
    keys = sorted(
        {encode.pack_str(canon(s[i : i + k])) for i in range(len(period))}
    )
    hi = np.full(32, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(32, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(32, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * min(k, 16))
        lo[i] = v & ((1 << (2 * min(k, 16))) - 1)
        valid[i] = True
    links = dbg.build_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
    )
    a = dbg.pointer_jump(links)
    b = dbg.pointer_jump_bulk(links)
    assert np.asarray(a.is_cycle).any()  # the construction really cycles
    assert np.array_equal(np.asarray(a.head), np.asarray(b.head))
    assert np.array_equal(np.asarray(a.rank), np.asarray(b.rank))
    assert np.array_equal(np.asarray(a.is_cycle), np.asarray(b.is_cycle))


def test_ooc_link_builder_matches_join():
    """build_unitig_links_ooc (hash-partitioned multi-pass) ==
    build_unitig_links_join across k widths, partition counts, and chunk
    sizes -- including chunks that split the node array and partition
    counts that are not multiples of the extraction GROUP."""
    rng = np.random.default_rng(11)
    for trial, (k, glen, parts, chunk) in enumerate(
        [
            (5, 80, 2, 64),
            (11, 600, 4, 128),
            (17, 900, 5, 256),
            (31, 1500, 7, 128),
            (31, 1500, 3, 1024),
        ]
    ):
        genome = "".join(rng.choice(list("ACGT"), size=glen))
        keys = sorted({encode.pack_str(canon(x)) for x in genome_kmers(genome, k)})
        pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
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
        got, ovf = dbg.build_unitig_links_ooc(
            hi, lo, valid, k=k, partitions=parts, chunk_nodes=chunk
        )
        assert ovf == 0, (trial, k, parts)
        assert np.array_equal(np.asarray(got), want), (trial, k, parts, chunk)


def test_parked_link_builder_matches_join():
    """build_unitig_links_parked (host-parked keys and/or host-parked link
    array) == build_unitig_links_join, for all four parking combinations.
    Host-parked keys arrive as numpy and are uploaded chunk-by-chunk;
    park_links accumulates next_state in host RAM from compacted edge
    readbacks -- the chromosome-scale configuration where neither the key
    array nor the 2N link array fits device HBM next to sort temporaries."""
    rng = np.random.default_rng(13)
    for trial, (k, glen, parts, chunk) in enumerate(
        [
            (11, 600, 4, 128),
            (31, 1500, 5, 256),
        ]
    ):
        genome = "".join(rng.choice(list("ACGT"), size=glen))
        keys = sorted({encode.pack_str(canon(x)) for x in genome_kmers(genome, k)})
        pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
        n_lo = min(k, 16)
        hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
        valid = np.zeros(pad, dtype=bool)
        for i, v in enumerate(keys):
            hi[i] = v >> (2 * n_lo)
            lo[i] = v & ((1 << (2 * n_lo)) - 1)
            valid[i] = True
        want = np.asarray(
            dbg.build_unitig_links_join(
                jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
            )
        )
        for host_keys in (False, True):
            for park_links in (False, True):
                kh = hi if host_keys else jnp.asarray(hi)
                kl = lo if host_keys else jnp.asarray(lo)
                va = valid if host_keys else jnp.asarray(valid)
                got, ovf = dbg.build_unitig_links_parked(
                    kh, kl, va, k=k, partitions=parts, chunk_nodes=chunk,
                    park_links=park_links,
                )
                assert ovf == 0, (trial, host_keys, park_links)
                if park_links:
                    assert isinstance(got, np.ndarray)
                assert np.array_equal(np.asarray(got), want), (
                    trial, k, host_keys, park_links,
                )


def test_large_cycle_materializes_fast():
    """A 20k-period circular genome is ONE cycle unitig; the vectorized
    cycle path (pointer-doubled ranks + flat-buffer assembly + min-node
    dedup) must spell a rotation of the genome or its rc.  The former
    per-state walk with O(L^2) rotation canonicalization could not finish
    this size."""
    rng = np.random.default_rng(5)
    period, k = 20000, 21
    s = "".join(rng.choice(list("ACGT"), size=period))
    circ = s + s[: k - 1]
    kmers = genome_kmers(circ, k)
    # all windows canonically distinct => the dBG is one simple cycle
    assert len({canon(x) for x in kmers}) == period
    got = run_device_compaction(kmers, k)
    assert len(got) == 1
    u = got[0]
    assert len(u) == period + k - 1
    body = u[k - 1 :]
    assert body in (s + s) or body in (rc(s) + rc(s))
    check_exact_coverage(got, kmers, k)


def test_many_cycles_match_oracle():
    """Dozens of disjoint circular sequences: the vectorized multi-cycle
    assembly and its twin-traversal dedup must agree with the brute-force
    oracle (including any accidental linear fragments from canonical
    collisions between cycles)."""
    rng = np.random.default_rng(11)
    k = 11
    kmers = []
    for i in range(25):
        period = 30 + i
        s = "".join(rng.choice(list("ACGT"), size=period))
        kmers.extend(genome_kmers(s + s[: k - 1], k))
    want_linear, want_cycles = brute_force_unitigs(kmers, k)
    got = run_device_compaction(kmers, k)
    got_linear, got_cycles = split_device_output(got, k, want_cycles)
    assert got_linear == want_linear
    assert got_cycles == want_cycles
    check_exact_coverage(got, kmers, k)


def test_cycle_coverage_sums():
    """materialize_unitigs_cov over a pure cycle: occ_sum is the sum of
    member-node counts and n_kmers the cycle length."""
    rng = np.random.default_rng(13)
    period, k = 500, 15
    s = "".join(rng.choice(list("ACGT"), size=period))
    kmers = genome_kmers(s + s[: k - 1], k)
    assert len({canon(x) for x in kmers}) == period
    keys = sorted({encode.pack_str(canon(x)) for x in kmers})
    pad = max(8, 1 << int(np.ceil(np.log2(len(keys)))))
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    links = dbg.build_unitig_links(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
    )
    graph = dbg.pointer_jump(links)
    counts = np.zeros(pad, dtype=np.uint32)
    counts[: len(keys)] = 3
    unitigs, occ_sum, n_kmers = dbg.materialize_unitigs_cov(
        hi, lo, valid, graph, k, counts
    )
    assert len(unitigs) == 1
    assert int(n_kmers[0]) == period
    assert int(occ_sum[0]) == 3 * period


def _keys_arrays(kmers, k):
    keys = sorted({encode.pack_str(canon(x)) for x in kmers})
    pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    return hi, lo, valid


def test_materialize_device_matches_host():
    """materialize_unitigs_device == materialize_unitigs on linear chains,
    cycles, palindromic junctions, hairpins, and isolated states -- and the
    coverage variant's sums/lengths agree too."""
    rng = np.random.default_rng(17)
    cases = []
    for seed, glen, k in [(0, 200, 5), (1, 200, 7), (2, 500, 11),
                          (3, 1200, 31), (4, 90, 17)]:
        g = "".join(np.random.default_rng(seed).choice(list("ACGT"),
                                                       size=glen))
        cases.append((genome_kmers(g, k), k))
    cases.append((genome_kmers("ACGTGCAATCGGATCCA", 7), 7))  # palindrome
    period = "ACGGTCA"
    cases.append(
        ([ (period * 3)[i:i+5] for i in range(len(period)) ], 5)
    )  # cycle
    big = "".join(rng.choice(list("ACGT"), size=3000))
    cases.append((genome_kmers(big + big[:20], 21), 21))  # big incl. wrap

    for kmers, k in cases:
        hi, lo, valid = _keys_arrays(kmers, k)
        links = dbg.build_unitig_links_join(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
        )
        graph = dbg.pointer_jump(links)
        want = dbg.materialize_unitigs(hi, lo, valid, graph, k)
        got, occ, nk = dbg.materialize_unitigs_device(
            hi, lo, valid, graph, k
        )
        assert got == want, k
        assert occ.size == 0 and nk.size == 0
        # coverage variant
        counts = np.zeros(hi.shape[0], dtype=np.uint32)
        counts[valid] = rng.integers(1, 9, size=int(valid.sum()))
        wu, wo, wn = dbg.materialize_unitigs_cov(hi, lo, valid, graph, k,
                                                 counts)
        gu, go, gn = dbg.materialize_unitigs_device(hi, lo, valid, graph,
                                                    k, counts)
        assert gu == wu, k
        assert np.array_equal(go, wo) and np.array_equal(gn, wn), k


def test_link_builders_self_heal_cap_overflow(monkeypatch):
    """A statistically-sized staging cap that misses must NOT abort (or
    silently drop edges): the builders withhold the overflowed partition's
    edges and re-extract it alone with an escalated cap
    (dbg._reextract_partition3).  Forced here by shrinking
    range_group_plan's cap far below every partition's true share; results
    must still equal the in-core join exactly, with zero reported
    (unresolved) overflow.  Guards the chr1-scale failure mode."""
    from genome_assembly_tpu.ops import outofcore

    real_plan = outofcore.range_group_plan

    def tiny_plan(n_units, unit_records, **kw):
        _, G = real_plan(n_units, unit_records, **kw)
        return max(16, unit_records // 32), G  # guaranteed too small

    monkeypatch.setattr(outofcore, "range_group_plan", tiny_plan)

    rng = np.random.default_rng(29)
    k, glen, parts, chunk = 17, 900, 4, 256
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    keys = sorted({encode.pack_str(canon(x)) for x in genome_kmers(genome, k)})
    pad = max(8, 1 << int(np.ceil(np.log2(max(len(keys), 2)))))
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i] = v >> (2 * n_lo)
        lo[i] = v & ((1 << (2 * n_lo)) - 1)
        valid[i] = True
    want = np.asarray(
        dbg.build_unitig_links_join(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
        )
    )
    got, ovf = dbg.build_unitig_links_ooc(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        k=k, partitions=parts, chunk_nodes=chunk,
    )
    assert ovf == 0
    assert np.array_equal(np.asarray(got), want)
    for park_links in (False, True):
        got, ovf = dbg.build_unitig_links_parked(
            hi, lo, valid, k=k, partitions=parts, chunk_nodes=chunk,
            park_links=park_links,
        )
        assert ovf == 0, park_links
        assert np.array_equal(np.asarray(got), want), park_links


def test_link_partition_balance_under_count_partition_order():
    """The kept-key array reaches the link builders ordered by COUNT
    partition (partitioned_count concatenates per-partition keys), and
    the k=31 FWD-suffix boundary key shares its whole lo lane with the
    k-mer -- under the raw linear two-lane combine the suffix hashes of
    one count partition fell in ~4 narrow top-16 bands -- and a T-leading
    k-mer's suffix packs to the IDENTICAL (hi, lo) pair, surviving any
    shared finalizer -- loading one link partition per chunk at ~2x mean
    (the chr1 cap-overflow root cause).  With the link builders'
    independent hash constants (common.LINK_HASH_A/B + fmix32) the worst
    per-chunk link-partition load must stay near uniform."""
    import jax.numpy as jnp

    from genome_assembly_tpu.ops import outofcore

    rng = np.random.default_rng(3)
    n = 1 << 17
    hi = jnp.asarray(rng.integers(0, 1 << 30, size=n, dtype=np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 32, size=n, dtype=np.uint32))
    rhi, rlo = encode.reverse_complement_packed(hi, lo, 31)
    fwd = (hi < rhi) | ((hi == rhi) & (lo <= rlo))
    chi = np.asarray(jnp.where(fwd, hi, rhi))
    clo = np.asarray(jnp.where(fwd, lo, rlo))
    cpid = np.asarray(
        outofcore.key_partition_range(jnp.asarray(chi), jnp.asarray(clo), 55)
    )
    order = np.lexsort((clo, chi, cpid))
    chi, clo = chi[order], clo[order]
    chunk = n // 8
    P_link = 12
    worst = 0.0
    for c in range(8):
        s = c * chunk
        rk_hi, rk_lo, _ = dbg._chunk_boundary_records(
            jnp.asarray(chi[s : s + chunk]), jnp.asarray(clo[s : s + chunk]),
            jnp.asarray(np.ones(chunk, bool)), jnp.int32(s),
            k=31, chunk_nodes=chunk,
        )
        rk_hi = np.asarray(rk_hi)
        rk_lo = np.asarray(rk_lo)
        mvalid = rk_hi != 0xFFFFFFFF
        pid = np.asarray(outofcore.link_partition_range(
            jnp.asarray(rk_hi[mvalid]), jnp.asarray(rk_lo[mvalid]), P_link
        ))
        bc = np.bincount(pid, minlength=P_link)
        worst = max(worst, bc.max() / bc.mean())
    assert worst < 1.25, worst  # raw combine measured 1.97 here


def test_materialize_partitioned_matches_host():
    """materialize_unitigs_partitioned == materialize_unitigs as a SET on
    every shape (chains, cycles, palindromes, hairpins), at several
    bucket counts including 1 -- the bounded-memory single-host form of
    config 5's distributed materialization.  The palindrome case pins
    the chain-invariant twin-head dedup (the cross-chain set the plain
    materializer uses is unavailable across buckets)."""
    rng = np.random.default_rng(23)
    cases = []
    for seed, glen, k in [(0, 200, 5), (2, 500, 11), (3, 1200, 31)]:
        g = "".join(np.random.default_rng(seed).choice(list("ACGT"),
                                                       size=glen))
        cases.append((genome_kmers(g, k), k))
    cases.append((genome_kmers("ACGTGCAATCGGATCCA", 7), 7))  # palindrome
    period = "ACGGTCA"
    cases.append(
        ([(period * 3)[i:i + 5] for i in range(len(period))], 5)
    )  # cycle
    big = "".join(rng.choice(list("ACGT"), size=3000))
    cases.append((genome_kmers(big + big[:20], 21), 21))

    for kmers, k in cases:
        hi, lo, valid = _keys_arrays(kmers, k)
        links = dbg.build_unitig_links_join(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
        )
        graph = dbg.pointer_jump(links)
        want = sorted(dbg.materialize_unitigs(hi, lo, valid, graph, k))
        for parts in (1, 3, 8):
            got = sorted(dbg.materialize_unitigs_partitioned(
                hi, lo, valid, graph, k, partitions=parts
            ))
            assert got == want, (k, parts)
        # int64 graph arrays (the wide-id pipeline's host conversion)
        g64 = dbg.CompactedGraph(
            next_state=np.asarray(graph.next_state).astype(np.int64),
            head=np.asarray(graph.head).astype(np.int64),
            rank=np.asarray(graph.rank).astype(np.int64),
            is_cycle=np.asarray(graph.is_cycle),
        )
        got64 = sorted(dbg.materialize_unitigs_partitioned(
            hi, lo, valid, g64, k, partitions=4
        ))
        assert got64 == want, k


def test_materialize_device_compact_oom_rescue(monkeypatch):
    """If _materialize_prep_compact RESOURCE_EXHAUSTs after the donating
    walk sort consumed the graph lanes, materialize_unitigs_device must
    rescue through the fat sid-readback placement and still return the
    exact host result (chr1 r4i lost its end-to-end artifact to this:
    the caller-side fallback found only deleted arrays)."""
    rng = np.random.default_rng(23)
    g = "".join(rng.choice(list("ACGT"), size=900))
    k = 11
    kmers = genome_kmers(g, k)
    hi, lo, valid = _keys_arrays(kmers, k)
    links = dbg.build_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k
    )
    graph = dbg.pointer_jump(links)
    want = dbg.materialize_unitigs(hi, lo, valid, graph, k)

    def boom(*a, **kw):
        raise RuntimeError("RESOURCE_EXHAUSTED: forced by test")

    monkeypatch.setattr(dbg, "_materialize_prep_compact", boom)
    got, occ, nk = dbg.materialize_unitigs_device(
        hi, lo, valid, graph, k, donate=True
    )
    assert got == want
    assert occ.size == 0 and nk.size == 0
