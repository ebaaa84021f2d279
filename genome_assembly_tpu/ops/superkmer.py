"""Super-k-mer records: MSP/KMC-style compressed staging for the
out-of-core count (PAPERS.md: KMC 2, MSPKmerCounter), in array form.

Consecutive windows of a read sharing one minimizer form a SUPER-K-MER
spanning s + k - 1 bases.  Staging those bases once (2-bit packed) costs
24 B per record instead of 8 B per window -- at the measured ~13-window
mean run length that is ~4.3x less out-of-core staging, so each re-scan
pass can extract ~4x more partitions within the same device budget and
the pass count (the dominant out-of-core cost) drops proportionally.

Correctness: fast_scan's minimizer is a pure, strand-symmetric function
of the window's k bases, so every occurrence of a canonical k-mer has
the SAME minimizer -- partitioning records by a hash of the minimizer
keeps every k-mer's occurrences in one partition and per-partition
counts complete (the KMC signature-partition argument).  Expansion
re-runs fast_scan itself on the reconstructed base rows, so expanded
(hi, lo) values are the original scan's by construction.

Record format (6 uint32 lanes, flat [batch * n_windows], one record at
each run-start window slot, SENTINEL elsewhere):

  mmer | s | b0 | b1 | b2 | b3

where s <= S_CAP windows (longer runs split deterministically every
S_CAP windows) and b0..b3 pack the span's first 64 bases 2-bit
little-endian.  S_CAP = 25 keeps the span <= 55 bases for every k <= 31.

Reference contrast: the reference stores ~1 kB per occurrence
(SURVEY.md section 6) and has no compressed staging concept at all.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from genome_assembly_tpu.common import SENTINEL
from genome_assembly_tpu.ops import minimizer

S_CAP = 25  # windows per record; span = S_CAP + k - 1 <= 55 bases (k <= 31)
LANES = 6  # mmer, s, b0..b3


@functools.partial(jax.jit, static_argnames=("k", "m"))
def super_records(codes: jnp.ndarray, lengths: jnp.ndarray, *, k: int, m: int):
    """One batch's super-k-mer records, flat [batch * n_windows] lanes.

    Returns (mmer, slen, b0, b1, b2, b3): a record sits at each run-start
    window slot (SENTINEL mmer elsewhere).  Runs are maximal stretches of
    consecutive valid windows with equal fast_scan minimizer, split every
    S_CAP windows.
    """
    if k > 31:
        raise ValueError("super-k-mer staging supports k <= 31")
    batch, max_len = codes.shape
    n_win = max_len - k + 1
    recs = minimizer.fast_scan(codes, lengths, k=k, m=m)
    mm = jnp.where(recs.valid, recs.mmer, SENTINEL)

    # raw run starts: first window, minimizer change, or validity change
    prev = jnp.concatenate(
        [jnp.full((batch, 1), SENTINEL, jnp.uint32), mm[:, :-1]], axis=1
    )
    raw_start = (mm != prev) | (
        jax.lax.broadcasted_iota(jnp.int32, (batch, n_win), 1) == 0
    )
    idx = jax.lax.broadcasted_iota(jnp.int32, (batch, n_win), 1)
    raw_start_idx = lax.associative_scan(
        jnp.maximum, jnp.where(raw_start, idx, -1), axis=1
    )
    # split long runs every S_CAP windows from the raw start
    start = raw_start | ((idx - raw_start_idx) % S_CAP == 0)
    start_idx = lax.associative_scan(
        jnp.maximum, jnp.where(start, idx, -1), axis=1
    )
    # next start (or end of the valid prefix) bounds each record's length
    starts_or_n = jnp.where(start, idx, n_win)
    suffix_min = lax.associative_scan(
        jnp.minimum, starts_or_n, axis=1, reverse=True
    )
    next_start = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((batch, 1), n_win, jnp.int32)], axis=1
    )
    n_valid = jnp.maximum(lengths - k + 1, 0)[:, None]
    slen = jnp.clip(jnp.minimum(next_start, n_valid) - idx, 0, S_CAP)

    # pack each record's first 64 bases from its start column with a
    # fori_loop of dynamic slices, not 55 statically-shifted slices fused
    # into one 55-ary OR tree: the loop keeps the compiled program O(1)
    # in span; the 2-bit shift rides the loop counter.  Output is bit-identical (pinned by
    # the super-vs-plain differential tests).
    span = S_CAP + k - 1  # <= 55
    pad = jnp.zeros((batch, span), jnp.uint8)
    codes_pad = jnp.concatenate([codes, pad], axis=1)
    lanes_b = []
    for i in range(4):
        n_t = max(0, min(16, span - 16 * i))
        if n_t == 0:
            lanes_b.append(jnp.zeros((batch, n_win), jnp.uint32))
            continue

        def body(t, acc, _i=i):
            col = lax.dynamic_slice(
                codes_pad, (jnp.int32(0), jnp.int32(16 * _i) + t),
                (batch, n_win),
            )
            return acc | jnp.left_shift(
                col.astype(jnp.uint32), (2 * t).astype(jnp.uint32)
            )

        lanes_b.append(
            lax.fori_loop(0, n_t, body, jnp.zeros((batch, n_win), jnp.uint32))
        )

    is_rec = start & recs.valid
    out_mm = jnp.where(is_rec, mm, SENTINEL).reshape(-1)
    out_s = jnp.where(is_rec, slen.astype(jnp.uint32), SENTINEL).reshape(-1)
    outs = [jnp.where(is_rec, lb, SENTINEL).reshape(-1) for lb in lanes_b]
    return (out_mm, out_s, *outs)


@functools.partial(jax.jit, static_argnames=("k", "m"))
def expand_records(mm, slen, b0, b1, b2, b3, *, k: int, m: int):
    """Reconstruct base rows from records and re-scan them.

    Returns (hi, lo) flat [n * S_CAP] canonical k-mer lanes (SENTINEL =
    padding beyond each record's s windows) -- exactly the source scan's
    values for those windows, because fast_scan itself runs on the
    reconstructed bases.
    """
    span = S_CAP + k - 1
    lanes = (b0, b1, b2, b3)
    cols = []
    for b in range(span):
        cols.append(((lanes[b // 16] >> (2 * (b % 16))) & 3).astype(jnp.uint8))
    codes = jnp.stack(cols, axis=1)  # [n, span]
    valid_rec = mm != SENTINEL
    lengths = jnp.where(
        valid_rec, slen + jnp.uint32(k - 1), 0
    ).astype(jnp.int32)
    recs = minimizer.fast_scan(codes, lengths, k=k, m=m)
    hi = jnp.where(recs.valid, recs.kmer_hi, SENTINEL).reshape(-1)
    lo = jnp.where(recs.valid, recs.kmer_lo, SENTINEL).reshape(-1)
    return hi, lo
