"""Counter-based virtual genome: bases as a pure function of position.

Materializing the synthetic genome on device costs a ``jax.random.randint``
over all G bases on every (resumed) run, ~3 GB of device residency at
3 Gbp, and a [batch, read_len] row gather per batch.

A synthetic random genome is just a pseudo-random function of position,
so none of that is necessary: ``base(p) = mix(seed, p) & 3`` with a
double-fmix32 counter hash derives any read's bases directly from its
start position.  Overlapping reads agree on shared bases exactly as
they would against a materialized genome (the property the reference's
generator provides by sampling all reads from one genome string,
/root/reference/generate_reads.py:9-21) -- the genome is simply never
stored, and a resumed window regenerates nothing.

The two mixes give full avalanche twice; the composition is bijective
in ``p`` for fixed seed, so the base stream is exactly 25/25/25/25
uniform over any 2^32-aligned window and statistically interchangeable
with the jax.random.randint genome for k-mer counting purposes (both
are uniform pseudo-random base streams; only the PRNG differs, so
datasets generated by the two schemes are different but same-shaped).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from genome_assembly_tpu import common

# Seed diffusion constant: deliberately distinct from the count
# (HASH_A/B) and link (LINK_HASH_A/B) partition-hash families so genome
# bases can never correlate with partition ownership (common.py records
# why shared constants between hash families caused the chr1 banding).
_SEED_MIX = np.uint32(0x9E3779B9)


def genome_bases(seed: int, positions: jnp.ndarray) -> jnp.ndarray:
    """Bases (codes 0..3, T=0 G=1 C=2 A=3 per ops/encode.py) at
    ``positions`` (uint32 array, any shape) of the virtual genome
    ``seed``.

    Pure elementwise ALU work -- no genome array, no gather.  Positions
    up to 2^32-1 cover the 3 Gbp contract configuration with headroom.
    """
    # wrapping uint32 multiply via Python ints: numpy scalar overflow
    # raises RuntimeWarning even though the wraparound is the point
    s = np.uint32(((int(seed) * int(_SEED_MIX)) & 0xFFFFFFFF) | 1)
    h = common.fmix32(positions.astype(jnp.uint32) ^ s)
    h = common.fmix32(h + s)
    return (h & np.uint32(3)).astype(jnp.uint8)


def read_batch(
    seed: int, starts: jnp.ndarray, read_len: int
) -> jnp.ndarray:
    """[batch, read_len] base codes for reads starting at ``starts``
    (uint32 positions) of virtual genome ``seed``."""
    offs = jnp.arange(read_len, dtype=jnp.uint32)[None, :]
    return genome_bases(seed, starts[:, None] + offs)
