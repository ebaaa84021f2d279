"""Shared scalar constants.

These are numpy scalars ON PURPOSE: a module-level ``jnp`` scalar would
initialize the default backend at import time -- before any CLI ``--cpu``
switch -- and reserve device memory in every process that merely imports
the package.  Keep anything importable at module scope numpy.
"""

from __future__ import annotations

import numpy as np

# Sentinel key lane value: real packed k-mers/m-mers use < 2*k <= 62 bits
# per lane pair (hi < 2^30 for k=31), so all-ones marks invalid/padding and
# sorts after every real record.
SENTINEL = np.uint32(0xFFFFFFFF)

# Multiplicative mixing constants for key -> owner hashing; used
# consistently so partition/ownership decisions agree across modules that
# must colocate the same keys.  The two constants MUST differ: round-3
# shipped HASH_B = 0x9E3779B1 = 2654435761 -- the SAME golden-ratio
# constant in hex and decimal -- which made every same-operand hash
# (x*A)^(x*B) identically zero (the super-k-mer partitioner sent ALL
# records to partition 0) and every two-lane hash (hi*A)^(lo*B) symmetric
# in its lanes; the weakened mixing is the measured source of the chr1
# link-partition cap overflow.  HASH_B is now the Murmur3 fmix32 constant.
HASH_A = np.uint32(2654435761)  # Knuth golden ratio, 0x9E3779B1
HASH_B = np.uint32(0x85EBCA6B)  # Murmur3 fmix32

# Independent constants for the LINK builders' partition hash.  The count
# and link phases hash DIFFERENT keys (31-mer vs boundary 30-mer), but the
# 2-bit packing carries no length: a k-mer whose leading base is T (code 0)
# packs to exactly the same (hi, lo) pair as its 30-mer suffix, so with a
# shared hash function ~1/4 of the FWD-suffix records inherit their k-mer's
# COUNT partition band verbatim -- and the kept-key array arrives at the
# link builders ordered by count partition, concentrating those records on
# one link partition per chunk (measured 1.78x mean with a shared fmix32
# hash; the chr1 cap-overflow root cause).  Distinct multipliers make the
# two partition functions independent even on identical inputs.
LINK_HASH_A = np.uint32(0xC2B2AE35)  # Murmur3 fmix32 second constant
LINK_HASH_B = np.uint32(0x27D4EB2F)  # xxHash PRIME32_4

_FMIX_C1 = np.uint32(0x85EBCA6B)
_FMIX_C2 = np.uint32(0xC2B2AE35)


def fmix32(x):
    """Murmur3 finalizer: full-avalanche diffusion of a 32-bit value.

    The raw two-lane combine (hi*A)^(lo*B) is LINEAR in each lane, so two
    hashes that share a lane differ only by the other lane's contribution
    -- measured to band the out-of-core LINK partitions when the node
    array arrives ordered by COUNT partition (the k=31 FWD-suffix
    boundary key shares its entire lo lane with the k-mer, so within one
    count partition the suffix hashes fall in ~4 narrow top-16 bands:
    worst per-chunk partition load 1.97x mean, overflowing any
    statistical cap).  One fmix32 over the combined value destroys the
    band structure (measured 1.97 -> 1.012).  Works on jnp and np uint32
    arrays alike.
    """
    x = x ^ (x >> 16)
    x = x * _FMIX_C1
    x = x ^ (x >> 13)
    x = x * _FMIX_C2
    x = x ^ (x >> 16)
    return x
