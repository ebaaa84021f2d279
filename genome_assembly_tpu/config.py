"""Runtime configuration for the assembly pipeline.

The reference fixes K/M/cutoff/read-length at compile time
(binning.c:10-13: MMER_SIZE 4, KMER_SIZE 31, ABUNDANCE_CUTOFF 1,
READ_LENGTH 101).  Here they are runtime config; since they are static
arguments to jitted kernels, changing them triggers an XLA recompile -- the
natural analogue of the reference's recompile-per-#define.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of one assembly run.

    Attributes:
      k: k-mer window size (reference KMER_SIZE, binning.c:11).  Must satisfy
        ``k <= 31`` so a k-mer packs into 62 bits (two uint32 lanes), and in
        parity mode ``k >= 2*m`` (the only regime the reference supports --
        for m < k < 2m its incremental-update loop reads stale state and
        produces garbage, SURVEY.md 2.1.3).
      m: minimizer (m-mer) size (reference MMER_SIZE, binning.c:10). m <= 15.
      abundance_cutoff: keep a k-mer iff its occurrence count is strictly
        greater than this (reference ABUNDANCE_CUTOFF, binning.c:1096-1110).
      read_length: fgets buffer size in parity mode (reference READ_LENGTH,
        binning.c:13).  Lines are consumed in chunks of at most
        ``read_length - 1`` characters and the final character of each chunk
        is chopped, reproducing the reference's 99-bp truncation quirk
        (binning.c:1154-1166, SURVEY.md 2.1.6).
      parity: True -> replicate the reference binary bit-for-bit (complement
        without reversal, stale signatures, occurrence counting); False ->
        fast mode with true canonical minimizers.
      batch_reads: number of reads per device batch (padded).
      max_read_len: padded read length on device; reads longer than this are
        processed in halo'd segments (parallel/halo.py).
    """

    k: int = 31
    m: int = 4
    abundance_cutoff: int = 1
    read_length: int = 101
    parity: bool = True
    batch_reads: int = 4096
    max_read_len: int = 128
    # fast mode: record bytes above which counting goes out-of-core
    # (hash-partitioned re-scan passes, ops/outofcore.py)
    outofcore_bytes: int = 3 << 30
    # fast mode: per-partition byte budget for out-of-core link building
    # (boundary-record join, dbg.build_unitig_links_ooc); the join sort
    # peaks at ~3x resident, so graphs whose 4N-record set exceeds 3x
    # this budget are built in ceil(rec_bytes / budget) partitions
    link_budget_bytes: int = 1 << 30
    # fast mode: state count above which pointer jumping switches to the
    # low-memory per-round form (dbg.pointer_jump_bulk); the fused
    # while_loop double-buffers three full carries and OOMs at
    # chromosome scale
    bulk_jump_states: int = 1 << 26
    # distributed extension: carry dBG state ids as wide (shard, local)
    # pairs (parallel/part_dbg.py) -- required past 2**31 states
    # (BASELINE config 5's ~6e9 exceed int32).  "auto" switches when the
    # padded state count reaches 2**31; True forces wide ids at any
    # scale (differential tests / rehearsals)
    wide_state_ids: object = "auto"

    def __post_init__(self) -> None:
        if not (1 <= self.m <= 15):
            raise ValueError(f"m must be in [1, 15], got {self.m}")
        if not (self.m <= self.k <= 31):
            raise ValueError(f"k must be in [m, 31], got k={self.k} m={self.m}")
        if self.parity and self.k < 2 * self.m:
            raise ValueError(
                "parity mode requires k >= 2*m (the reference's incremental "
                f"branch is dead code only in that regime); got k={self.k} "
                f"m={self.m}"
            )
        if self.abundance_cutoff < 0:
            raise ValueError("abundance_cutoff must be >= 0")
        if self.max_read_len < self.k:
            raise ValueError("max_read_len must be >= k")
        if self.wide_state_ids not in (True, False, "auto"):
            raise ValueError(
                f"wide_state_ids must be True, False, or 'auto'; got "
                f"{self.wide_state_ids!r}"
            )

    @property
    def windows_per_read(self) -> int:
        """Max k-mer windows in a padded read."""
        return self.max_read_len - self.k + 1

    @property
    def mmer_mask(self) -> int:
        """4**m - 1: max m-mer score, also the complement mask."""
        return (1 << (2 * self.m)) - 1

    def kmer_split(self) -> Tuple[int, int]:
        """(n_hi, n_lo) bases packed into the hi/lo uint32 lanes of a k-mer."""
        n_lo = min(self.k, 16)
        return self.k - n_lo, n_lo


# Default config mirroring the reference compile-time constants.
REFERENCE_CONFIG = PipelineConfig()

# Small config exercisable on the input.txt fixture (15 bp reads; the
# reference needs a small-K rebuild for it, SURVEY.md section 2.0 item 15).
SMALL_CONFIG = PipelineConfig(k=6, m=3, read_length=101, max_read_len=32)
