"""Accelerator-native de novo genome assembly engine.

A JAX/XLA implementation of the capabilities of the reference C program
``twitu/genome-assembly`` (canonical k-mer extraction with m-mer minimizer
signatures, abundance counting with low-coverage pruning, and de Bruijn
unitig extension), redesigned as array programs for a GPU:

- k-mers are 2-bit-packed integers; the CPU pointer structures (two-level
  chained string hash + linked lists) become arrays + sorts + segmented
  reductions on device (reference: binning.c:902-1076, zhash.c, llist.c).
- Multi-device scaling is minimizer-sharded counting via ``shard_map`` +
  ``all_to_all`` over a ``jax.sharding.Mesh`` (the parallel design the
  reference only hints at in FAQ.md:11).
- Two operating modes: ``parity`` replicates the reference binary's exact
  output including its documented quirks (SURVEY.md section 2.1); ``fast`` is
  the true-canonical-minimizer throughput path.

See SURVEY.md at the repo root for the full structural analysis of the
reference and the layer-by-layer design mapping.
"""

__version__ = "0.1.0"

from genome_assembly_tpu.config import PipelineConfig

__all__ = ["PipelineConfig", "__version__"]
