"""Full big.txt-configuration parity soak (standalone; ~10+ min of oracle
wall time on slow VMs, so not part of the test suite).

Reproduces BASELINE.md's big-run shape -- 100 kb genome, 50x coverage,
50,000 x 100 bp reads, K=31/M=4 -- and diffs our parity pipeline's unitig
output (exact line order) against a live run of the reference binary.

--dirty: the same scale with all three quirk systems
composed -- ~1% of lines carry non-ACGT bytes (N / lowercase / stray
letters, binning.c:107-109), ~5% of lines are 200 bp so the fgets
truncation quirk splits them (binning.c:1154-1166), and the pipeline is
forced through the out-of-core 5-lane parity count (with_streams regroup,
ops/outofcore.py).  No golden has ever seen this fixture; the oracle runs
live.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _dirtify(reads, seed):
    """~5% of lines become 200-bp joins of read pairs; ~1% of the result
    gets a non-ACGT byte (N, lowercase base, lowercase run, stray 'X')."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = []
    i = 0
    while i < len(reads):
        if rng.random() < 0.05 and i + 1 < len(reads):
            lines.append(reads[i] + reads[i + 1])  # 200 bp: fgets splits
            i += 2
        else:
            lines.append(reads[i])
            i += 1
    n_dirty = 0
    for j in range(len(lines)):
        if rng.random() >= 0.01:
            continue
        ln, pos = lines[j], int(rng.integers(0, len(lines[j])))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            ln = ln[:pos] + "N" + ln[pos + 1 :]
        elif kind == 1:
            ln = ln[:pos] + ln[pos].lower() + ln[pos + 1 :]
        elif kind == 2:
            end = min(len(ln), pos + 10)
            ln = ln[:pos] + ln[pos:end].lower() + ln[end:]
        else:
            ln = ln[:pos] + "X" + ln[pos + 1 :]
        lines[j] = ln
        n_dirty += 1
    return lines, n_dirty


def main() -> int:
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from genome_assembly_tpu.config import PipelineConfig
    from genome_assembly_tpu.io import datagen
    from genome_assembly_tpu.models.pipeline import ParityAssembler
    from tools import oracle

    dirty = "--dirty" in sys.argv

    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=100_000, read_len=100, coverage=50, seed=7
    )
    print(f"{len(reads)} reads generated", flush=True)
    with tempfile.TemporaryDirectory() as td:
        reads_file = pathlib.Path(td) / "big.txt"
        if dirty:
            lines, n_dirty = _dirtify(reads, seed=13)
            reads_file.write_text("".join(l + "\n" for l in lines))
            n_long = sum(len(l) > 100 for l in lines)
            print(
                f"dirty fixture: {len(lines)} lines, {n_dirty} with "
                f"non-ACGT bytes, {n_long} past the fgets limit",
                flush=True,
            )
        else:
            datagen.write_reads(reads, str(reads_file))

        t0 = time.time()
        binary = oracle.build_oracle(pathlib.Path("/tmp/oracle_build"), k=31, m=4)
        want = oracle.run_oracle(binary, reads_file, "unitigs").splitlines()
        print(f"oracle: {len(want)} unitigs in {time.time()-t0:.0f}s", flush=True)

        cfg = PipelineConfig(
            k=31, m=4, max_read_len=128, batch_reads=32768,
            # dirty: force the out-of-core 5-lane count at this scale
            **({"outofcore_bytes": 64 << 20} if dirty else {}),
        )
        asm = ParityAssembler(cfg)
        parsed = asm.load(str(reads_file))
        if dirty:
            from genome_assembly_tpu.parity import nonacgt

            assert asm._needs_outofcore(parsed), "fixture must force ooc"
            assert nonacgt.has_non_acgt(parsed), "fixture must be dirty"
            print(
                f"{len(parsed)} parsed reads, "
                f"{len(nonacgt.dirty_read_ids(parsed))} dirty", flush=True,
            )
        t0 = time.time()
        lines, stats = asm.assemble(parsed, engine="native")
        print(
            f"ours: {len(lines)} unitigs in {time.time()-t0:.0f}s "
            f"(pre-prune {stats.entries_pre_prune})",
            flush=True,
        )
        if lines == want:
            print("PARITY: exact (order included)")
            return 0
        same_set = sorted(lines) == sorted(want)
        print(f"MISMATCH: multiset equal={same_set}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
