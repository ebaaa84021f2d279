"""Command-line driver.

The reference's CLI is ``./a.out <reads-file>`` -> unitigs on stdout with
K/M/cutoff baked in at compile time (binning.c:10-13, 1147-1181).  Here all
of it is runtime config, plus the subsystems the reference lacks: metrics,
tracing, checkpoints, plots, a data generator, and mode selection.

  python -m genome_assembly_tpu assemble reads.txt            # parity mode
  python -m genome_assembly_tpu assemble reads.txt --mode fast --k 21 --m 7
  python -m genome_assembly_tpu count reads.txt --checkpoint out.npz
  python -m genome_assembly_tpu generate --genome-len 100000 --coverage 30
  python -m genome_assembly_tpu bench-scaling --devices 8
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_pipeline_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--k", type=int, default=31, help="k-mer size (<=31)")
    ap.add_argument("--m", type=int, default=4, help="minimizer size (<=15)")
    ap.add_argument("--cutoff", type=int, default=1, help="abundance cutoff")
    ap.add_argument(
        "--mode",
        choices=["parity", "fast"],
        default="parity",
        help="parity: bit-exact reference replication; fast: canonical-k-mer throughput path",
    )
    ap.add_argument("--read-length", type=int, default=101,
                    help="parity-mode fgets buffer size (reference READ_LENGTH)")
    ap.add_argument("--max-read-len", type=int, default=128)
    ap.add_argument("--batch-reads", type=int, default=16384)
    ap.add_argument("--metrics", default=None, help="append JSONL metrics here")
    ap.add_argument("--trace", default=None, help="capture a jax profiler trace")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument(
        "--outofcore-gb",
        type=float,
        default=3.0,
        help="fast mode: record gigabytes above which counting switches to "
        "hash-partitioned multi-pass (out-of-core) passes",
    )


def _make_config(args):
    from genome_assembly_tpu.config import PipelineConfig

    return PipelineConfig(
        k=args.k,
        m=args.m,
        abundance_cutoff=args.cutoff,
        read_length=args.read_length,
        parity=args.mode == "parity",
        batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        outofcore_bytes=int(args.outofcore_gb * (1 << 30)),
    )


def _setup_backend(args) -> None:
    from genome_assembly_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")


def cmd_assemble(args) -> int:
    from genome_assembly_tpu.models.pipeline import FastAssembler, ParityAssembler
    from genome_assembly_tpu.utils.metrics import open_metrics
    from genome_assembly_tpu.utils.profiling import maybe_trace

    _setup_backend(args)
    cfg = _make_config(args)
    log = open_metrics(args.metrics, run_id=f"assemble-{int(time.time())}")
    with maybe_trace(args.trace):
        if cfg.parity:
            asm = ParityAssembler(cfg)
            reads = asm.load(args.reads_file)
            with log.phase("assemble", mode="parity", k=cfg.k, m=cfg.m) as extra:
                if args.verbose_output:
                    text, stats = asm.assemble(reads, verbose=True)
                    sys.stdout.write(text)
                else:
                    lines, stats = asm.assemble(reads)
                    sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
                extra["entries_pre_prune"] = stats.entries_pre_prune
                extra["n_reads"] = stats.n_reads
                extra["n_windows"] = stats.n_windows
        else:
            asm = FastAssembler(cfg)
            with log.phase("assemble", mode="fast", k=cfg.k, m=cfg.m) as extra:
                if args.fasta:
                    from genome_assembly_tpu.io.reads import load_fasta

                    seqs = load_fasta(args.reads_file)
                    if getattr(args, "coverage", False):
                        # long sequences chunked exactly as unitigs_from_sequences
                        from genome_assembly_tpu.io import reads as reads_io

                        chunks = []
                        for s in seqs:
                            if len(s) <= cfg.max_read_len:
                                chunks.append(s)
                            else:
                                chunks.extend(
                                    reads_io.chunk_long_sequence(
                                        s, cfg.max_read_len, cfg.k
                                    )
                                )
                        unitigs, occ, nk, stats = asm.unitigs_with_coverage(chunks)
                    else:
                        unitigs, stats = asm.unitigs_from_sequences(seqs)
                elif getattr(args, "coverage", False):
                    reads = asm.load(args.reads_file)
                    unitigs, occ, nk, stats = asm.unitigs_with_coverage(reads)
                else:
                    reads = asm.load(args.reads_file)
                    unitigs, stats = asm.unitigs(reads)
                if getattr(args, "coverage", False):
                    lines = [
                        f"{u}\t{int(n)}\t{s / n:.3f}"
                        for u, s, n in zip(unitigs, occ, nk)
                    ]
                else:
                    lines = unitigs
                sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
                extra["entries_post_prune"] = stats.entries_post_prune
                extra["n_unitigs"] = stats.entries_post_extension
                extra["n_windows"] = stats.n_windows
    return 0


def cmd_count(args) -> int:
    """Count + prune only; optionally checkpoint the table."""
    import numpy as np

    from genome_assembly_tpu.models.pipeline import CountPipeline, FastAssembler, ParityAssembler
    from genome_assembly_tpu.utils.checkpoint import save_counted_table
    from genome_assembly_tpu.utils.metrics import open_metrics

    _setup_backend(args)
    cfg = _make_config(args)
    log = open_metrics(args.metrics, run_id=f"count-{int(time.time())}")
    loader = ParityAssembler(cfg) if cfg.parity else FastAssembler(cfg)
    reads = loader.load(args.reads_file)
    pipeline = CountPipeline(cfg)
    with log.phase("count", k=cfg.k, m=cfg.m) as extra:
        counted, stats = pipeline.count_reads(reads)
        extra["n_reads"] = stats.n_reads
        extra["n_windows"] = stats.n_windows
        extra["entries_pre_prune"] = stats.entries_pre_prune
        extra["entries_post_prune"] = stats.entries_post_prune
    if args.checkpoint:
        save_counted_table(args.checkpoint, counted, cfg, phase="post-count")
        print(f"checkpoint written: {args.checkpoint}", file=sys.stderr)
    print(
        f"entries: {stats.entries_pre_prune} -> {stats.entries_post_prune} "
        f"({stats.n_windows} windows from {stats.n_reads} reads)",
        file=sys.stderr,
    )
    return 0


def cmd_generate(args) -> int:
    from genome_assembly_tpu.io import datagen

    if args.triangular:
        genome, starts = datagen.generate_reads(
            genome_len=args.genome_len,
            read_len=args.read_len,
            read_num=args.read_num,
            seed=args.seed,
        )
        reads = datagen.reads_from_starts(genome, starts, args.read_len)
    else:
        genome, reads, starts = datagen.generate_coverage_reads(
            genome_len=args.genome_len,
            read_len=args.read_len,
            coverage=args.coverage,
            seed=args.seed,
            error_rate=args.error_rate,
            with_reverse=args.with_reverse,
        )
    datagen.write_reads(reads, args.out)
    if args.genome_out:
        with open(args.genome_out, "w") as f:
            f.write(genome + "\n")
    if args.starts_out:
        with open(args.starts_out, "w") as f:
            f.write("\n".join(str(int(s)) for s in starts) + "\n")
    if args.plot:
        from genome_assembly_tpu.utils.plots import plot_reads

        plot_reads(starts, len(genome), args.read_len, args.plot)
    print(f"{len(reads)} reads -> {args.out}", file=sys.stderr)
    return 0


def cmd_plot(args) -> int:
    """Visual validation plots from a verbose (print_kmer_read_ids) dump --
    the continuation of the reference harness's plot_unitigs flow."""
    import pathlib

    from genome_assembly_tpu.utils import plots

    text = pathlib.Path(args.unitigs_file).read_text()
    bin_counts, unitigs = plots.parse_verbose_output(text)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    plots.plot_mmer_bins(bin_counts, str(outdir / "mmers.png"))
    if args.genome_file:
        genome = pathlib.Path(args.genome_file).read_text().strip()
        if args.starts_file:
            starts = [
                int(line)
                for line in pathlib.Path(args.starts_file).read_text().split()
            ]
            plots.plot_unitig_placement_by_read_ids(
                unitigs, starts, genome, args.read_len,
                str(outdir / "kmers.png"),
            )
        else:
            plots.plot_unitig_placement(
                [u for u, _ in unitigs], genome, str(outdir / "kmers.png")
            )
    print(
        f"{sum(bin_counts.values())} unitigs in {len(bin_counts)} bins -> "
        f"{outdir}",
        file=sys.stderr,
    )
    return 0


def cmd_bench_scaling(args) -> int:
    """Shard-scaling benchmark on virtual CPU devices (or a real slice)."""
    import os

    if args.cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
    import json

    import jax

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count

    rng = np.random.default_rng(0)
    rows = args.batch_reads
    codes = jnp.asarray(rng.integers(0, 4, size=(rows, 128), dtype=np.uint8))
    lengths = jnp.full((rows,), 128, dtype=jnp.int32)
    read_ids = jnp.arange(rows, dtype=jnp.uint32)
    results = []
    n = 1
    while n <= min(args.devices, jax.device_count()):
        if args.routing == "two_level" and n >= 2:
            from jax.sharding import Mesh

            from genome_assembly_tpu.parallel import two_level

            devs = np.array(jax.devices()[:n]).reshape(2, n // 2)
            mesh = Mesh(devs, (two_level.SLICE_AXIS, two_level.SHARD_AXIS))
            routing = "two_level"
        else:
            mesh = mesh_lib.make_mesh(n)
            routing = args.routing if n > 1 else "padded"
        t_best = None
        for _ in range(3):
            t0 = time.perf_counter()
            sc = shard_count.sharded_count(
                codes, lengths, read_ids, k=args.k, m=args.m,
                parity=False, cutoff=1, mesh=mesh, routing=routing,
            )
            jax.block_until_ready(sc.count)
            dt = time.perf_counter() - t0
            t_best = dt if t_best is None else min(t_best, dt)
        windows = rows * (128 - args.k + 1)
        results.append({"shards": n, "wall_s": round(t_best, 4),
                        "windows_per_s": round(windows / t_best, 1)})
        n *= 2
    base = results[0]["windows_per_s"]
    for r in results:
        r["scaling_eff"] = round(r["windows_per_s"] / (base * r["shards"]), 3)
        print(json.dumps(r))
    if args.cpu_devices:
        print(
            "note: virtual CPU devices share the host cores, so efficiency "
            "saturates at the physical core count; run on a real slice for "
            "true scaling numbers",
            file=sys.stderr,
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genome_assembly_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("assemble", help="full pipeline -> unitigs on stdout")
    a.add_argument("reads_file")
    a.add_argument("--verbose-output", action="store_true",
                   help="print_kmer_read_ids format (parity mode)")
    a.add_argument("--fasta", action="store_true",
                   help="fast mode: treat input as FASTA (multi-line records, "
                        "long sequences chunked with k-1 overlap)")
    a.add_argument("--coverage", action="store_true",
                   help="fast mode: emit TSV unitig<TAB>n_kmers<TAB>mean_cov "
                        "(per-unitig mean k-mer occurrence count)")
    _add_pipeline_args(a)
    a.set_defaults(fn=cmd_assemble)

    c = sub.add_parser("count", help="count+prune only, optional checkpoint")
    c.add_argument("reads_file")
    c.add_argument("--checkpoint", default=None)
    _add_pipeline_args(c)
    c.set_defaults(fn=cmd_count)

    g = sub.add_parser("generate", help="synthetic read sets")
    g.add_argument("--out", default="reads.txt")
    g.add_argument("--genome-out", default=None)
    g.add_argument("--genome-len", type=int, default=500)
    g.add_argument("--read-len", type=int, default=30)
    g.add_argument("--read-num", type=int, default=20)
    g.add_argument("--coverage", type=float, default=10.0)
    g.add_argument("--error-rate", type=float, default=0.0)
    g.add_argument("--seed", type=int, default=20)
    g.add_argument("--with-reverse", action="store_true")
    g.add_argument("--triangular", action="store_true",
                   help="reference-style triangular random walk positions")
    g.add_argument("--plot", default=None, help="write read-coverage bitmap PNG")
    g.add_argument("--starts-out", default=None,
                   help="write read start positions (one per line; read id "
                   "= line number) for read-id-based placement plots")
    g.set_defaults(fn=cmd_generate)

    p = sub.add_parser("plot", help="validation plots from verbose output")
    p.add_argument("unitigs_file")
    p.add_argument("--genome-file", default=None)
    p.add_argument("--starts-file", default=None,
                   help="read start positions (generate --starts-out); "
                   "switches kmers.png to read-id-based placement (the "
                   "reference plot_unitigs flow) instead of exact search")
    p.add_argument("--read-len", type=int, default=100,
                   help="read length for --starts-file placement windows")
    p.add_argument("--outdir", default="plots")
    p.set_defaults(fn=cmd_plot)

    b = sub.add_parser("bench-scaling", help="shard-count scaling benchmark")
    b.add_argument("--devices", type=int, default=8)
    b.add_argument("--cpu-devices", action="store_true",
                   help="simulate devices on CPU")
    b.add_argument("--batch-reads", type=int, default=4096)
    b.add_argument("--k", type=int, default=21)
    b.add_argument("--m", type=int, default=7)
    b.add_argument("--routing", choices=["padded", "ragged", "two_level"],
                   default="padded",
                   help="record-exchange layout (two_level = DCN-aware "
                   "2-slice hierarchical routing)")
    b.set_defaults(fn=cmd_bench_scaling)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
