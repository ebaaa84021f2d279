"""Aux subsystems: checkpoint roundtrip, metrics, CLI, plots."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.io import reads as reads_io
from genome_assembly_tpu.models.pipeline import CountPipeline
from genome_assembly_tpu.utils import checkpoint as ckpt
from genome_assembly_tpu.utils.metrics import MetricsLogger

REPO = pathlib.Path(__file__).parent.parent


def test_checkpoint_roundtrip(tmp_path):
    cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
    reads = ["ACGTACGTTGCA", "TTGCAACGTACG", "ACGTACGTTGCA"]
    counted, _ = CountPipeline(cfg).count_reads(reads)
    path = tmp_path / "table.npz"
    ckpt.save_counted_table(str(path), counted, cfg, phase="post-count")
    table, cfg2, phase = ckpt.load_counted_table(str(path))
    assert phase == "post-count"
    assert cfg2 == cfg
    for name in table._fields:
        assert np.array_equal(
            np.asarray(getattr(table, name)), np.asarray(getattr(counted, name))
        ), name


def test_metrics_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    with open(path, "w") as f:
        log = MetricsLogger(f, run_id="t")
        with log.phase("count", k=31) as extra:
            extra["entries"] = 42
        log.emit("done", ok=True)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["event"] == "count"
    assert recs[0]["entries"] == 42
    assert recs[0]["k"] == 31
    assert "wall_s" in recs[0]
    assert recs[1]["event"] == "done"


def test_cli_parity_matches_golden(tmp_path, reference_file):
    import os

    env = dict(os.environ)
    # hermetic: the subprocess imports this checkout and stays on the CPU
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "genome_assembly_tpu",
            "assemble",
            reference_file("input.txt"),
            "--k",
            "6",
            "--m",
            "3",
            "--max-read-len",
            "32",
            "--cpu",
            "--metrics",
            str(tmp_path / "m.jsonl"),
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    golden = (REPO / "tests/golden/input_k6m3_unitigs.txt").read_text()
    assert out.stdout == golden
    recs = [json.loads(l) for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0]["event"] == "assemble"


def test_resumable_counting_matches_direct(tmp_path):
    """Elasticity: per-batch tables checkpoint + reload + merge == direct.

    Models host-failure recovery (SURVEY.md 5.3): a restarted job re-counts
    only batches whose checkpoints are missing, then merges idempotently.
    """
    import jax.numpy as jnp

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import minimizer
    from genome_assembly_tpu.parity import table as table_ops

    k, m, cutoff = 6, 3, 1
    _, reads, _ = datagen.generate_coverage_reads(500, 32, 6, seed=1)
    cfg = PipelineConfig(k=k, m=m, max_read_len=32, batch_reads=16)
    n_win = cfg.max_read_len - k + 1

    # direct
    direct, _ = CountPipeline(cfg).count_reads(reads)
    host = table_ops.extract_groups(direct, pruned=True)
    want = table_ops.decode_table(host, k, m)

    # per-batch with checkpoint round trip
    batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
    batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
    restored = []
    for bi, b in enumerate(batches):
        recs = minimizer.parity_scan(
            jnp.asarray(b.codes), jnp.asarray(b.lengths), k=k, m=m
        )
        part = count_ops.count_and_prune(
            recs,
            jnp.asarray(b.read_ids),
            cutoff=-1,
            stream_offset=bi * cfg.batch_reads * n_win,
        )
        path = tmp_path / f"batch{bi}.npz"
        ckpt.save_counted_table(str(path), part, cfg, phase=f"batch-{bi}")
        loaded, _, _ = ckpt.load_counted_table(str(path))
        restored.append(
            count_ops.CountedTable(
                *[jnp.asarray(getattr(loaded, f)) for f in loaded._fields]
            )
        )
    merged = count_ops.merge_sorted_tables(restored, cutoff=cutoff)
    got = table_ops.decode_table(
        table_ops.extract_groups(merged, pruned=True), k, m
    )
    assert got == want


def test_determinism_same_input_same_output():
    """Race-detection stand-in (SURVEY.md 5.2): identical inputs produce
    bit-identical device outputs across runs and batch splits."""
    from genome_assembly_tpu.io import datagen
    from genome_assembly_tpu.models.pipeline import FastAssembler

    _, reads, _ = datagen.generate_coverage_reads(400, 40, 6, seed=9)
    cfg = PipelineConfig(k=11, m=5, parity=False, max_read_len=64, batch_reads=64)
    u1, s1 = FastAssembler(cfg).unitigs(reads)
    u2, s2 = FastAssembler(cfg).unitigs(reads)
    assert u1 == u2
    cfg_split = PipelineConfig(
        k=11, m=5, parity=False, max_read_len=64, batch_reads=16
    )
    u3, _ = FastAssembler(cfg_split).unitigs(reads)
    assert sorted(u1) == sorted(u3)


def test_parse_verbose_output_roundtrip():
    from genome_assembly_tpu.utils.plots import parse_verbose_output

    text = (REPO / "tests/golden/input_k6m3_verbose.txt").read_text()
    bin_counts, unitigs = parse_verbose_output(text)
    assert sum(bin_counts.values()) == 61  # post-extension entries
    for key, per_bp in unitigs:
        assert len(per_bp) == len(key)
        for ids in per_bp:
            assert ids == sorted(ids, reverse=True) or ids == sorted(ids)


def test_plots_render(tmp_path):
    from genome_assembly_tpu.utils import plots

    plots.plot_reads([0, 5, 10], 50, 20, str(tmp_path / "reads.png"))
    plots.plot_mmer_bins({"ACG": 5, "CCA": 2}, str(tmp_path / "mmers.png"))
    plots.plot_unitig_placement(
        ["ACGTACG", "TTTTTTT"], "GGACGTACGGG", str(tmp_path / "kmers.png")
    )
    for name in ("reads.png", "mmers.png", "kmers.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_device_feeder_order_and_errors():
    """DeviceFeeder preserves order, bounds staging, and surfaces worker
    exceptions at the consumer (streaming executor, SURVEY.md 2.2 PP row)."""
    from genome_assembly_tpu.io.stream import DeviceFeeder

    out = list(DeviceFeeder(range(10), lambda x: x * 2, depth=2))
    assert out == [x * 2 for x in range(10)]

    def boom(x):
        if x == 3:
            raise ValueError("staged failure")
        return x

    import pytest as _pytest

    with _pytest.raises(ValueError, match="staged failure"):
        list(DeviceFeeder(range(5), boom, depth=2))


def test_device_feeder_abandoned_consumer_stops_worker():
    """close() unblocks a worker stuck on a full queue (the consumer
    raised mid-loop) so abandoned feeders don't leak threads + staged
    batches."""
    import time

    from genome_assembly_tpu.io.stream import DeviceFeeder

    feeder = DeviceFeeder(range(1000), lambda x: x, depth=2)
    it = iter(feeder)
    next(it)  # consume one, then abandon (simulates a raising consumer)
    feeder.close()
    deadline = time.time() + 5.0
    while feeder._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not feeder._thread.is_alive()

    # context-manager form: leaving the block mid-iteration also stops it
    with DeviceFeeder(range(1000), lambda x: x, depth=2) as f2:
        next(iter(f2))
    deadline = time.time() + 5.0
    while f2._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not f2._thread.is_alive()


def test_placement_by_read_ids_places_fragments():
    """Read-id-based placement: a unitig that
    exists nowhere in the genome as a whole string still places its
    read-supported fragments through the per-BP read-id lists, and a
    reverse-complement part maps back to forward coordinates."""
    import numpy as np

    from genome_assembly_tpu.utils import plots

    genome = "ACGTACGGTTACCAGTTGCA"
    read_len = 8
    starts = [0, 10]  # read 0: ACGTACGG, read 1: ACCAGTTG
    # a chimeric "unitig": read 0's prefix + an X + read 1's core -- whole
    # string matches nowhere, fragments match inside their reads' windows
    key = "CGTACXCCAGT"
    per_bp = (
        [[0]] * 5          # CGTAC from read 0
        + [[]]             # X supported by nobody
        + [[1]] * 5        # CCAGT from read 1
    )
    m = plots.placement_matrix_by_read_ids(
        [(key, per_bp)], starts, genome, read_len
    )
    want = np.zeros((1, len(genome)), dtype=int)
    want[0, 1:6] = 1    # CGTAC at genome[1:6]
    want[0, 11:16] = 1  # CCAGT at genome[11:16] (read 1's window offset 1)
    assert np.array_equal(m, want)
    # exact-search placement fails silently on the same unitig: empty row
    import tempfile, pathlib
    # (matrix form of the old behavior)
    assert genome.find(key) < 0

    # reverse-complement fragment: read 0 window holds ACGTACGG; the
    # unitig carries its RC CCGTACGT on read 0
    key2 = "CCGTACGT"
    m2 = plots.placement_matrix_by_read_ids(
        [(key2, [[0]] * len(key2))], starts, genome, read_len
    )
    want2 = np.zeros((1, len(genome)), dtype=int)
    want2[0, 0:8] = 1
    assert np.array_equal(m2, want2)


def test_plot_by_read_ids_cli(tmp_path):
    """End-to-end: generate --starts-out -> parity verbose dump -> plot
    --starts-file renders a read-id-placed kmers.png."""
    import subprocess
    import sys as _sys

    env = {"PATH": "/usr/bin:/bin", "HOME": "/root"}
    out = tmp_path / "r.txt"
    genome_f = tmp_path / "g.txt"
    starts_f = tmp_path / "s.txt"
    run = [
        _sys.executable, "-m", "genome_assembly_tpu", "generate",
        "--genome-len", "300", "--coverage", "6", "--read-len", "32",
        "--seed", "7", "--out", str(out), "--genome-out", str(genome_f),
        "--starts-out", str(starts_f),
    ]
    r = subprocess.run(run, cwd=str(REPO), env=env, capture_output=True)
    assert r.returncode == 0, r.stderr[-1500:]
    verbose = tmp_path / "v.txt"
    r = subprocess.run(
        [_sys.executable, "-m", "genome_assembly_tpu", "assemble", str(out),
         "--k", "8", "--m", "4", "--cpu", "--verbose"],
        cwd=str(REPO), env=env, capture_output=True,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    verbose.write_bytes(r.stdout)
    r = subprocess.run(
        [_sys.executable, "-m", "genome_assembly_tpu", "plot", str(verbose),
         "--genome-file", str(genome_f), "--starts-file", str(starts_f),
         "--read-len", "32", "--outdir", str(tmp_path / "plots")],
        cwd=str(REPO), env=env, capture_output=True,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert (tmp_path / "plots/kmers.png").stat().st_size > 0


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that is the cache, and enabling the
    cache sets no other directory (JAX reads the variable itself)."""
    import jax

    from genome_assembly_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert cache.cache_dir() == tmp_path


def test_compile_cache_fallback_is_one_fixed_path_in_checkout(monkeypatch):
    import jax

    from genome_assembly_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert cache.cache_dir() == REPO / ".jax_cache"


def test_compile_cache_fallback_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
