"""The genome-scale runner end-to-end on CPU (small preset).

Drives tools/run_scale.py as a subprocess -- the same tool the on-device scale
runs use -- and checks the pipeline invariants: distinct k-mers,
kept k-mers, and the out-of-core path agreeing with in-core exactly.
"""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(*extra):
    out = subprocess.run(
        [sys.executable, str(REPO / "tools/run_scale.py"), "--preset", "small",
         "--cpu", *extra],
        capture_output=True,
        timeout=600,
        text=True,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    events = {}
    for line in out.stdout.splitlines():
        try:
            e = json.loads(line)
        except json.JSONDecodeError:
            continue
        events[e["event"]] = e
    return events


def _count_event(events):
    """In-core runs emit 'count'; out-of-core runs emit the combined
    'scan_and_count' (interleaved passes make a split timing meaningless --
    see tools/run_scale.py)."""
    return events.get("count") or events["scan_and_count"]


@pytest.mark.slow
def test_small_preset_in_core_vs_out_of_core():
    a = _run("--partitions", "1")
    b = _run("--partitions", "4")
    for ev in (a, b):
        assert _count_event(ev)["distinct"] == 199961
        assert _count_event(ev)["kept"] == 199914
        assert ev["extension"]["linear_unitigs"] == 10
        assert ev["extension"]["cyclic_states"] == 0
    assert (
        a["extension"]["longest_chain"] == b["extension"]["longest_chain"]
    )


@pytest.mark.slow
def test_small_preset_virtual_genome_matches_across_layouts():
    """--virtual-genome derives reads from (seed, position) with the
    counter hash (ops/vgenome.py): no genome materialization.  The
    dataset differs from the materialized-genome one (different PRNG),
    but all pipeline invariants must hold and the in-core and
    out-of-core+scan-chunk layouts must agree exactly on it."""
    a = _run("--partitions", "1", "--virtual-genome")
    b = _run("--partitions", "4", "--virtual-genome", "--scan-chunk", "3")
    ca, cb = _count_event(a), _count_event(b)
    assert ca["distinct"] == cb["distinct"] > 190000
    assert ca["kept"] == cb["kept"]
    assert (
        a["extension"]["linear_unitigs"] == b["extension"]["linear_unitigs"]
    )
    assert a["genome"].get("virtual") is True


@pytest.mark.slow
def test_small_preset_partitioned_ext_modes_match_bulk():
    """--ext-mode part/wide (the distributed dBG on a one-device mesh)
    produce exactly the bulk engine's graph stats -- the CPU rehearsal
    of the same runs on the device."""
    bulk = _run("--partitions", "1")
    part = _run("--partitions", "1", "--ext-mode", "part")
    wide = _run("--partitions", "1", "--ext-mode", "wide")
    for ev in (part, wide):
        assert ev["links"]["overflow"] == 0
        assert ev["jump"]["overflow"] == 0
        assert (
            ev["extension"]["linear_unitigs"]
            == bulk["extension"]["linear_unitigs"]
        )
        assert (
            ev["extension"]["cyclic_states"]
            == bulk["extension"]["cyclic_states"]
        )
        assert (
            ev["extension"]["longest_chain"]
            == bulk["extension"]["longest_chain"]
        )


@pytest.mark.slow
def test_scale_runner_part_range_division(tmp_path):
    """Two --part-range workers + a rangeless merge reproduce the plain
    out-of-core run's counts through the CLI surface."""
    import subprocess

    ck = str(tmp_path / "shared")
    base = [
        sys.executable, str(REPO / "tools/run_scale.py"), "--preset",
        "small", "--cpu", "--partitions", "4", "--count-only",
        "--checkpoint-dir", ck,
    ]
    w1 = subprocess.run(
        base + ["--part-range", "0:2"], capture_output=True, text=True,
        timeout=600,
    )
    assert w1.returncode == 0, w1.stdout[-2000:] + w1.stderr[-2000:]
    w2 = subprocess.run(
        base + ["--part-range", "2:4"], capture_output=True, text=True,
        timeout=600,
    )
    assert w2.returncode == 0, w2.stdout[-2000:] + w2.stderr[-2000:]
    merged = subprocess.run(base, capture_output=True, text=True, timeout=600)
    assert merged.returncode == 0, merged.stdout[-2000:] + merged.stderr[-2000:]
    fresh = subprocess.run(
        base[:-2], capture_output=True, text=True, timeout=600
    )
    assert fresh.returncode == 0

    def count_event(out):
        for line in out.splitlines():
            if '"scan_and_count"' in line:
                return json.loads(line)
        raise AssertionError("no scan_and_count event:\n" + out[-2000:])

    ev_m, ev_f = count_event(merged.stdout), count_event(fresh.stdout)
    assert ev_m["distinct"] == ev_f["distinct"]
    assert ev_m["kept"] == ev_f["kept"]


@pytest.mark.slow
def test_small_preset_materialize_artifact():
    """--materialize emits an artifact whose arithmetic closes exactly:
    every kept k-mer appears in exactly one unitig once, so total_bp =
    kept + unitigs*(k-1) and longest_bp = longest_chain + (k-1) (no
    cycles in the small preset).  This is the invariant the chr1 run
    demonstrated at 250 Mbp."""
    ev = _run("--partitions", "1", "--materialize")
    k = ev["config"]["k"]
    kept = _count_event(ev)["kept"]
    m = ev["materialize"]
    assert ev["extension"]["cyclic_states"] == 0
    assert m["unitigs"] == ev["extension"]["linear_unitigs"]
    assert m["total_bp"] == kept + m["unitigs"] * (k - 1)
    assert m["longest_bp"] == ev["extension"]["longest_chain"] + (k - 1)


def _run_scale_module():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools import run_scale

    return run_scale


def test_run_scale_has_no_backend_escape(monkeypatch):
    """The extension runs where the count ran (nothing asks JAX for the CPU
    backend's devices to move work there), and run() returns the counts
    and, with keep_arrays, the host arrays they describe."""
    import jax
    import numpy as np

    asked = []
    real = jax.local_devices

    def spy(*a, **kw):
        asked.append(kw.get("backend"))
        return real(*a, **kw)

    monkeypatch.setattr(jax, "local_devices", spy)
    res = _run_scale_module().run(
        ["--preset", "small", "--partitions", "1"], keep_arrays=True
    )
    assert "cpu" not in asked
    assert res["rc"] == 0 and res["overflow"] == 0
    assert res["n_kept"] == int(np.sum(res["valid"])) == 199914
    assert res["graph"].head.shape == (2 * res["khi"].shape[0],)
    assert res["unitigs"] is None  # no --materialize


@pytest.mark.parametrize("fault", ["extension", "stats"])
def test_run_scale_errors_propagate(monkeypatch, fault):
    """A failing extension or graph-stats step raises out of run() -- no
    retry, no -1 placeholder stats."""
    from genome_assembly_tpu.ops import dbg

    real = dbg.pointer_jump

    def broken(links):
        if fault == "extension":
            raise RuntimeError("injected extension fault")
        graph = real(links)
        return graph._replace(head=graph.head[:-1])  # stats cannot run

    monkeypatch.setattr(dbg, "pointer_jump", broken)
    with pytest.raises((RuntimeError, TypeError, ValueError)):
        _run_scale_module().run(
            ["--preset", "small", "--cpu", "--partitions", "1"]
        )
