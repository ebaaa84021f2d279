"""Kill-and-resume fault injection (SURVEY.md section 5.3/5.4).

The reference exits on any failure (zhash.c:230-249); this engine's
elasticity model is idempotent re-runnable passes + fingerprinted
checkpoints.  These tests actually interrupt work mid-flight -- an
in-process exception mid-doubling-round for the extension frontier, and a
SIGKILLed subprocess mid-partition for the out-of-core count -- then
resume and assert bit-equality with uninterrupted runs.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from genome_assembly_tpu.ops import dbg

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chain_links(n_nodes, rng):
    """A plausible next_state array: disjoint chains over 2*n states."""
    next_state = np.full(2 * n_nodes, -1, dtype=np.int32)
    perm = rng.permutation(n_nodes)
    # string nodes into chains of ~64 on strand 0, mirrored on strand 1
    for i in range(len(perm) - 1):
        if i % 64 != 63:
            a, b = perm[i], perm[i + 1]
            next_state[2 * a] = 2 * b
            next_state[2 * b + 1] = 2 * a + 1
    return next_state


def test_jump_frontier_kill_and_resume(tmp_path, monkeypatch):
    """Die mid-doubling-round; resume must be bit-identical."""
    rng = np.random.default_rng(7)
    links = _chain_links(4096, rng)
    baseline = dbg.pointer_jump_bulk(links.copy())

    class Die(RuntimeError):
        pass

    real_round = dbg._jump_round
    calls = {"n": 0}

    def dying_round(tbl):
        calls["n"] += 1
        if calls["n"] > 3:
            raise Die("injected failure")
        return real_round(tbl)

    ckdir = str(tmp_path / "jump")
    monkeypatch.setattr(dbg, "_jump_round", dying_round)
    with pytest.raises(Die):
        dbg.pointer_jump_bulk(
            links.copy(), checkpoint_dir=ckdir, checkpoint_every=1
        )
    monkeypatch.setattr(dbg, "_jump_round", real_round)

    # a frontier checkpoint must exist from the killed run
    assert (tmp_path / "jump" / "frontier_l2.npz").exists()

    # resume: _jump_init must NOT run (the frontier is loaded instead)
    real_init = dbg._jump_init
    init_calls = {"n": 0}

    def counting_init(ns, lanes=2):
        init_calls["n"] += 1
        return real_init(ns, lanes)

    monkeypatch.setattr(dbg, "_jump_init", counting_init)
    resumed = dbg.pointer_jump_bulk(
        links.copy(), checkpoint_dir=ckdir, checkpoint_every=1
    )
    assert init_calls["n"] == 0, "resume re-initialized instead of loading"

    np.testing.assert_array_equal(np.asarray(resumed.head),
                                  np.asarray(baseline.head))
    np.testing.assert_array_equal(np.asarray(resumed.rank),
                                  np.asarray(baseline.rank))
    np.testing.assert_array_equal(np.asarray(resumed.is_cycle),
                                  np.asarray(baseline.is_cycle))


def test_jump_frontier_fingerprint_mismatch(tmp_path):
    """A frontier from a DIFFERENT graph must be ignored, not loaded."""
    rng = np.random.default_rng(11)
    links_a = _chain_links(2048, rng)
    links_b = _chain_links(2048, rng)  # different draw
    assert not np.array_equal(links_a, links_b)
    ckdir = str(tmp_path / "jump")
    dbg.pointer_jump_bulk(links_a, checkpoint_dir=ckdir, checkpoint_every=1)
    got = dbg.pointer_jump_bulk(links_b, checkpoint_dir=ckdir,
                                checkpoint_every=1)
    want = dbg.pointer_jump_bulk(links_b)
    np.testing.assert_array_equal(np.asarray(got.head), np.asarray(want.head))
    np.testing.assert_array_equal(np.asarray(got.rank), np.asarray(want.rank))


def test_jump_frontier_with_cycles(tmp_path):
    """The 3-lane cycle rerun checkpoints independently of the 2-lane run."""
    n = 512
    next_state = np.full(2 * n, -1, dtype=np.int32)
    # one 8-cycle on strand 0 plus a chain
    cyc = [2 * i for i in range(8)]
    for i in range(8):
        next_state[cyc[i]] = cyc[(i + 1) % 8]
    for i in range(10, 60):
        next_state[2 * i] = 2 * (i + 1)
    baseline = dbg.pointer_jump_bulk(next_state.copy())
    ckdir = str(tmp_path / "jump")
    got = dbg.pointer_jump_bulk(
        next_state.copy(), checkpoint_dir=ckdir, checkpoint_every=1
    )
    assert (tmp_path / "jump" / "frontier_l3.npz").exists()
    np.testing.assert_array_equal(np.asarray(got.head),
                                  np.asarray(baseline.head))
    np.testing.assert_array_equal(np.asarray(got.is_cycle),
                                  np.asarray(baseline.is_cycle))
    # resuming from the completed frontiers is also exact
    again = dbg.pointer_jump_bulk(
        next_state.copy(), checkpoint_dir=ckdir, checkpoint_every=1
    )
    np.testing.assert_array_equal(np.asarray(again.head),
                                  np.asarray(baseline.head))


def _events(stdout):
    events = {}
    for line in stdout.splitlines():
        try:
            e = json.loads(line)
        except json.JSONDecodeError:
            continue
        events[e["event"]] = e
    return events


@pytest.mark.slow
def test_scale_runner_sigkill_and_resume(tmp_path):
    """SIGKILL an out-of-core count mid-partition; the resumed run must
    produce the exact counts of an uninterrupted run."""
    ckdir = tmp_path / "ck"
    cmd = [
        sys.executable, str(REPO / "tools/run_scale.py"), "--preset", "small",
        "--cpu", "--partitions", "4", "--count-only",
        "--checkpoint-dir", str(ckdir),
    ]
    env = dict(os.environ)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env
    )
    # kill as soon as the first partition checkpoint lands (mid-pass:
    # partitions 1..3 still unwritten)
    deadline = time.time() + 300
    part0 = ckdir / "part_0.npz"
    try:
        while time.time() < deadline:
            if part0.exists():
                break
            if proc.poll() is not None:
                raise AssertionError(
                    "runner exited before first checkpoint: "
                    + proc.stdout.read().decode()[-2000:]
                )
            time.sleep(0.2)
        else:
            raise AssertionError("no checkpoint appeared within 300 s")
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait()
        proc.stdout.close()
    assert part0.exists()
    done_before = {p.name for p in ckdir.glob("part_*.npz")}
    assert len(done_before) < 4, "kill landed after all partitions finished"

    resumed = subprocess.run(
        cmd, capture_output=True, timeout=600, text=True
    )
    assert resumed.returncode == 0, resumed.stdout[-2000:] + resumed.stderr[-2000:]
    fresh = subprocess.run(
        [c for c in cmd if c != "--checkpoint-dir" and c != str(ckdir)],
        capture_output=True, timeout=600, text=True,
    )
    assert fresh.returncode == 0, fresh.stdout[-2000:] + fresh.stderr[-2000:]

    ev_r = _events(resumed.stdout)["scan_and_count"]
    ev_f = _events(fresh.stdout)["scan_and_count"]
    assert ev_r["distinct"] == ev_f["distinct"]
    assert ev_r["kept"] == ev_f["kept"]


def test_multihost_sharded_checkpoint_kill_and_resume(tmp_path):
    """SIGKILL a 2-process gloo distributed count
    mid-run; the per-shard checkpoint + manifest must let a fresh 2-process
    launch resume at the committed batch and finish with the exact result
    of an uninterrupted run."""
    import hashlib
    import json
    import socket
    import subprocess
    import sys as _sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    tool = repo / "tools/run_multihost_ckpt.py"
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    out = tmp_path / "mh.json"

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def launch(env_extra):
        env = {
            "PATH": "/usr/bin:/bin",
            "HOME": "/root",
            "GA_MH_PORT": str(free_port()),
            **env_extra,
        }
        procs = [
            subprocess.Popen(
                [_sys.executable, str(tool), str(pid), "2",
                 str(out if pid == 0 else "/dev/null"), str(ckpt)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0].decode())
            except subprocess.TimeoutExpired:
                p.kill()  # exact child PID: a survivor hung on the dead
                outs.append(p.communicate()[0].decode())  # peer's collective
        return procs, outs

    # run 1: both processes SIGKILL themselves after committing batch 2
    procs, logs = launch({"GA_DIE_AFTER_BATCH": "2"})
    assert all(p.returncode != 0 for p in procs), logs
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["batches_done"] == 2
    assert manifest["n_shards"] == 8

    # run 2: fresh processes, same checkpoint dir -> resume and finish
    procs, logs = launch({})
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    got = json.loads(out.read_text())
    assert got["resumed_from"] == 2
    assert got["overflow"] == 0
    assert got["n_batches"] > 2

    # reference: same data counted in-process on this process's 8 devices
    import jax
    import numpy as np

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count

    assert jax.device_count() >= 8
    mesh = mesh_lib.make_mesh(8)
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=33, with_reverse=True
    )
    batches = [
        reads_io.pad_batch(b, 24) for b in reads_io.batch_reads(reads, 64, 24)
    ]
    sc = shard_count.sharded_count_batches(
        batches, k=11, m=5, parity=False, cutoff=1, mesh=mesh
    )
    table = shard_count.sharded_to_host_dict(sc, 11, 5)
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    digest = hashlib.sha256(json.dumps(canon).encode()).hexdigest()
    assert got["entries"] == len(table)
    assert got["digest"] == digest


@pytest.mark.slow
def test_four_process_nonzero_rank_sigkill_resume(tmp_path):
    """A 4-process gloo run loses ONLY rank 2 to
    SIGKILL (the other ranks die on the broken collective -- the
    partial-failure shape of a real multi-host job); a fresh 4-process
    launch on the same checkpoint dir resumes at the committed batch
    and finishes with the uninterrupted run's exact result."""
    import hashlib
    import json
    import socket
    import subprocess
    import sys as _sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    tool = repo / "tools/run_multihost_ckpt.py"
    ckpt = tmp_path / "ck4"
    ckpt.mkdir()
    out = tmp_path / "mh4.json"
    nproc = 4

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def launch(env_extra):
        env = {
            "PATH": "/usr/bin:/bin",
            "HOME": "/root",
            "GA_MH_PORT": str(free_port()),
            "GA_MH_DEVS": "2",
            **env_extra,
        }
        procs = [
            subprocess.Popen(
                [_sys.executable, str(tool), str(pid), str(nproc),
                 str(out if pid == 0 else "/dev/null"), str(ckpt)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for pid in range(nproc)
        ]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0].decode())
            except subprocess.TimeoutExpired:
                p.kill()  # exact child PID: survivors hang on the dead
                outs.append(p.communicate()[0].decode())  # peer's collective
        return procs, outs

    # run 1: ONLY rank 2 SIGKILLs itself after committing batch 1
    procs, logs = launch({
        "GA_DIE_AFTER_BATCH": "1", "GA_DIE_RANK": "2",
    })
    assert procs[2].returncode != 0, logs[2][-2000:]
    assert all(p.returncode != 0 for p in procs), [
        p.returncode for p in procs
    ]
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["batches_done"] >= 1
    assert manifest["n_shards"] == 8

    # run 2: fresh 4-process launch, same checkpoint dir
    procs, logs = launch({})
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    got = json.loads(out.read_text())
    assert got["resumed_from"] >= 1
    assert got["overflow"] == 0

    # reference: same data counted in-process on this process's 8 devices
    import jax
    import numpy as np

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count

    assert jax.device_count() >= 8
    mesh = mesh_lib.make_mesh(8)
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=33, with_reverse=True
    )
    batches = [
        reads_io.pad_batch(b, 24) for b in reads_io.batch_reads(reads, 64, 24)
    ]
    sc = shard_count.sharded_count_batches(
        batches, k=11, m=5, parity=False, cutoff=1, mesh=mesh
    )
    table = shard_count.sharded_to_host_dict(sc, 11, 5)
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    digest = hashlib.sha256(json.dumps(canon).encode()).hexdigest()
    assert got["entries"] == len(table)
    assert got["digest"] == digest


@pytest.mark.slow
def test_elastic_shrink_world_resume(tmp_path):
    """Live elasticity (beyond same-size resume): a 4-process world loses
    rank 2 mid-run; the supervisor (tools/run_elastic.py) detects the
    death, reaps the survivors hung on the broken collective, and
    relaunches a 3-process world on the same checkpoint dir.  The sharded
    checkpoints re-route onto the smaller mesh (12 shards vs 16), resume
    at the committed batch, and the final table digest equals an
    uninterrupted 4-process run's exactly."""
    sys.path.insert(0, str(REPO))
    from tools import run_elastic

    ck_a = tmp_path / "ck_elastic"
    ck_b = tmp_path / "ck_base"
    ck_a.mkdir(), ck_b.mkdir()

    got = run_elastic.supervise(
        4, str(tmp_path / "elastic.json"), str(ck_a),
        env_extra={"GA_DIE_AFTER_BATCH": "1", "GA_DIE_RANK": "2"},
    )
    assert got["attempts"] == [4, 3], got
    assert got["summary"]["resumed_from"] == 1
    assert got["summary"]["devices"] == 12
    assert got["summary"]["overflow"] == 0

    base = run_elastic.supervise(
        4, str(tmp_path / "base.json"), str(ck_b), env_extra={}
    )
    assert base["attempts"] == [4]
    assert base["summary"]["digest"] == got["summary"]["digest"]
    assert base["summary"]["entries"] == got["summary"]["entries"]
