"""True multi-process (multi-host) distributed counting.

Spawns TWO real processes, each with 4 virtual CPU devices, joined by
``jax.distributed`` + gloo CPU collectives into one 8-device global mesh
(tools/run_multihost.py) -- the same code path a 2-host GPU job runs,
per SURVEY.md section 4 item 3 / 5.8.  The result must equal the
single-process 8-device run exactly.
"""

import hashlib
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_two_process_count_matches_single_process():
    import socket

    with socket.socket() as sock:  # grab a free port; avoids collisions
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / "mh.json"
        env = {
            "PATH": "/usr/bin:/bin",
            "HOME": "/root",
            "GA_MH_PORT": str(port),
        }
        procs = [
            subprocess.Popen(
                [sys.executable, str(REPO / "tools/run_multihost.py"),
                 str(pid), "2", str(out if pid == 0 else "/dev/null")],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
            for pid in (0, 1)
        ]
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-2000:]
        got = json.loads(out.read_text())
    assert got["processes"] == 2 and got["devices"] == 8
    assert got["overflow"] == 0

    # single-process reference on this process's own 8 virtual devices
    import jax
    import jax.numpy as jnp

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count

    mesh = mesh_lib.make_mesh(8)
    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=800, read_len=48, coverage=6, seed=2, with_reverse=True
    )
    (b,) = reads_io.batch_reads(reads, 64)
    b = reads_io.pad_batch(b, 8 * ((len(reads) + 7) // 8))
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
        k=k,
        m=m,
        parity=False,
        cutoff=cutoff,
        mesh=mesh,
    )
    table = shard_count.sharded_to_host_dict(
        shard_count.ShardedCount(*[np.asarray(x) for x in sc]), k, m
    )
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    digest = hashlib.sha256(json.dumps(canon).encode()).hexdigest()
    assert got["entries"] == len(table)
    assert got["digest"] == digest


@pytest.mark.slow
def test_four_process_launcher_two_level_on_process_boundaries():
    """4 gloo processes (2 devices each) through the
    CI-able launcher.  Every worker runs the flat router, the (4, 2)
    two-level mesh whose DCN axis IS the process boundary (asserted from
    device.process_index inside the worker), and the (2, 2, 2) mesh
    whose slices SPAN two processes -- all three must hash identically,
    and the digest must equal the single-process 8-device run's."""
    import subprocess

    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / "mh4.json"
        r = subprocess.run(
            [sys.executable, str(REPO / "tools/run_multihost.py"),
             "--procs", "4", "--devs", "2", "--out", str(out)],
            env={"PATH": "/usr/bin:/bin", "HOME": "/root"},
            capture_output=True, timeout=600, text=True,
        )
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        got = json.loads(out.read_text())
    assert got["processes"] == 4 and got["devices"] == 8
    assert got["overflow"] == 0
    assert got["two_level_digest"] == got["digest"]
    assert got["two_level3_digest"] == got["digest"]

    # the 2-process test already pins this digest to the single-process
    # run; pin these 4-process results to the same dataset's digest
    import jax
    import jax.numpy as jnp

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count

    mesh = mesh_lib.make_mesh(8)
    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=800, read_len=48, coverage=6, seed=2, with_reverse=True
    )
    (b,) = reads_io.batch_reads(reads, 64)
    b = reads_io.pad_batch(b, 8 * ((len(reads) + 7) // 8))
    sc = shard_count.sharded_count(
        jnp.asarray(b.codes), jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids), k=k, m=m, parity=False, cutoff=cutoff,
        mesh=mesh,
    )
    table = shard_count.sharded_to_host_dict(
        shard_count.ShardedCount(*[np.asarray(x) for x in sc]), k, m
    )
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    digest = hashlib.sha256(json.dumps(canon).encode()).hexdigest()
    assert got["entries"] == len(table)
    assert got["digest"] == digest
