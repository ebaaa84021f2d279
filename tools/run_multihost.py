"""N-process (multi-host) distributed count over real process boundaries.

Exercises the REAL multi-host code path -- ``jax.distributed.initialize``,
a global mesh spanning processes, cross-process collectives (gloo on CPU,
NCCL across GPU hosts) -- not a single-process simulation.

Launcher (CI-able single command; spawns the workers, waits, validates):

  python tools/run_multihost.py --procs 4 [--devs 2] [--out mh.json]

Worker (one per process; the launcher runs these):

  python tools/run_multihost.py <pid> <nproc> <out.json>

Each worker holds ``GA_MH_DEVS`` virtual CPU devices (default 4).
Every worker runs the count THREE ways and asserts bit-equality:

  1. flat mesh over all devices (the production router);
  2. two-level (slices=nproc, shards) mesh whose SLICE axis is exactly
     the process boundary -- verified from each device's process_index,
     so the DCN stage demonstrably crosses processes;
  3. when the device grid allows, a 3-axis (slices, x, y) mesh with
     n_slices = nproc/2: each DCN slice SPANS two processes, so the
     intra-slice "ICI" all_to_all itself crosses a process boundary --
     the worst-case axis/host alignment.

Process 0 writes a JSON summary (kept-entry count + a content hash over
the sorted kept (mmer, kmer, count) triples) that
tests/test_multihost.py compares against the single-process result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(nproc: int, devs: int, out_path: str) -> int:
    """Spawn the N workers, wait, validate, print the summary."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env["GA_MH_PORT"] = str(port)
    env["GA_MH_DEVS"] = str(devs)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid),
             str(nproc), out_path if pid == 0 else "/dev/null"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    logs = []
    rc = 0
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0].decode())
        except subprocess.TimeoutExpired:
            p.kill()  # exact child PID only
            logs.append(p.communicate()[0].decode())
        rc = rc or p.returncode
    if rc:
        for i, log in enumerate(logs):
            sys.stderr.write(f"--- worker {i} ---\n{log[-3000:]}\n")
        return rc or 1
    with open(out_path) as f:
        print(f.read())
    return 0


def worker(pid: int, nproc: int, out_path: str) -> int:
    devices_per_proc = int(os.environ.get("GA_MH_DEVS", "4"))
    port = os.environ.get("GA_MH_PORT", "29581")

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from genome_assembly_tpu.parallel import distributed

    p, n = distributed.init_multi_host(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert (p, n) == (pid, nproc)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import jax.experimental.multihost_utils as mhu

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import shard_count, two_level

    mesh = distributed.global_mesh()
    n_shards = len(jax.devices())

    k, m, cutoff = 11, 5, 1
    genome, reads, _ = datagen.generate_coverage_reads(
        genome_len=800, read_len=48, coverage=6, seed=2, with_reverse=True
    )
    (b,) = reads_io.batch_reads(reads, 64)
    b = reads_io.pad_batch(b, n_shards * ((len(reads) + n_shards - 1) // n_shards))

    def digest_of(sc):
        def full(x):
            return np.asarray(mhu.process_allgather(x, tiled=True))

        gathered = shard_count.ShardedCount(*[full(x) for x in sc])
        overflow = int(np.sum(gathered.overflow))
        table = shard_count.sharded_to_host_dict(gathered, k, m)
        canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
        return (
            overflow,
            len(table),
            hashlib.sha256(json.dumps(canon).encode()).hexdigest(),
        )

    def put(x, msh, spec):
        return jax.device_put(np.asarray(x), NamedSharding(msh, spec))

    sc = shard_count.sharded_count(
        put(b.codes, mesh, P("shards")),
        put(b.lengths, mesh, P("shards")),
        put(b.read_ids, mesh, P("shards")),
        k=k, m=m, parity=False, cutoff=cutoff, mesh=mesh,
    )
    overflow, entries, digest = digest_of(sc)

    # --- two-level (slices = PROCESS boundary, shards = local devices) ---
    devs = np.array(jax.devices())
    proc_of = np.array([d.process_index for d in devs])
    order = np.argsort(proc_of, kind="stable")
    devs = devs[order]
    tl_grid = devs.reshape(nproc, devices_per_proc)
    # every slice row must be exactly one process's devices, or the
    # "DCN axis == process boundary" claim below is vacuous
    row_procs = np.array(
        [[d.process_index for d in row] for row in tl_grid]
    )
    assert (row_procs == row_procs[:, :1]).all(), row_procs
    tl_mesh = Mesh(tl_grid, (two_level.SLICE_AXIS, "shards"))
    sc_tl = two_level.sharded_count_two_level(
        put(b.codes, tl_mesh, P((two_level.SLICE_AXIS, "shards"))),
        put(b.lengths, tl_mesh, P((two_level.SLICE_AXIS, "shards"))),
        put(b.read_ids, tl_mesh, P((two_level.SLICE_AXIS, "shards"))),
        k=k, m=m, parity=False, cutoff=cutoff, mesh=tl_mesh,
    )
    overflow_tl, entries_tl, digest_tl = digest_of(sc_tl)
    assert (overflow_tl, entries_tl, digest_tl) == (
        overflow, entries, digest,
    ), "two-level (slices=processes) result diverged from the flat router"

    # --- 3-axis mesh whose SLICES SPAN PROCESSES (worst alignment) ---
    digest_tl3 = None
    if nproc % 2 == 0 and nproc * devices_per_proc >= 8:
        tl3_grid = devs.reshape(nproc // 2, 2 * devices_per_proc // 2, 2)
        tl3_mesh = Mesh(tl3_grid, (two_level.SLICE_AXIS, "x", "y"))
        spec3 = P((two_level.SLICE_AXIS, "x", "y"))
        sc3 = two_level.sharded_count_two_level(
            put(b.codes, tl3_mesh, spec3),
            put(b.lengths, tl3_mesh, spec3),
            put(b.read_ids, tl3_mesh, spec3),
            k=k, m=m, parity=False, cutoff=cutoff, mesh=tl3_mesh,
        )
        overflow3, entries3, digest_tl3 = digest_of(sc3)
        assert (overflow3, entries3, digest_tl3) == (
            overflow, entries, digest,
        ), "3-axis two-level result diverged from the flat router"

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "processes": n,
                    "devices": n_shards,
                    "overflow": overflow,
                    "entries": entries,
                    "digest": digest,
                    "two_level_digest": digest_tl,
                    "two_level3_digest": digest_tl3,
                },
                f,
            )
        print(json.dumps({"entries": entries, "digest": digest}))
    return 0


def main() -> int:
    if sys.argv[1] == "--procs":
        nproc = int(sys.argv[2])
        devs = 4
        out = os.path.join(tempfile.gettempdir(), "ga_mh.json")
        rest = sys.argv[3:]
        while rest:
            if rest[0] == "--devs":
                devs = int(rest[1])
                rest = rest[2:]
            elif rest[0] == "--out":
                out = rest[1]
                rest = rest[2:]
            else:
                raise SystemExit(f"unknown arg {rest[0]}")
        return launch(nproc, devs, out)
    return worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])


if __name__ == "__main__":
    sys.exit(main())
