"""One process of an N-process CHECKPOINTED multi-batch distributed count.

The kill-and-resume harness for the sharded checkpoint format
(utils/checkpoint.save_count_shards): a multi-batch
``sharded_count_batches`` run over a 2-process gloo mesh, checkpointing
every exchanged batch.  With GA_DIE_AFTER_BATCH=<n> set, THIS process
SIGKILLs itself right after the checkpoint for batch n commits -- the
partner process dies on the broken collective -- and a relaunch with the
same checkpoint dir resumes at batch n instead of batch 0.

  python tools/run_multihost_ckpt.py <pid> <nproc> <out.json> <ckpt_dir>

GA_DIE_RANK=<r> (default: every rank) restricts the self-SIGKILL to
one rank, so a 4-process run can lose a NON-ZERO rank while the others
die on the broken collective -- the partial-failure shape of a real
multi-host job.  GA_MH_DEVS sets virtual devices per process
(default 4).

Process 0 writes a JSON summary: entry count, content digest, overflow,
and resumed_from (the manifest's batches_done at startup) so the test can
assert the resume actually skipped work.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    out_path = sys.argv[3]
    ckpt_dir = sys.argv[4]
    die_after = int(os.environ.get("GA_DIE_AFTER_BATCH", "-1"))
    die_rank = int(os.environ.get("GA_DIE_RANK", str(pid)))
    if die_rank != pid:
        die_after = -1  # only the selected rank self-kills
    port = os.environ.get("GA_MH_PORT", "29582")
    devices_per_proc = int(os.environ.get("GA_MH_DEVS", "4"))

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from genome_assembly_tpu.parallel import distributed

    distributed.init_multi_host(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    import numpy as np
    import jax.experimental.multihost_utils as mhu

    from genome_assembly_tpu.io import datagen, reads as reads_io
    from genome_assembly_tpu.parallel import shard_count
    from genome_assembly_tpu.utils import checkpoint as ckpt_ops

    mesh = distributed.global_mesh()
    n_shards = len(jax.devices())

    k, m, cutoff = 11, 5, 1
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=33, with_reverse=True
    )
    # GA_MH_ROWS pins the batch shape independent of world size, so an
    # ELASTIC relaunch with fewer processes replays the identical batch
    # sequence (rows must divide by every world's shard count)
    rows = int(os.environ.get("GA_MH_ROWS", str(3 * n_shards)))
    if rows % n_shards:
        raise SystemExit(
            f"GA_MH_ROWS={rows} not divisible by {n_shards} shards"
        )
    batches = [
        reads_io.pad_batch(b, rows)
        for b in reads_io.batch_reads(reads, 64, rows)
    ]

    resumed_from = 0
    manifest = None
    mpath = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        resumed_from = manifest["batches_done"]

    if die_after >= 0:
        # arm the kill: save_count_shards commits the manifest last, so
        # dying right after the batch-`die_after` save leaves a complete,
        # resumable checkpoint (the fault model of SURVEY.md 5.3)
        orig_save = ckpt_ops.save_count_shards

        def save_and_maybe_die(dirpath, received, batches_done, meta):
            orig_save(dirpath, received, batches_done, meta)
            if batches_done >= die_after:
                os.kill(os.getpid(), 9)

        ckpt_ops.save_count_shards = save_and_maybe_die

    sc = shard_count.sharded_count_batches(
        batches, k=k, m=m, parity=False, cutoff=cutoff, mesh=mesh,
        checkpoint_dir=ckpt_dir, checkpoint_every=1,
    )

    def full(x):
        return np.asarray(mhu.process_allgather(x, tiled=True))

    gathered = shard_count.ShardedCount(*[full(x) for x in sc])
    overflow = int(np.sum(gathered.overflow))
    table = shard_count.sharded_to_host_dict(gathered, k, m)
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    digest = hashlib.sha256(json.dumps(canon).encode()).hexdigest()

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "processes": nproc,
                    "devices": n_shards,
                    "n_batches": len(batches),
                    "resumed_from": resumed_from,
                    "overflow": overflow,
                    "entries": len(table),
                    "digest": digest,
                },
                f,
            )
        print(json.dumps({"entries": len(table), "digest": digest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
