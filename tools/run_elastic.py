"""Elastic supervisor: failure detection + shrunk-world relaunch.

The reference exits on any failure (zhash.c:230-249).  Our previous fault
story was resume-from-checkpoint with the SAME world size; this supervisor
closes the gap to live elasticity: it launches an
N-process gloo world running the checkpointed distributed count
(tools/run_multihost_ckpt.py), watches the worker processes, and when any
rank dies (SIGKILL, crash, nonzero exit) it declares the world failed,
reaps the survivors hung on the broken collective, and relaunches a NEW
world with N-1 processes on the same checkpoint directory.  The sharded
checkpoint format re-routes records onto the smaller mesh by the ownership
hash (utils/checkpoint.load_count_shards is mesh-shape-independent), so
the shrunk world resumes at the committed batch instead of restarting.

GA_MH_ROWS pins the batch shape across world sizes (the batch
sequence, and therefore the checkpoint's batch numbering, must not depend
on how many processes survive).

  python tools/run_elastic.py <nproc> <out.json> <ckpt_dir>

Env (forwarded to the FIRST world only -- survivors must not re-die):
  GA_DIE_AFTER_BATCH, GA_DIE_RANK  arm the fault injection.
  GA_MH_DEVS    devices per process (default 4).
  GA_MH_ROWS    rows per batch (default: lcm-friendly 48).

Writes <out.json>: {"attempts": [world sizes], "summary": <pid-0 json of
the completed world>}.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "run_multihost_ckpt.py"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_world(
    nproc: int, out_path: str, ckpt_dir: str, env_extra: dict,
    timeout_s: float = 300.0,
) -> list:
    """Launch one world; on any rank's death kill the exact PIDs of the
    hung survivors (never by pattern).  Returns the Popen list."""
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", "/root"),
        "GA_MH_PORT": str(_free_port()),
        "GA_MH_ROWS": os.environ.get("GA_MH_ROWS", "48"),
        "GA_MH_DEVS": os.environ.get("GA_MH_DEVS", "4"),
        **env_extra,
    }
    # per-rank log FILES, not pipes: an undrained pipe blocks a chatty
    # worker at ~64 KiB and the hang would read as a world failure
    pathlib.Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
    logs = [
        open(f"{ckpt_dir}/rank{pid}.log", "ab") for pid in range(nproc)
    ]
    procs = [
        subprocess.Popen(
            [sys.executable, str(TOOL), str(pid), str(nproc),
             out_path if pid == 0 else "/dev/null", ckpt_dir],
            env=env, stdout=logs[pid], stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c is not None and c != 0 for c in codes):
            # failure detected: give survivors a moment to die on the
            # broken collective, then kill the stragglers by exact PID
            grace = time.time() + 10
            while time.time() < grace and any(
                p.poll() is None for p in procs
            ):
                time.sleep(0.2)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    else:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, lf in zip(procs, logs):
        p.wait()
        lf.close()
    return procs


def supervise(
    nproc: int, out_path: str, ckpt_dir: str, *, min_procs: int = 2,
    env_extra: dict | None = None,
) -> dict:
    attempts = []
    world = nproc
    extra = dict(env_extra or {})
    # fault-injection env applies to the first world only
    for key in ("GA_DIE_AFTER_BATCH", "GA_DIE_RANK"):
        if key in os.environ:
            extra.setdefault(key, os.environ[key])
    while world >= min_procs:
        attempts.append(world)
        procs = _run_world(world, out_path, ckpt_dir, extra)
        if all(p.returncode == 0 for p in procs):
            with open(out_path) as f:
                summary = json.load(f)
            result = {"attempts": attempts, "summary": summary}
            with open(out_path, "w") as f:
                json.dump(result, f)
            return result
        extra.pop("GA_DIE_AFTER_BATCH", None)
        extra.pop("GA_DIE_RANK", None)
        world -= 1  # the dead rank does not come back; shrink the world
    raise SystemExit(f"no world >= {min_procs} processes completed")


def main() -> int:
    nproc = int(sys.argv[1])
    out_path = sys.argv[2]
    ckpt_dir = sys.argv[3]
    result = supervise(nproc, out_path, ckpt_dir)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
