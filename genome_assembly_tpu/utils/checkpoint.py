"""Phase-boundary checkpoint/resume (SURVEY.md section 5.4).

The reference has none; here the counting phase is restartable per batch
(idempotent merge into the table) and the counted table itself serializes
at any phase boundary (post-count, post-prune).  Format: a compressed npz
of the CountedTable arrays plus a JSON sidecar of config metadata -- self
contained, mmap-friendly, no service dependencies.  (orbax/tensorstore is
available for pod-scale sharded checkpoints; the npz path keeps the
single-host flow dependency-light.)
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Tuple

import numpy as np

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.ops.count import CountedTable

FORMAT_VERSION = 1


def save_counted_table(
    path: str, table: CountedTable, config: PipelineConfig, phase: str
) -> None:
    """Serialize a counted table (device or host arrays) + metadata."""
    p = pathlib.Path(path)
    if p.suffix != ".npz":
        p = p.with_suffix(p.suffix + ".npz")
    p.parent.mkdir(parents=True, exist_ok=True)
    arrays = {name: np.asarray(arr) for name, arr in table._asdict().items()}
    np.savez_compressed(p, **arrays)
    meta = {
        "format_version": FORMAT_VERSION,
        "phase": phase,
        "config": dataclasses.asdict(config),
    }
    p.with_suffix(".meta.json").write_text(json.dumps(meta, indent=2))


def jump_fingerprint(next_state) -> dict:
    """Cheap content fingerprint of a link array (device-side reduction).

    Frontier checkpoints are only valid for the exact graph they were
    taken from; a full hash would need a host transfer of the (possibly
    multi-GB) link array, so two wrapping partial sums + the length stand
    in.  Wrap-around is deterministic; collisions would need a different
    graph agreeing in both 16-bit half sums AND length.
    """
    import jax.numpy as jnp

    ns = next_state.astype(jnp.int32)
    lo = int(jnp.sum((ns & 0xFFFF).astype(jnp.uint32)))
    hi = int(jnp.sum((ns >> 16).astype(jnp.uint32)))
    return {"n2": int(next_state.shape[0]), "sum_lo": lo, "sum_hi": hi}


def save_jump_frontier(
    dirpath: str, tbl, pred, rounds_done: int, lanes: int, fingerprint: dict
) -> None:
    """Checkpoint a pointer-jump doubling frontier (SURVEY.md section 5.4
    'per-extension-round' resume).  Atomic: written to a temp name and
    renamed, so a kill mid-save leaves the previous frontier intact."""
    import os

    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".frontier_l{lanes}.tmp.npz"
    final = d / f"frontier_l{lanes}.npz"
    # uncompressed: doubling frontiers are near-random int32 parent ids,
    # so zlib bought ~34% at minutes of CPU per multi-GB save (measured on
    # the celegans jump); disk is cheaper than that
    np.savez(
        tmp,
        tbl=np.asarray(tbl),
        pred=np.asarray(pred),
        rounds_done=np.int64(rounds_done),
    )
    (d / f"frontier_l{lanes}.meta.json").write_text(
        json.dumps({"format_version": FORMAT_VERSION, **fingerprint})
    )
    os.replace(tmp, final)


def load_jump_frontier(dirpath: str, lanes: int, fingerprint: dict):
    """Restore a frontier if one exists for this exact graph, else None.

    Returns (tbl, pred, rounds_done) as numpy arrays.  A fingerprint
    mismatch (different links array) is treated as no checkpoint.
    """
    d = pathlib.Path(dirpath)
    final = d / f"frontier_l{lanes}.npz"
    meta_path = d / f"frontier_l{lanes}.meta.json"
    if not final.exists() or not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    if meta != {"format_version": FORMAT_VERSION, **fingerprint}:
        return None
    data = np.load(final)
    return data["tbl"], data["pred"], int(data["rounds_done"])


def clear_jump_frontier(dirpath: str, lanes: int) -> None:
    d = pathlib.Path(dirpath)
    for name in (f"frontier_l{lanes}.npz", f"frontier_l{lanes}.meta.json"):
        p = d / name
        if p.exists():
            p.unlink()


SHARDED_FORMAT = 1
_SHARD_LANES = ("mmer", "khi", "klo", "rid", "stream")


def save_count_shards(
    dirpath: str, received, batches_done: int, meta: dict
) -> None:
    """Checkpoint a distributed count's accumulated routed records.

    received: the 6 globally-sharded [n_shards, R] lanes
    (mmer, khi, klo, rid, stream, overflow) that
    ``shard_count.sharded_count_batches`` accumulates.  Each PROCESS
    writes one ``shard_<g>.npz`` per global shard row it addresses
    (valid records compacted -- the counting sort is order-invariant, so
    only real rows need to survive), then process 0 commits the manifest.
    The manifest is the commit point: a kill mid-save leaves the previous
    manifest intact and the orphan shard files are overwritten next save.

    Mesh-shape independence: the files are keyed by GLOBAL shard index
    and the manifest records n_shards; ``load_count_shards`` re-routes
    records host-side when resuming onto a different shard count, so a
    checkpoint taken on 2 processes x 4 devices restores onto 1 x 8,
    8 x 1, or a different mesh entirely.  (Per SURVEY.md 5.4; replaces
    the gather-to-one-host npz for multi-host runs -- each process only
    ever touches its own shards' bytes.)
    """
    import jax
    import json as _json

    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    lanes = list(received[:5])
    ovf = received[5]
    per_shard: dict[int, dict] = {}

    def scatter_rows(name, arr):
        # a device shard may hold SEVERAL global rows (or all of them, if
        # a concat left the array replicated); key every row by its
        # global index rather than assuming one row per device
        for s in arr.addressable_shards:
            start = int(s.index[0].start or 0)
            data = np.asarray(s.data)
            for j in range(data.shape[0]):
                per_shard.setdefault(start + j, {})[name] = data[j]

    for name, arr in zip(_SHARD_LANES, lanes):
        scatter_rows(name, arr)
    scatter_rows("ovf", ovf)
    sent = np.uint32(0xFFFFFFFF)
    for g, got in per_shard.items():
        keep = got["mmer"] != sent
        payload = {name: got[name][keep] for name in _SHARD_LANES}
        payload["ovf"] = np.int64(got["ovf"].sum())
        tmp = d / f".shard_{g}.tmp.npz"
        np.savez(tmp, **payload)
        tmp.rename(d / f"shard_{g}.npz")
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mhu

        # every process's shard files must exist before the manifest
        # commits the checkpoint
        mhu.sync_global_devices("ga_count_ckpt")
    if jax.process_index() == 0:
        manifest = {
            "format": SHARDED_FORMAT,
            "n_shards": int(lanes[0].shape[0]),
            "batches_done": int(batches_done),
            **meta,
        }
        tmp = d / ".manifest.tmp.json"
        tmp.write_text(_json.dumps(manifest))
        tmp.rename(d / "manifest.json")


def load_count_shards(dirpath: str, *, n_shards: int, expect: dict):
    """Restore a distributed count checkpoint for an ``n_shards`` mesh.

    Returns (lanes, batches_done) where lanes are 6 host numpy arrays
    [n_shards, R] (records sentinel-padded per row) ready to device_put
    with the mesh's shard sharding -- or None when no manifest exists.
    ``expect`` entries (k, m, parity, row geometry) must match the
    manifest; a mismatch raises instead of silently resuming the wrong
    run.  When the saved shard count differs, every record is re-routed
    host-side by the same ownership hash the live router uses
    (mesh-shape-independent resume); overflow totals are preserved.
    """
    import json as _json

    from genome_assembly_tpu.parallel.shard_count import key_owner_of, owner_of

    d = pathlib.Path(dirpath)
    mpath = d / "manifest.json"
    if not mpath.exists():
        return None
    manifest = _json.loads(mpath.read_text())
    if manifest["format"] != SHARDED_FORMAT:
        raise ValueError(f"unsupported sharded checkpoint {manifest}")
    for key, val in expect.items():
        # route_by was added to the manifest after the first sharded
        # checkpoints shipped; an ABSENT key means minimizer routing
        # (the pre-key-routing default), so old mmer-routed manifests
        # stay loadable -- mirrors the re-route default below.
        have = manifest.get(key, "mmer" if key == "route_by" else None)
        if have != val:
            raise ValueError(
                f"checkpoint {d} was written by a different run: "
                f"{key}={have!r} != {val!r}"
            )
    saved_shards = manifest["n_shards"]
    parts = []
    ovf_total = 0
    for g in range(saved_shards):
        data = np.load(d / f"shard_{g}.npz")
        parts.append({name: data[name] for name in _SHARD_LANES})
        ovf_total += int(data["ovf"])
    sent = np.uint32(0xFFFFFFFF)
    if saved_shards == n_shards:
        rows = parts
    else:
        cat = {
            name: np.concatenate([p[name] for p in parts])
            for name in _SHARD_LANES
        }
        import jax.numpy as jnp

        # re-route by the SAME ownership hash the records were routed
        # with (the manifest records it; key routing is the fast-mode
        # balance fix, minimizer routing the parity-compatible default)
        if manifest.get("route_by", "mmer") == "key":
            owner = np.asarray(key_owner_of(
                jnp.asarray(cat["khi"]), jnp.asarray(cat["klo"]), n_shards
            ))
        else:
            owner = np.asarray(owner_of(jnp.asarray(cat["mmer"]), n_shards))
        rows = [
            {name: cat[name][owner == g] for name in _SHARD_LANES}
            for g in range(n_shards)
        ]
    width = max(1, max(r["mmer"].shape[0] for r in rows))
    lanes = []
    fills = {"mmer": sent, "khi": 0, "klo": 0, "rid": 0,
             "stream": np.uint32(0xFFFFFFFF)}
    for name in _SHARD_LANES:
        buf = np.full((n_shards, width), fills[name], dtype=np.uint32)
        for g, r in enumerate(rows):
            buf[g, : r[name].shape[0]] = r[name]
        lanes.append(buf)
    ovf = np.zeros((n_shards, 1), dtype=np.int32)
    ovf[0, 0] = ovf_total
    lanes.append(ovf)
    return lanes, int(manifest["batches_done"])


def load_counted_table(path: str) -> Tuple[CountedTable, PipelineConfig, str]:
    """Restore a counted table; returns (table, config, phase)."""
    p = pathlib.Path(path)
    if p.suffix != ".npz":
        p = p.with_suffix(p.suffix + ".npz")
    meta = json.loads(p.with_suffix(".meta.json").read_text())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['format_version']}")
    data = np.load(p)
    table = CountedTable(**{name: data[name] for name in CountedTable._fields})
    config = PipelineConfig(**meta["config"])
    return table, config, meta["phase"]
