"""Smoke test of the assembler on the GPU: the main entry points at real
sizes, every result compared exactly with a plain numpy or Python
reference.

  python chip_smoke.py           # one GPU: fast-exact, parity-exact,
                                 # ecoli, layouts
  python chip_smoke.py --four    # four GPUs: the mesh path, compared
                                 # with the same work on GPU 0 alone

Everything runs in this one process: a JAX process reserves most of a
GPU's memory when it first uses it, so a second process on the same card
fails.  The entry points are therefore called in-process
(``genome_assembly_tpu.cli.main`` and ``tools/run_scale.run``).

Exits non-zero, before any phase, unless JAX's first device is a GPU, and
on the first failed check.  Every comparison is exact: every lane is a
uint32 key, an id or a count, so the card must give the CPU's bits.  The
last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

# ---------------------------------------------------------------------------
# Plain references (numpy only; independent of the code under test)
# ---------------------------------------------------------------------------

BASES = "TGCA"  # code order of ops/encode.py: T=0 G=1 C=2 A=3
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _CODE[ord(_b)] = _i
_ASCII = np.frombuffer(BASES.encode(), dtype=np.uint8)


class CheckFailed(RuntimeError):
    """A smoke check found a difference from the reference."""


def check(cond, what: str, log: list) -> None:
    """Record ``what`` if ``cond`` holds, else fail the run."""
    if not cond:
        raise CheckFailed(what)
    log.append(what)


def encode(seq: str) -> np.ndarray:
    codes = _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if np.any(codes == 255):
        raise ValueError("sequence holds a byte other than ACGT")
    return codes


def codes_to_strings(codes: np.ndarray) -> list[str]:
    """[n, L] base codes -> n strings."""
    n, length = codes.shape
    raw = _ASCII[codes].tobytes().decode()
    return [raw[i * length:(i + 1) * length] for i in range(n)]


def window_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical keys of every length-k window of each row of ``codes``.

    codes: [n, L] base codes.  A key is the 2k-bit MSB-first packing of
    the window, and the canonical key is the smaller of the window's and
    its reverse complement's.  Returns uint64 [n, L - k + 1].
    """
    codes = np.atleast_2d(codes).astype(np.uint64)
    n, length = codes.shape
    nw = length - k + 1
    fwd = np.zeros((n, max(nw, 0)), dtype=np.uint64)
    rc = np.zeros_like(fwd)
    two = np.uint64(2)
    three = np.uint64(3)
    for j in range(k if nw > 0 else 0):
        w = codes[:, j:j + nw]
        fwd = (fwd << two) | w
        rc |= (three - w) << np.uint64(2 * j)
    return np.minimum(fwd, rc)


def sequence_keys(seqs, k: int) -> np.ndarray:
    """Canonical keys of every window of every sequence, concatenated."""
    by_len: dict = {}
    for s in seqs:
        by_len.setdefault(len(s), []).append(s)
    parts = [np.zeros(0, dtype=np.uint64)]
    for length, group in by_len.items():
        if length < k:
            continue
        codes = encode("".join(group)).reshape(len(group), length)
        parts.append(window_keys(codes, k).reshape(-1))
    return np.concatenate(parts)


def kept_reference(keys: np.ndarray, cutoff: int):
    """(sorted kept keys, number of distinct keys): a key is kept iff it
    occurs more than ``cutoff`` times."""
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq[counts > cutoff], len(uniq)


def check_exactly_once(unitigs, kept: np.ndarray, k: int, log: list) -> None:
    """Every kept key appears in the unitigs exactly once, and nothing else
    does (the unitigs are a partition of the kept k-mer set)."""
    got = np.sort(sequence_keys(unitigs, k))
    dups = int(np.count_nonzero(got[1:] == got[:-1]))
    check(dups == 0, f"no k-mer repeated across unitigs ({dups} repeats)", log)
    check(
        np.array_equal(got, kept),
        f"unitig k-mers == kept set ({len(got)} vs {len(kept)})", log,
    )


def device_keys(khi, klo, valid) -> np.ndarray:
    """Sorted uint64 keys of the valid rows of a (hi, lo) key-lane pair."""
    valid = np.asarray(valid)
    key = (np.asarray(khi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        klo
    ).astype(np.uint64)
    return np.sort(key[valid])


def graph_digest(khi, klo, valid, graph) -> dict:
    """Digests of the kept keys, links and (head, rank) that do not depend
    on the order of the node array, so layouts that number states
    differently (in-core, out-of-core, partitioned) compare exactly.

    A state is named by its k-mer and strand; a cycle's representative
    depends on the numbering, so cycle states contribute only their
    cycle flag.
    """
    khi, klo, valid = (np.asarray(a) for a in (khi, klo, valid))
    key = (khi.astype(np.int64) << 32) | klo.astype(np.int64)
    states = np.flatnonzero(np.repeat(valid, 2))

    def name(ids):
        ids = np.asarray(ids).astype(np.int64)
        safe = np.where(ids >= 0, ids, 0)
        return np.where(ids >= 0, (key[safe >> 1] << 1) | (safe & 1), -1)

    own = name(states)
    order = np.argsort(own)
    s = states[order]
    cyc = np.asarray(graph.is_cycle)[s]
    links = np.stack([own[order], name(np.asarray(graph.next_state)[s])])
    head_rank = np.stack([
        own[order],
        np.where(cyc, -1, name(np.asarray(graph.head)[s])),
        np.where(cyc, 0, np.asarray(graph.rank)[s].astype(np.int64)),
        cyc.astype(np.int64),
    ])

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    return {
        "keys": digest(device_keys(khi, klo, valid)),
        "links": digest(links),
        "head_rank": digest(head_rank),
    }


# ---------------------------------------------------------------------------
# Phases on one GPU
# ---------------------------------------------------------------------------


def _cli(argv) -> str:
    """Run the CLI in-process; returns what it wrote to stdout."""
    from genome_assembly_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise CheckFailed(f"cli {argv[:3]} exited {rc}")
    return out.getvalue()


def fast_exact(workdir, *, genome_len=200_000, coverage=30, read_len=100,
               configs=((31, 7), (21, 7)), cutoff=1, seed=11) -> list:
    """`assemble --mode fast` against the numpy reference count."""
    from genome_assembly_tpu.io import datagen

    log: list = []
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=read_len, coverage=coverage,
        seed=seed, with_reverse=True,
    )
    path = pathlib.Path(workdir) / "fast_reads.txt"
    datagen.write_reads(reads, str(path))
    for k, m in configs:
        metrics = pathlib.Path(workdir) / f"fast_k{k}m{m}.jsonl"
        out = _cli([
            "assemble", str(path), "--mode", "fast", "--k", str(k),
            "--m", str(m), "--cutoff", str(cutoff), "--metrics", str(metrics),
        ])
        unitigs = out.split()
        kept, _ = kept_reference(sequence_keys(reads, k), cutoff)
        rec = json.loads(metrics.read_text().splitlines()[-1])
        check(
            rec["entries_post_prune"] == len(kept),
            f"k={k} m={m}: kept count {rec['entries_post_prune']} == "
            f"numpy {len(kept)}", log,
        )
        check_exactly_once(unitigs, kept, k, log)
    return log


def parity_exact(workdir, *, n_reads=20_000, seed=5) -> list:
    """Parity mode: pruned table against the executable spec
    (parity/model.py), and the native replay's output against the Python
    replay's, byte for byte in line order, at K=31/M=4 and K=6/M=3, each
    over ``n_reads`` read ids.  The reference's fgets(101) consumes a
    100-bp line as two reads (99 bp and an empty one), so K=31 takes
    n_reads / 2 lines; the Python replay's cost grows about
    quadratically with the read count there."""
    from genome_assembly_tpu.config import REFERENCE_CONFIG, SMALL_CONFIG
    from genome_assembly_tpu.io import datagen
    from genome_assembly_tpu.models.pipeline import ParityAssembler
    from genome_assembly_tpu.native import replay_native
    from genome_assembly_tpu.parity import model

    log: list = []
    check(replay_native.available(), "native replay library built", log)
    for cfg, read_len, lines in ((REFERENCE_CONFIG, 100, n_reads // 2),
                                 (SMALL_CONFIG, 30, n_reads)):
        _, reads, _ = datagen.generate_coverage_reads(
            genome_len=lines * read_len // 20, read_len=read_len,
            coverage=20, seed=seed,
        )
        path = pathlib.Path(workdir) / f"parity_k{cfg.k}.txt"
        datagen.write_reads(reads, str(path))
        asm = ParityAssembler(cfg)
        loaded = asm.load(str(path))
        tag = f"K={cfg.k} M={cfg.m} ({len(loaded)} reads)"
        got = asm.pruned_table_dict(loaded)
        want = model.count_table(
            model.scan_reads(loaded, cfg.k, cfg.m), cfg.abundance_cutoff
        )
        check(got == want,
              f"{tag}: pruned table == parity/model.py ({len(want)})", log)
        native = _cli([
            "assemble", str(path), "--k", str(cfg.k), "--m", str(cfg.m),
            "--max-read-len", str(cfg.max_read_len),
        ])
        python, _ = asm.assemble(loaded, engine="python")
        python = "".join(line + "\n" for line in python)
        check(native == python,
              f"{tag}: native replay == Python replay, byte for byte "
              f"({native.count(chr(10))} lines)", log)
    return log


def scale_run(argv):
    """tools/run_scale.run in-process, with its arrays kept for digests."""
    from tools import run_scale

    result = run_scale.run(argv, keep_arrays=True)
    if result["rc"] != 0:
        raise CheckFailed(f"run_scale {argv} returned {result['rc']}")
    return result


def scale_reference(preset: str, k: int, cutoff: int, seed: int = 0):
    """numpy count over the exact reads run_scale simulates for a preset:
    (sorted kept keys, n_distinct)."""
    import jax

    from tools import run_scale

    cfg = run_scale.PRESETS[preset]
    simulate = jax.jit(lambda i: run_scale.virtual_reads(seed, i, cfg))
    keys = [
        window_keys(np.asarray(simulate(b)), k).reshape(-1)
        for b in range(run_scale.batch_count(cfg))
    ]
    return kept_reference(np.concatenate(keys), cutoff)


def ecoli(preset="ecoli", k=31, cutoff=1):
    """run_scale --materialize against the numpy count of the same reads."""
    import jax.numpy as jnp

    from genome_assembly_tpu.ops import dbg

    log: list = []
    res = scale_run(["--preset", preset, "--k", str(k), "--cutoff",
                     str(cutoff), "--materialize"])
    kept, n_distinct = scale_reference(preset, k, cutoff)
    check(res["overflow"] == 0, "zero overflow", log)
    check(res["n_distinct"] == n_distinct,
          f"n_distinct {res['n_distinct']} == numpy {n_distinct}", log)
    check(res["n_kept"] == len(kept),
          f"n_kept {res['n_kept']} == numpy {len(kept)}", log)
    check(np.array_equal(device_keys(res["khi"], res["klo"], res["valid"]),
                         kept), "kept keys == numpy kept keys", log)
    unitigs = res["unitigs"]
    covered = sum(len(u) - k + 1 for u in unitigs)
    check(covered == res["n_kept"],
          f"sum(len - k + 1) over {len(unitigs)} unitigs == n_kept", log)
    check_exactly_once(unitigs, kept, k, log)
    # pointer jumping alone on the run's links: its wall, and its rounds
    # (the early exit stops one round after 2^(r-1) covers the longest
    # chain)
    links = jnp.asarray(res["graph"].next_state)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        g = dbg.pointer_jump(links)
        g.head.block_until_ready()
        walls.append(time.perf_counter() - t0)
    max_rank = int(np.max(np.asarray(res["graph"].rank)))
    rounds = int(np.ceil(np.log2(max(max_rank, 1)))) + 1
    log.append(
        f"pointer_jump on {links.shape[0]} states: walls "
        f"{[round(w, 4) for w in walls]} s, longest chain {max_rank + 1}, "
        f"{rounds} doubling rounds"
    )
    return log, graph_digest(res["khi"], res["klo"], res["valid"],
                             res["graph"])


def layouts(base: dict, preset="ecoli", k=31) -> list:
    """The same preset through the out-of-core count, super-k-mer staging
    and the partitioned dBG on one device: digests must equal ecoli's."""
    log: list = []
    for extra in (["--partitions", "4"], ["--partitions", "4", "--super"],
                  ["--ext-mode", "part"], ["--ext-mode", "wide"]):
        res = scale_run(["--preset", preset, "--k", str(k), *extra])
        got = graph_digest(res["khi"], res["klo"], res["valid"], res["graph"])
        check(res["overflow"] == 0, f"{' '.join(extra)}: zero overflow", log)
        for name in ("keys", "links", "head_rank"):
            check(got[name] == base[name],
                  f"{' '.join(extra)}: {name} digest == ecoli's", log)
    return log


# ---------------------------------------------------------------------------
# Phase on four GPUs
# ---------------------------------------------------------------------------


def _kept_rows(mmer, hi, lo, count, stream, keep, parity):
    """Kept table rows as one lexsorted [n, lanes] int64 array."""
    keep = np.asarray(keep).reshape(-1)
    lanes = [mmer, hi, lo, count] + ([stream] if parity else [])
    cols = [np.asarray(a).reshape(-1)[keep].astype(np.int64) for a in lanes]
    rows = np.stack(cols, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def four(preset="ecoli", k=31, m=7, cutoff=1, n_devices=4) -> list:
    """The multi-device path on a 1-D mesh of ``n_devices`` against the
    same work on device 0 alone."""
    import jax
    import jax.numpy as jnp

    from genome_assembly_tpu.config import PipelineConfig
    from genome_assembly_tpu.models.pipeline import FastAssembler
    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import dbg, minimizer
    from genome_assembly_tpu.parallel import mesh as mesh_lib
    from genome_assembly_tpu.parallel import part_dbg, ragged, shard_count

    from tools import run_scale

    log: list = []
    mesh = mesh_lib.make_mesh(n_devices)
    check(len(mesh.devices.flat) == n_devices, f"{n_devices}-device mesh", log)
    log.append(f"ragged-all-to-all native on this mesh: "
               f"{ragged.has_native(mesh)}")
    cfg = run_scale.PRESETS[preset]
    read_len = cfg["read_len"]
    simulate = jax.jit(lambda i: run_scale.virtual_reads(0, i, cfg))
    reads_codes = np.concatenate([
        np.asarray(simulate(b)) for b in range(run_scale.batch_count(cfg))
    ])
    n = reads_codes.shape[0] - reads_codes.shape[0] % n_devices
    reads_codes = reads_codes[:n]
    codes = np.zeros((n, 128), dtype=np.uint8)
    codes[:, :read_len] = reads_codes
    lengths = np.full((n,), read_len, dtype=np.int32)
    rids = np.arange(n, dtype=np.uint32)
    sharding = mesh_lib.batch_sharding(mesh)
    codes_s, lengths_s, rids_s = (
        jax.device_put(a, sharding) for a in (codes, lengths, rids)
    )
    check(len(codes_s.sharding.device_set) == n_devices
          and all(s.data.shape[0] == n // n_devices
                  for s in codes_s.addressable_shards),
          f"{n} reads spread as {n // n_devices} rows on each device", log)

    for parity in (True, False):
        scan = minimizer.parity_scan if parity else minimizer.fast_scan
        recs = scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m)
        ref = count_ops.count_and_prune(recs, jnp.asarray(rids),
                                        cutoff=cutoff)
        want = _kept_rows(ref.mmer, ref.kmer_hi, ref.kmer_lo, ref.count,
                          ref.stream_idx, ref.keep, parity)
        del recs, ref
        for routing in ("padded", "ragged"):
            for route_by in (("mmer",) if parity else ("mmer", "key")):
                tag = (f"{'parity' if parity else 'fast'} {routing} "
                       f"route_by={route_by}")
                t0 = time.perf_counter()
                sc = shard_count.sharded_count(
                    codes_s, lengths_s, rids_s, k=k, m=m, parity=parity,
                    cutoff=cutoff, mesh=mesh, routing=routing,
                    route_by=route_by,
                )
                check(int(np.sum(np.asarray(sc.overflow))) == 0,
                      f"{tag}: zero overflow "
                      f"({time.perf_counter() - t0:.2f} s incl. compile)", log)
                check(len(sc.kmer_hi.sharding.device_set) == n_devices,
                      f"{tag}: table spread over {n_devices} devices", log)
                got = _kept_rows(sc.mmer, sc.kmer_hi, sc.kmer_lo, sc.count,
                                 sc.stream_idx, sc.keep, parity)
                check(np.array_equal(got, want),
                      f"{tag}: kept table == device 0 ({len(want)} rows)",
                      log)
                del sc

    # partitioned dBG over the kept keys of the fast count
    recs = minimizer.fast_scan(jnp.asarray(codes), jnp.asarray(lengths),
                               k=k, m=m)
    khi, klo, valid = count_ops.kept_keys_sorted(
        count_ops.count_keys(recs, cutoff=cutoff))
    del recs
    n_kept = int(jnp.sum(valid))
    pad = n_devices * -(-n_kept // n_devices)
    khi, klo, valid = khi[:pad], klo[:pad], valid[:pad]
    links = dbg.build_unitig_links_join(khi, klo, valid, k=k)
    graph = dbg.pointer_jump(links)
    want_links = np.asarray(links)
    kh, kl, va = (jax.device_put(a, sharding) for a in (khi, klo, valid))
    p_links, ovf = part_dbg.partitioned_unitig_links_join(
        kh, kl, va, k=k, mesh=mesh)
    check(int(np.sum(np.asarray(ovf))) == 0, "links join: zero overflow", log)
    check(np.array_equal(np.asarray(p_links), want_links),
          f"links join == device 0 ({2 * pad} states)", log)
    p_graph, ovf = part_dbg.partitioned_pointer_jump(p_links, mesh=mesh)
    check(int(np.sum(np.asarray(ovf))) == 0, "pointer jump: zero overflow",
          log)
    for name in ("head", "rank", "is_cycle"):
        check(np.array_equal(np.asarray(getattr(p_graph, name)),
                             np.asarray(getattr(graph, name))),
              f"pointer jump {name} == device 0", log)
    no, nl, ovf = part_dbg.partitioned_unitig_links_join_wide(
        kh, kl, va, k=k, mesh=mesh)
    check(int(np.sum(np.asarray(ovf))) == 0, "wide links: zero overflow",
          log)
    rows2 = 2 * pad // n_devices
    no_np, nl_np = np.asarray(no).astype(np.int64), np.asarray(nl)
    check(np.array_equal(np.where(no_np >= 0, no_np * rows2 + nl_np, -1),
                         want_links), "wide links == device 0", log)
    wg, ovf = part_dbg.partitioned_pointer_jump_wide(no, nl, mesh=mesh)
    check(int(np.sum(np.asarray(ovf))) == 0, "wide jump: zero overflow", log)
    head = (np.asarray(wg.head_owner).astype(np.int64) * rows2
            + np.asarray(wg.head_local))
    rank = ((np.asarray(wg.rank_hi).astype(np.int64) << 32)
            | np.asarray(wg.rank_lo).astype(np.int64))
    check(np.array_equal(head, np.asarray(graph.head))
          and np.array_equal(rank, np.asarray(graph.rank))
          and np.array_equal(np.asarray(wg.is_cycle),
                             np.asarray(graph.is_cycle)),
          "wide jump (head, rank, is_cycle) == device 0", log)
    del links, graph, p_links, p_graph, no, nl, wg

    # the library surface: FastAssembler over the mesh vs device 0
    reads = codes_to_strings(reads_codes)
    acfg = PipelineConfig(k=k, m=m, parity=False, abundance_cutoff=cutoff,
                          max_read_len=128, batch_reads=cfg["batch"])
    t0 = time.perf_counter()
    single, _ = FastAssembler(acfg).unitigs(reads)
    t1 = time.perf_counter()
    sharded, _ = FastAssembler(acfg).unitigs(reads, mesh=mesh)
    t2 = time.perf_counter()
    check(sorted(single) == sorted(sharded),
          f"FastAssembler.unitigs(mesh) == device 0 ({len(single)} unitigs; "
          f"{t1 - t0:.1f} s on device 0, {t2 - t1:.1f} s on the mesh, "
          "compile included)", log)
    return log


# ---------------------------------------------------------------------------


def _header(jax) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    from genome_assembly_tpu.utils.cache import cache_dir

    dev = jax.devices()[0]
    print(f"nvidia-smi: {smi}")
    print(f"device_kind: {dev.device_kind}")
    print(f"bytes_limit: {dev.memory_stats()['bytes_limit']}")
    print(f"jax: {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    print(f"compile cache: {cache_dir()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    from genome_assembly_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    _header(jax)

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log = out[0] if isinstance(out, tuple) else out
        print(f"[{name}] {time.perf_counter() - t0:.1f} s")
        for line in log:
            print(f"  {line}")
        sys.stdout.flush()
        return out

    if args.four:
        phase("four", four)
    else:
        with tempfile.TemporaryDirectory() as work:
            phase("fast-exact", fast_exact, work)
            phase("parity-exact", parity_exact, work)
        _, base = phase("ecoli", ecoli)
        phase("layouts", layouts, base)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
