"""Genome-scale fast-pipeline run (BASELINE.json configs).

Simulates reads from a synthetic genome ON DEVICE (no host->device read
transfer), runs the full fast count -> prune -> dBG link -> pointer-jump
pipeline, and reports device-side stats + phase timings as JSON lines.

  python tools/run_scale.py --preset ecoli      # ~4.6 Mbp, 50x, K=31
  python tools/run_scale.py --preset small      # quick CPU-sized check

All phases are jitted; each phase wall ends in a scalar readback, which
waits for the device.  ``run(argv)`` is the importable form: it returns
the run's counts (and, with ``keep_arrays``, host copies of the kept keys
and the compacted graph) instead of an exit code.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


PRESETS = {
    "small": dict(genome_len=200_000, coverage=10, read_len=100, batch=16384,
                  kept_cap=1 << 19),
    "ecoli": dict(genome_len=4_600_000, coverage=50, read_len=100, batch=65536,
                  kept_cap=1 << 23),
    "celegans": dict(genome_len=100_000_000, coverage=30, read_len=100,
                     batch=131072, kept_cap=1 << 27),
    # largest scale whose --ext-mode part/wide one-device self-exchange
    # fits a 16 GB budget: the links join stages ALL 4N boundary records
    # (3-4 uint32 lanes) plus a same-size exchange copy and a 4-lane sort,
    # ~7 GB peak at 64M states.  celegans (200M states) needs ~13 GB for
    # the sort alone -- the partitioned engine's memory is WHY it shards.
    "mid": dict(genome_len=32_000_000, coverage=30, read_len=100,
                batch=131072, kept_cap=1 << 26),
    # human chromosome 1 scale (248.9 Mbp), 30x -- the largest configuration
    # whose pointer-jump tables (2 x 500M states x 2 lanes x 4 B = 8 GB)
    # still fit a 16 GB budget; links and keys are host-parked
    # (--park-keys --park-links) to rehearse the 3 Gbp memory plan
    "chr1": dict(genome_len=250_000_000, coverage=30, read_len=100,
                 batch=131072, kept_cap=1 << 28),
    # BASELINE.json config 5 (full human genome, 3 Gbp x 30x).  The COUNT
    # runs on one device (resumable, ~500 partitions); the extension's
    # state ids exceed int32 at ~6G states, so single-array extension is
    # guarded off -- config 5's extension is the partitioned dBG on a
    # multi-device mesh (parallel/part_dbg.py), see SCALE.md.
    "humanchr": dict(genome_len=3_000_000_000, coverage=30, read_len=100,
                     batch=131072, kept_cap=3_200_000_000),
}


def batch_count(cfg) -> int:
    """Read batches of a preset (reads round up to whole batches)."""
    n_reads = int(cfg["genome_len"] * cfg["coverage"] / cfg["read_len"])
    return max(1, -(-n_reads // cfg["batch"]))


def sample_starts(kb, *, genome_len: int, batch: int, read_len: int):
    """[batch] uint32 read start positions drawn from PRNG key ``kb``."""
    import jax
    import jax.numpy as jnp

    if genome_len - read_len < (1 << 31):
        return jax.random.randint(
            kb, (batch,), 0, genome_len - read_len, dtype=jnp.int32
        ).astype(jnp.uint32)
    # randint's int32 maxval overflows at 3 Gbp: sample 32 uniform
    # bits and reduce mod the range (bias < 2^-31 -- synthetic data)
    return jax.random.bits(kb, (batch,), jnp.uint32) % jnp.uint32(
        genome_len - read_len
    )


def virtual_reads(seed: int, batch_idx, cfg):
    """[batch, read_len] base codes of read batch ``batch_idx`` of the
    virtual genome ``seed`` -- exactly the reads ``run`` scans under
    --virtual-genome."""
    import jax

    from genome_assembly_tpu.ops import vgenome

    kr = jax.random.split(jax.random.PRNGKey(seed))[1]
    starts = sample_starts(
        jax.random.fold_in(kr, batch_idx), genome_len=cfg["genome_len"],
        batch=cfg["batch"], read_len=cfg["read_len"],
    )
    return vgenome.read_batch(seed, starts, cfg["read_len"])


def main(argv=None) -> int:
    return run(argv)["rc"]


def run(argv=None, *, keep_arrays: bool = False) -> dict:
    """Run the scale pipeline; returns its results as a dict.

    Keys: rc (the exit code ``main`` returns), n_kept, n_distinct,
    overflow (count + link + jump routing overflows), unitigs (the
    materialized strings, or None).  keep_arrays adds host numpy copies
    of khi / klo / valid and graph (a dbg.CompactedGraph), taken before
    --materialize consumes the device graph.
    """
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=PRESETS, default="ecoli")
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--cutoff", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--count-only", action="store_true",
                    help="stop after the count (skip dBG compaction)")
    ap.add_argument(
        "--partitions",
        type=int,
        default=0,
        help="out-of-core passes for the count (0 = auto from a ~3 GB "
        "record budget; 1 = in-core).  Each pass re-scans the reads and "
        "counts one key-hash partition fully on device (ops/outofcore.py)",
    )
    ap.add_argument(
        "--group-budget-gb",
        type=float,
        default=8.0,
        help="device staging budget (GB) for out-of-core partition groups; "
        "sets how many partitions each re-scan pass extracts "
        "(ops/outofcore.partitioned_count group sizing)",
    )
    ap.add_argument(
        "--super",
        action="store_true",
        dest="super_records",
        help="stage the out-of-core count as SUPER-K-MER records "
        "(ops/superkmer.py): ~10 windows per 24 B record at k=31/m=7, so "
        "each re-scan pass extracts ~3-4x more partitions per staging "
        "budget and the pass count drops accordingly",
    )
    ap.add_argument(
        "--link-partitions",
        type=int,
        default=0,
        help="out-of-core passes for link building (0 = auto from a ~1 GB "
        "per-partition record budget; 1 = in-core single-sort join)",
    )
    ap.add_argument(
        "--link-chunk",
        type=int,
        default=1 << 23,
        help="nodes per chunk when regenerating boundary records "
        "out-of-core (ops/dbg.build_unitig_links_ooc)",
    )
    ap.add_argument(
        "--park-keys",
        action="store_true",
        help="keep the kept-key arrays in host RAM; the link builder "
        "re-uploads them chunk-by-chunk per pass (removes the key arrays "
        "from device residency -- required at 3 Gbp where they are 24 GB)",
    )
    ap.add_argument(
        "--park-links",
        action="store_true",
        help="accumulate the 2N link array in host RAM from compacted "
        "per-partition edge readbacks (removes the link array from device "
        "residency during the build; it is re-uploaded once for the jump)",
    )
    ap.add_argument(
        "--materialize",
        action="store_true",
        help="host-materialize the unitig strings after the jump and "
        "report their count/total length (memory-heavy at chr scale)",
    )
    ap.add_argument(
        "--jump-checkpoint-every",
        type=int,
        default=8,
        help="doubling rounds between jump frontier checkpoints (each "
        "save reads the multi-GB frontier back to the host; 0 "
        "disables jump checkpoints while keeping count checkpoints)",
    )
    ap.add_argument(
        "--checkpoint-dir",
        default="",
        help="directory for resumable out-of-core count partition "
        "checkpoints (killed runs resume at the last finished pass)",
    )
    ap.add_argument(
        "--part-range",
        default="",
        metavar="LO:HI",
        help="count ONLY out-of-core partitions [LO, HI) into the shared "
        "--checkpoint-dir (the multi-host pass division of SCALE.md "
        "section 2: each host takes a disjoint range, then a rangeless "
        "run merges every partition with zero re-scans); implies "
        "--count-only semantics for this worker",
    )
    ap.add_argument(
        "--ext-mode",
        choices=("bulk", "part", "wide"),
        default="bulk",
        help="extension engine: 'bulk' = the single-array sort-join + "
        "pointer jump (default); 'part' / 'wide' = the distributed "
        "partitioned dBG (parallel/part_dbg.py) on a ONE-device mesh -- "
        "the one-device form of the multi-device extension "
        "with int32 global ids ('part') or wide (shard,local) ids + "
        "64-bit ranks ('wide').  On one shard the links join stages "
        "every boundary record as self-exchange (its staging is the "
        "whole record set, so this mode is memory-bound well below the "
        "bulk engine's ceiling), while the jump's routed gathers stage "
        "nothing (local requests bypass the queue)",
    )
    ap.add_argument(
        "--virtual-genome",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="derive read bases directly from (seed, position) with a "
        "counter hash (ops/vgenome.py) instead of materializing the "
        "genome on device -- no regeneration cost on resume and no "
        "genome residency in device memory.  Default: on, except with "
        "--cpu, where generation is cheap and old goldens compare",
    )
    ap.add_argument(
        "--scan-chunk",
        type=int,
        default=0,
        help="batches fused per dispatch in the out-of-core re-scan "
        "passes (lax.scan inside one jit; outofcore scan_chunk), which "
        "amortizes per-dispatch host cost over many small batches.  "
        "0 = auto (16 out-of-core, 1 in-core); 1 = one dispatch per "
        "batch",
    )
    args = ap.parse_args(argv)
    cfg = PRESETS[args.preset]

    from genome_assembly_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import dbg, minimizer

    K, M, CUTOFF = args.k, args.m, args.cutoff
    G = cfg["genome_len"]
    read_len = cfg["read_len"]
    batch = cfg["batch"]
    n_batches = batch_count(cfg)
    n_reads = n_batches * batch
    L = 128
    n_win = L - K + 1
    total_slots = n_reads * n_win
    kept_cap = cfg["kept_cap"]

    def emit(event, **kw):
        print(json.dumps({"event": event, **kw}), flush=True)

    result = {"rc": 0, "n_kept": None, "n_distinct": None, "overflow": 0,
              "unitigs": None}

    def done(rc):
        result["rc"] = rc
        return result

    emit(
        "config", preset=args.preset, genome_len=G, n_reads=n_reads, k=K, m=M,
        total_window_slots=total_slots,
    )

    key = jax.random.PRNGKey(args.seed)
    kg, kr = jax.random.split(key)

    # the genome lives as an OVERLAPPED 2-D array [n_rows, ROW + read_len]
    # (row r = bases [r*ROW, r*ROW + ROW + read_len)): a read gather then
    # needs only two SMALL int32 index lanes (row, col).  A flat 3 Gbp
    # array would need int64 gather indices, which x64-off jax silently
    # truncates to int32 -- wrapping every start past 2^31 to wrong bases.
    ROW = 1 << 20
    n_rows = (G + ROW - 1) // ROW

    @jax.jit
    def make_genome(kg):
        flat = jax.random.randint(kg, (G,), 0, 4, dtype=jnp.int32).astype(
            jnp.uint8
        )
        pad = jnp.zeros((n_rows * ROW + ROW - G,), dtype=jnp.uint8)
        flat = jnp.concatenate([flat, pad])
        main = flat[: n_rows * ROW].reshape(n_rows, ROW)
        nxt = flat[ROW : ROW + n_rows * ROW].reshape(n_rows, ROW)
        return jnp.concatenate([main, nxt[:, :read_len]], axis=1)

    # --virtual-genome: derive read bases directly from (seed, position)
    # with the counter hash (ops/vgenome.py) -- no genome materialization
    # on every resume, no 3 GB residency, no per-batch row gather.  --cpu
    # keeps the materialized genome so old goldens stay comparable.
    use_virtual = args.virtual_genome
    if use_virtual is None:
        use_virtual = not args.cpu
    # read CONTENT depends on the source (virtual counter-hash vs
    # materialized jax.random genome) under identical batch geometry;
    # the checkpoint fingerprint must tell them apart or a resume mixes
    # datasets silently
    dataset_tag = f"{'vg' if use_virtual else 'gen'}-seed{args.seed}"

    def batch_reads(genome, kr, batch_idx):
        """[batch, read_len] base codes for one simulated read batch."""
        if use_virtual:
            return virtual_reads(args.seed, batch_idx, cfg)
        starts = sample_starts(
            jax.random.fold_in(kr, batch_idx), genome_len=G, batch=batch,
            read_len=read_len,
        )
        row = (starts // jnp.uint32(ROW)).astype(jnp.int32)
        col = (starts % jnp.uint32(ROW)).astype(jnp.int32)
        offs = jax.lax.broadcasted_iota(jnp.int32, (batch, read_len), 1)
        return genome[row[:, None], col[:, None] + offs]

    @jax.jit
    def simulate_and_scan(genome, kr, batch_idx):
        """One batch: sample starts, gather reads, fast scan -> key lanes."""
        reads = batch_reads(genome, kr, batch_idx)
        codes = jnp.zeros((batch, L), dtype=jnp.uint8).at[:, :read_len].set(reads)
        lengths = jnp.full((batch,), read_len, dtype=jnp.int32)
        recs = minimizer.fast_scan(codes, lengths, k=K, m=M)
        sent = jnp.uint32(0xFFFFFFFF)
        hi = jnp.where(recs.valid, recs.kmer_hi, sent).reshape(-1)
        lo = jnp.where(recs.valid, recs.kmer_lo, sent).reshape(-1)
        return hi, lo

    @jax.jit
    def global_count(hi_all, lo_all):
        recs = minimizer.WindowRecords(
            mmer=jnp.zeros((0,), jnp.uint32),
            kmer_hi=hi_all,
            kmer_lo=lo_all,
            valid=hi_all != jnp.uint32(0xFFFFFFFF),
        )
        kc = count_ops.count_keys(recs, cutoff=CUTOFF)
        khi, klo, valid = count_ops.kept_keys_sorted(kc)
        n_distinct = jnp.sum(kc.group_start & kc.valid)
        n_kept = jnp.sum(kc.keep)
        return khi[:kept_cap], klo[:kept_cap], valid[:kept_cap], n_distinct, n_kept

    @jax.jit
    def _graph_stats_jit(head, rank, is_cycle, valid):
        ids = jnp.arange(head.shape[0], dtype=jnp.int32)
        # flat gather, not repeat: no [N, 2] pred broadcast is materialized
        node_valid = valid[ids >> 1]
        # a linear chain's head state is its own head (isolated states too)
        lin_heads = jnp.sum((head == ids) & node_valid & ~is_cycle)
        n_cyc_states = jnp.sum(is_cycle & node_valid)
        max_rank = jnp.max(jnp.where(node_valid, rank, 0))
        return lin_heads, n_cyc_states, max_rank

    def graph_stats(head, rank, is_cycle, valid):
        a, b, c = _graph_stats_jit(
            jnp.asarray(head), jnp.asarray(rank),
            jnp.asarray(is_cycle), jnp.asarray(valid),
        )
        return int(a), int(b), int(c)

    t0 = time.perf_counter()
    if use_virtual:
        genome = None
        emit("genome", wall_s=0.0, virtual=True)
    else:
        genome = make_genome(kg)
        float(genome[0, 0])
        emit("genome", wall_s=round(time.perf_counter() - t0, 3))

    partitions = args.partitions
    if partitions == 0:
        # In-core while the full record set is under a 3 GB budget (count
        # peak is ~4x resident).  Out-of-core sizing must count the GROUP
        # staging: while partition r of a group is counted, the group's
        # other partitions' staging is still resident, so peak ~
        # (GROUP + 3) x per-partition bytes -- a 1 GB per-partition budget
        # keeps that under 16 GB.
        in_core_limit = 3 * (1 << 30)
        per_part = 1 << 30
        total_bytes = total_slots * 8
        if total_bytes <= in_core_limit:
            partitions = 1
        else:
            partitions = int(np.ceil(total_bytes / per_part))
    if partitions > 1:
        # out-of-core: re-scan per pass; scan+count are interleaved
        from genome_assembly_tpu.ops import outofcore

        scan_chunk = args.scan_chunk if args.scan_chunk else 16
        part_range = None
        if args.part_range:
            lo_s, hi_s = args.part_range.split(":")
            part_range = (int(lo_s), int(hi_s))
        t0 = time.perf_counter()
        _last_prog = [0.0]

        def _progress(g, ng, b, nb):
            # dispatch-stream liveness for multi-hour silent passes
            # (humanchr: 6,867 batches/pass with no event until pass end)
            now = time.monotonic()
            if now - _last_prog[0] >= 60 or b >= nb:
                _last_prog[0] = now
                print(
                    f"[progress] group {g + 1}/{ng} "
                    f"dispatched {b}/{nb} batches",
                    file=sys.stderr, flush=True,
                )

        if args.super_records:
            from genome_assembly_tpu.ops import superkmer

            @jax.jit
            def simulate_super(genome, kr, batch_idx):
                reads = batch_reads(genome, kr, batch_idx)
                codes = jnp.zeros((batch, L), dtype=jnp.uint8)
                codes = codes.at[:, :read_len].set(reads)
                lengths = jnp.full((batch,), read_len, dtype=jnp.int32)
                return superkmer.super_records(codes, lengths, k=K, m=M)

            emit(
                "outofcore_super", requested_partitions=partitions,
                part_range=part_range,
            )
            pc = outofcore.partitioned_count_super(
                lambda b: simulate_super(genome, kr, b),
                n_batches,
                k=K,
                m=M,
                partitions=0,  # sized from the expansion budget + probe
                cutoff=CUTOFF,
                kept_cap=kept_cap,
                group_budget_bytes=int(args.group_budget_gb * (1 << 30)),
                checkpoint_dir=args.checkpoint_dir or None,
                return_host=args.park_keys,
                scan_chunk=scan_chunk,
                only_partitions=part_range,
                on_progress=_progress,
                dataset_tag=dataset_tag,
            )
        else:
            emit("outofcore", partitions=partitions, part_range=part_range)
            pc = outofcore.partitioned_count(
                lambda b: simulate_and_scan(genome, kr, b),
                n_batches,
                partitions=partitions,
                cutoff=CUTOFF,
                kept_cap=kept_cap,
                group_budget_bytes=int(args.group_budget_gb * (1 << 30)),
                checkpoint_dir=args.checkpoint_dir or None,
                return_host=args.park_keys,
                scan_chunk=scan_chunk,
                only_partitions=part_range,
                on_progress=_progress,
                dataset_tag=dataset_tag,
            )
        if part_range is not None:
            emit(
                "count_worker_done",
                part_range=list(part_range),
                n_kept=int(pc.n_kept),
                n_distinct=int(pc.n_distinct),
                overflows=int(pc.batch_overflows),
            )
            return done(0)
        result["overflow"] += int(pc.batch_overflows)
        assert pc.batch_overflows == 0, "raise outofcore slack"
        assert not pc.kept_overflow, f"raise kept_cap (kept={pc.n_kept})"
        khi, klo, valid = pc.kmer_hi, pc.kmer_lo, pc.valid
        kept_cap = khi.shape[0]
        n_distinct, n_kept = pc.n_distinct, pc.n_kept
        group_size = pc.group_size
        partitions = pc.partitions or partitions
        pc = None  # the NamedTuple aliases the key arrays; drop it so
        # del khi/klo in the extension branch actually frees device memory
        # out-of-core interleaves re-scan and count passes, so the split
        # scan/count timing of the in-core branch does not exist; emit ONE
        # combined event whose rate is end-to-end comparable across modes.
        scan_wall = 0.0
        count_wall = time.perf_counter() - t0
        emit(
            "scan_and_count",
            wall_s=round(count_wall, 3),
            kmers_scanned_and_counted_per_s=round(total_slots / count_wall, 1),
            distinct=n_distinct,
            kept=n_kept,
            group_size=group_size,
            partitions=partitions,
            passes=-(-partitions // group_size),
        )
    else:
        t0 = time.perf_counter()
        his, los = [], []
        for b in range(n_batches):
            hi, lo = simulate_and_scan(genome, kr, b)
            his.append(hi)
            los.append(lo)
        hi_all = jnp.concatenate(his)
        lo_all = jnp.concatenate(los)
        float(hi_all[-1])
        scan_wall = time.perf_counter() - t0
        emit(
            "scan",
            wall_s=round(scan_wall, 3),
            windows_per_s=round(total_slots / scan_wall, 1),
        )

        t0 = time.perf_counter()
        khi, klo, valid, n_distinct, n_kept = global_count(hi_all, lo_all)
        n_distinct = int(n_distinct)
        n_kept = int(n_kept)
        count_wall = time.perf_counter() - t0
        assert n_kept <= kept_cap, f"raise kept_cap: {n_kept} > {kept_cap}"
        emit(
            "count",
            wall_s=round(count_wall, 3),
            kmers_counted_per_s=round(total_slots / count_wall, 1),
            distinct=n_distinct,
            kept=n_kept,
        )

    genome = None  # dead after the scan passes; frees G bytes of device
    result["n_kept"], result["n_distinct"] = int(n_kept), int(n_distinct)

    if args.count_only:
        emit("total", wall_s=round(scan_wall + count_wall, 3),
             end_to_end_kmers_per_s=round(
                 total_slots / max(scan_wall + count_wall, 1e-9), 1))
        return done(0)

    t0 = time.perf_counter()
    if 2 * kept_cap > 2**31:
        # single-array extension addresses states with int32; ~6G states at
        # 3 Gbp exceed it.  Config 5's extension is the partitioned dBG
        # over a device mesh (parallel/part_dbg.py: per-shard state
        # ranges), not a bigger single array -- see SCALE.md.
        emit("extension_skipped",
             reason="states exceed int32; use the partitioned dBG on a "
             "multi-device mesh (run with --count-only on one device)")
        return done(1)

    n_nodes = int(khi.shape[0])
    link_partitions = args.link_partitions
    if link_partitions == 0:
        # records = 4 rows/node x 3 uint32 lanes; sort peak ~3x resident
        rec_bytes = 4 * n_nodes * 12
        link_budget = 1 << 30
        link_partitions = (
            1 if rec_bytes <= 3 * link_budget
            else int(np.ceil(rec_bytes / link_budget))
        )
    if 2 * n_nodes > (1 << 26) or args.park_keys:
        # host copies are the extension inputs: the device key buffers
        # free before the jump (the chr-scale memory plan needs that room)
        khi = np.asarray(khi)
        klo = np.asarray(klo)
        valid = np.asarray(valid)

    def run_extension_partitioned(khi, klo, valid):
        """--ext-mode part|wide: the distributed dBG on a 1-device mesh.

        Measures the partitioned engines' walls on one device (the wide
        pipeline's extra lane traffic and 64-bit rank carries).  Jump slack is sized so the routed-gather queues are ~empty: on
        one shard every request is local and bypasses the queue, so cap
        can be O(1) without overflow (overflow counters still verify).
        """
        from jax.sharding import Mesh

        from genome_assembly_tpu.parallel import part_dbg

        mesh = Mesh(np.array(jax.devices()[:1]), (part_dbg.SHARD_AXIS,))
        kh, kl, va = jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid)
        rows2 = 2 * int(kh.shape[0])
        jump_slack = 2.0 / rows2  # cap=2 on one shard (all-local gathers)
        t0l = time.perf_counter()
        if args.ext_mode == "wide":
            no, nl, lovf = part_dbg.partitioned_unitig_links_join_wide(
                kh, kl, va, k=K, mesh=mesh, slack=1.0
            )
            lovf_n = int(np.sum(np.asarray(lovf)))  # hard sync
            emit("links", wall_s=round(time.perf_counter() - t0l, 3),
                 mode="wide", overflow=lovf_n)
            result["overflow"] += lovf_n
            assert lovf_n == 0, "raise link slack"
            t0j = time.perf_counter()
            wg, jovf = part_dbg.partitioned_pointer_jump_wide(
                no, nl, mesh=mesh, slack=jump_slack
            )
            jovf_n = int(np.sum(np.asarray(jovf)))  # hard sync
            emit("jump", wall_s=round(time.perf_counter() - t0j, 3),
                 mode="wide", overflow=jovf_n)
            result["overflow"] += jovf_n
            assert jovf_n == 0, "raise jump slack"
            # host int64 graph, exactly the models/pipeline.py conversion
            # (one shard: owner == 0, so global id == local id)
            no_np = np.asarray(no).astype(np.int64)
            nl_np = np.asarray(nl).astype(np.int64)
            rank64 = (np.asarray(wg.rank_hi).astype(np.int64) << 32) | (
                np.asarray(wg.rank_lo).astype(np.int64)
            )
            graph = dbg.CompactedGraph(
                next_state=np.where(no_np >= 0, no_np * rows2 + nl_np, -1),
                head=(
                    np.asarray(wg.head_owner).astype(np.int64) * rows2
                    + np.asarray(wg.head_local).astype(np.int64)
                ),
                rank=rank64,
                is_cycle=np.asarray(wg.is_cycle),
            )
            lin_heads, n_cyc_states, max_rank = graph_stats(
                jnp.asarray(graph.head.astype(np.int32)),
                jnp.asarray(graph.rank.astype(np.int32)),
                jnp.asarray(graph.is_cycle),
                va,
            )
        else:
            links, lovf = part_dbg.partitioned_unitig_links_join(
                kh, kl, va, k=K, mesh=mesh, slack=1.0
            )
            lovf_n = int(np.sum(np.asarray(lovf)))  # hard sync
            emit("links", wall_s=round(time.perf_counter() - t0l, 3),
                 mode="part", overflow=lovf_n)
            result["overflow"] += lovf_n
            assert lovf_n == 0, "raise link slack"
            t0j = time.perf_counter()
            graph, jovf = part_dbg.partitioned_pointer_jump(
                links, mesh=mesh, slack=jump_slack
            )
            jovf_n = int(np.sum(np.asarray(jovf)))  # hard sync
            emit("jump", wall_s=round(time.perf_counter() - t0j, 3),
                 mode="part", overflow=jovf_n)
            result["overflow"] += jovf_n
            assert jovf_n == 0, "raise jump slack"
            lin_heads, n_cyc_states, max_rank = graph_stats(
                graph.head, graph.rank, graph.is_cycle, va
            )
        return khi, klo, valid, graph, lin_heads, n_cyc_states, max_rank

    def run_extension(khi, klo, valid):
        if args.ext_mode != "bulk":
            return run_extension_partitioned(khi, klo, valid)
        parts = link_partitions
        if args.park_keys or args.park_links:
            parts = max(parts, 2)
            emit("links_parked", partitions=parts,
                 chunk_nodes=args.link_chunk, park_keys=args.park_keys,
                 park_links=args.park_links)
            kh = np.asarray(khi) if args.park_keys else khi
            kl = np.asarray(klo) if args.park_keys else klo
            va = np.asarray(valid) if args.park_keys else valid
            links, link_ovf = dbg.build_unitig_links_parked(
                kh, kl, va, k=K,
                partitions=parts, chunk_nodes=args.link_chunk,
                park_links=args.park_links,
                on_event=lambda kind, **kw: emit(kind, **kw),
            )
            result["overflow"] += int(link_ovf)
            assert link_ovf == 0, "raise link slack"
            if args.park_keys:
                khi, klo, valid = kh, kl, va  # host numpy from here on
            if args.park_links:
                t_up = time.perf_counter()
                links = jnp.asarray(links)  # one upload for the jump
                float(links[0])
                emit("links_upload", wall_s=round(time.perf_counter() - t_up, 3))
            else:
                float(links[0])  # hard sync
            emit("links", wall_s=round(time.perf_counter() - t0, 3),
                 partitions=parts)
        elif parts > 1:
            emit("links_outofcore", partitions=parts,
                 chunk_nodes=args.link_chunk)
            links, link_ovf = dbg.build_unitig_links_ooc(
                khi, klo, valid, k=K,
                partitions=parts, chunk_nodes=args.link_chunk,
            )
            result["overflow"] += int(link_ovf)
            assert link_ovf == 0, "raise link slack"
            float(links[0])  # wait for the device before reading the wall
            emit("links", wall_s=round(time.perf_counter() - t0, 3),
                 partitions=parts)
        else:
            links = dbg.build_unitig_links_join(khi, klo, valid, k=K)
        # above ~64M states: per-round donated-buffer jump (pointer_jump's
        # fused while_loop double-buffers 3 full carries and OOMs at
        # celegans scale); keys are parked on the host meanwhile unless
        # materialization needs... they are re-uploaded only if needed.
        if 2 * n_nodes > 1 << 26:
            khi_h, klo_h, valid_h = (
                np.asarray(khi), np.asarray(klo), np.asarray(valid))
            del khi, klo
            valid_dev = valid
            del valid
            graph = dbg.pointer_jump_bulk(
                links,
                checkpoint_dir=(
                    str(pathlib.Path(args.checkpoint_dir) / "jump")
                    if args.checkpoint_dir and args.jump_checkpoint_every
                    else None
                ),
                checkpoint_every=max(args.jump_checkpoint_every, 1),
                on_round=lambda r, dt: emit(
                    "jump_round", round=r, wall_s=round(dt, 2)
                ),
            )
            lin_heads, n_cyc_states, max_rank = graph_stats(
                graph.head, graph.rank, graph.is_cycle, valid_dev
            )
            khi, klo, valid = khi_h, klo_h, valid_h
        else:
            graph = dbg.pointer_jump(links)
            lin_heads, n_cyc_states, max_rank = graph_stats(
                graph.head, graph.rank, graph.is_cycle, valid
            )
        return khi, klo, valid, graph, int(lin_heads), n_cyc_states, max_rank

    khi, klo, valid, graph, lin_heads, n_cyc_states, max_rank = (
        run_extension(khi, klo, valid)
    )
    ext_wall = time.perf_counter() - t0
    emit(
        "extension",
        wall_s=round(ext_wall, 3),
        linear_unitigs=lin_heads // 2,  # two strand chains per unitig
        cyclic_states=int(n_cyc_states),
        longest_chain=int(max_rank) + 1,
        states_per_s=round(2 * kept_cap / ext_wall, 1),
    )
    if keep_arrays:
        result.update(
            khi=np.asarray(khi), klo=np.asarray(klo), valid=np.asarray(valid),
            graph=dbg.CompactedGraph(*(np.asarray(a) for a in graph)),
        )
    emit(
        "total",
        wall_s=round(scan_wall + count_wall + ext_wall, 3),
        end_to_end_kmers_per_s=round(
            total_slots / (scan_wall + count_wall + ext_wall), 1
        ),
    )
    if args.materialize:
        t0 = time.perf_counter()
        if args.ext_mode == "wide":
            # the wide graph is host int64; keep everything host-side
            unitigs = dbg.materialize_unitigs(
                np.asarray(khi), np.asarray(klo), np.asarray(valid), graph, K
            )
        else:
            # device-assisted: walk sort + byte extraction on device, one
            # host placement pass; readback is 2 thin lanes + sorted ids
            # instead of the whole graph.  If the device can't hold the
            # walk sort next to the resident graph, fall back to the
            # bucketed HOST materializer (bounded host memory) rather than
            # losing the whole run at its last phase.
            try:
                unitigs, _, _ = dbg.materialize_unitigs_device(
                    khi, klo, valid, graph, K, donate=True
                )
            except Exception as exc:
                if "RESOURCE_EXHAUSTED" not in str(exc):
                    raise
                emit("materialize_fallback", reason=str(exc)[:200])
                # donate=True consumed the graph lanes: the bucketed host
                # fallback only works if the failure happened BEFORE the
                # donating walk sort dispatched (later OOMs are rescued
                # inside materialize_unitigs_device itself).  A deleted
                # graph here means both device paths are spent -- record
                # the failure and keep the run's stats instead of dying
                # at the last phase.  donate=True eagerly deletes
                # next_state BEFORE the walk sort dispatches, so a
                # compile-time OOM can leave head alive with next_state
                # already gone -- the partitioned fallback would then
                # crash on np.asarray of a deleted buffer if the graph has
                # cycles.  Any deleted lane means the device graph is
                # spent.
                spent = any(
                    getattr(lane, "is_deleted", lambda: False)()
                    for lane in (graph.head, graph.next_state)
                )
                if spent:
                    emit("materialize_failed",
                         reason="graph donated and deleted; " + str(exc)[:150])
                    unitigs = None
                else:
                    unitigs = dbg.materialize_unitigs_partitioned(
                        np.asarray(khi), np.asarray(klo), np.asarray(valid),
                        graph, K,
                    )
        if unitigs is None:
            # distinct rc: callers see a missing --materialize artifact
            # without parsing the event stream
            return done(3)
        emit(
            "materialize",
            wall_s=round(time.perf_counter() - t0, 3),
            unitigs=len(unitigs),
            total_bp=sum(len(u) for u in unitigs),
            longest_bp=max((len(u) for u in unitigs), default=0),
        )
        result["unitigs"] = unitigs
    return done(0)


if __name__ == "__main__":
    sys.exit(main())
