"""Scaling-efficiency model: exact wire traffic + interconnect roofline.

Virtual-device timing is meaningless (shared host cores), so this harness
records what a multi-device run needs to validate scaling: per-phase
exchange matrices (exact -- the routers are deterministic), off-device
byte volumes and skew, and the predicted efficiency band.  The one-device
phase rates are inputs (measure them on the device first); the
interconnect is NVLink's data-sheet rate unless overridden.  On a
multi-device host, rerun with --time to compare measured walls against
the same model.

  python tools/bench_scaling_model.py --reads 8192 --k 31 --m 7 \
      --count-rate R --link-rate R --jump-rate R --dcn-gbps G
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--read-len", type=int, default=128)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, nargs="+",
                    default=[8, 16, 64, 256])
    ap.add_argument("--parity", action="store_true",
                    help="model the 5-lane parity routing payload")
    ap.add_argument("--slices", type=int, default=2,
                    help="slice count for the pod-scale two-level ICI/DCN "
                    "phase model (reported for shard counts divisible by "
                    "it)")
    ap.add_argument("--route-by", choices=("mmer", "key"), default="mmer",
                    help="count-phase ownership: minimizer hash (parity-"
                    "compatible default) or canonical-key hash (fast-mode "
                    "balance fix for heavy-tailed minimizer mass)")
    ap.add_argument("--extension", action="store_true",
                    help="also model the distributed-extension phases "
                    "(routed link join + every pointer-jump round's "
                    "gathers) from the routers' exact traffic, for both "
                    "the int32 and the wide (shard, local) id pipelines")
    ap.add_argument("--count-rate", type=float, required=True,
                    help="measured one-device scan+count records/s")
    ap.add_argument("--link-rate", type=float, required=True,
                    help="measured one-device link-join sort rows/s")
    ap.add_argument("--jump-rate", type=float, required=True,
                    help="measured one-device pointer-jump states/s")
    ap.add_argument("--dcn-gbps", type=float, required=True,
                    help="per-device inter-host bandwidth, GB/s (two-level "
                    "model only)")
    ap.add_argument("--time", action="store_true",
                    help="also time sharded_count on the available mesh "
                    "(only meaningful on real devices)")
    ap.add_argument("--batches", type=int, default=8,
                    help="batch count for the pipelined-count model (and "
                    "for --time's pipelined vs serial comparison)")
    ap.add_argument("--cpu", action="store_true",
                    help="with --time: time on the virtual CPU mesh instead "
                    "of the accelerator (set XLA_FLAGS=--xla_force_host_"
                    "platform_device_count=N first for an N-device mesh)")
    args = ap.parse_args()

    import jax

    # the model itself is backend-independent; run it on CPU so it leaves
    # the accelerator to other processes
    if not args.time or args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    from genome_assembly_tpu.ops import count as count_ops
    from genome_assembly_tpu.ops import minimizer
    from genome_assembly_tpu.parallel import comm_model

    hw = comm_model.Hardware(
        count_records_per_s=args.count_rate,
        link_records_per_s=args.link_rate,
        jump_states_per_s=args.jump_rate,
        dcn_bytes_per_s=args.dcn_gbps * 1e9,
    )

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(
        0, 4, size=(args.reads, args.read_len), dtype=np.uint8
    )
    lengths = np.full((args.reads,), args.read_len, dtype=np.int32)

    # kept keys for the link-join phase (single-device reference count)
    recs = minimizer.fast_scan(
        jnp.asarray(codes), jnp.asarray(lengths), k=args.k, m=args.m
    )
    kc = count_ops.count_keys(recs, cutoff=0)
    khi, klo, valid = count_ops.kept_keys_sorted(kc)
    khi, klo, valid = np.asarray(khi), np.asarray(klo), np.asarray(valid)

    # routed payload widths (uint32 lanes on the wire)
    count_lanes = 5  # mmer, hi, lo, rid, stream (both modes route these)
    link_lanes = 3  # key_hi, key_lo, payload

    for n in args.shards:
        if args.reads % n or khi.shape[0] % n:
            print(json.dumps({"shards": n, "skipped": "indivisible"}))
            continue
        cmat = comm_model.count_exchange_matrix(
            codes, lengths, k=args.k, m=args.m, n_shards=n,
            parity=args.parity, route_by=args.route_by,
        )
        lmat = comm_model.links_exchange_matrix(
            khi, klo, valid, k=args.k, n_shards=n
        )
        count_phase = comm_model.phase_model(
            cmat, bytes_per_record=4 * count_lanes,
            records_per_s=hw.count_records_per_s, hw=hw,
        )
        count_pipe = comm_model.pipeline_model(
            cmat, n_batches=args.batches, bytes_per_record=4 * count_lanes,
            records_per_s=hw.count_records_per_s, hw=hw,
        )
        count_phase = {
            **count_phase,
            "n_batches": args.batches,
            "eff_pipelined": count_pipe["eff_pipelined"],
        }
        link_phase = comm_model.phase_model(
            lmat, bytes_per_record=4 * link_lanes,
            records_per_s=hw.link_records_per_s, hw=hw,
        )
        ext_rows = {}
        if args.extension:
            from genome_assembly_tpu.ops import dbg

            links_np = np.asarray(
                dbg.build_unitig_links_join(
                    jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid),
                    k=args.k,
                )
            )
            for wide in (False, True):
                ext = comm_model.extension_phase_model(
                    lmat, links_np, n_shards=n, wide=wide, hw=hw,
                )
                ext_rows["extension_wide" if wide else "extension"] = {
                    k2: round(v, 6) if isinstance(v, float) else v
                    for k2, v in ext.items() if k2 != "shards"
                }
            if n >= 2 * args.slices and n % args.slices == 0:
                # pod-scale view: ICI/DCN split of the extension's
                # traffic under the two-level layout (link records and
                # the summed jump gather requests)
                pmat, rmats, fmat = comm_model.jump_request_matrices(
                    links_np, n_shards=n
                )
                gsum = pmat + fmat
                for m2 in rmats:
                    gsum = gsum + m2
                ext_rows["extension_two_level"] = {
                    "links": {
                        k2: round(v, 6) if isinstance(v, float) else v
                        for k2, v in comm_model.two_level_split(
                            lmat, n_slices=args.slices
                        ).items()
                    },
                    "jump_requests": {
                        k2: round(v, 6) if isinstance(v, float) else v
                        for k2, v in comm_model.two_level_split(
                            gsum, n_slices=args.slices
                        ).items()
                    },
                }
        row = {
            "shards": n,
            "route_by": args.route_by,
            "count": {k2: round(v, 6) if isinstance(v, float) else v
                      for k2, v in count_phase.items() if k2 != "shards"},
            "links": {k2: round(v, 6) if isinstance(v, float) else v
                      for k2, v in link_phase.items() if k2 != "shards"},
            **ext_rows,
        }
        if n >= 4 and n % 2 == 0:
            # multi-slice view: ICI/DCN split under the two-level router
            # (parallel/two_level.py) for a 2-slice decomposition
            row["count_2slice"] = {
                k2: round(v, 6) if isinstance(v, float) else v
                for k2, v in comm_model.two_level_split(
                    cmat, n_slices=2
                ).items()
            }
        if n >= 2 * args.slices and n % args.slices == 0:
            # pod-scale walls: ICI stage + aggregated DCN stage +
            # software pipeline (Hardware.dcn_bytes_per_s is an
            # assumption -- override when the real fabric is measured)
            row["count_two_level_phase"] = {
                k2: round(v, 6) if isinstance(v, float) else v
                for k2, v in comm_model.two_level_phase_model(
                    cmat, n_slices=args.slices,
                    bytes_per_record=4 * count_lanes,
                    records_per_s=hw.count_records_per_s,
                    n_batches=args.batches, hw=hw,
                ).items()
            }
        print(json.dumps(row), flush=True)

    if args.time:
        import time

        from genome_assembly_tpu.parallel import mesh as mesh_lib
        from genome_assembly_tpu.parallel import shard_count

        n = min(max(args.shards), jax.device_count())
        mesh = mesh_lib.make_mesh(n)
        codes_j = jnp.asarray(codes)
        lengths_j = jnp.asarray(lengths)
        rids = jnp.arange(args.reads, dtype=jnp.uint32)
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            sc = shard_count.sharded_count(
                codes_j, lengths_j, rids, k=args.k, m=args.m,
                parity=args.parity, cutoff=1, mesh=mesh,
                route_by=args.route_by,
            )
            float(jnp.sum(sc.keep))  # hard sync
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(json.dumps({
            "timed_shards": n,
            "platform": jax.devices()[0].platform,
            "wall_s": round(best, 4),
            "note": "compare against count.t_compute_s + t_comm_s above "
                    "on a real slice",
        }))

        # pipelined vs serial multi-batch stream: the real-slice check of
        # the eff_pipelined prediction (one command, two numbers)
        class _B:
            def __init__(self, codes, lengths, read_ids):
                self.codes, self.lengths, self.read_ids = (
                    codes, lengths, read_ids)

        B = args.batches
        rows = args.reads // B
        rows -= rows % n
        if rows:
            batches = [
                _B(codes[i * rows:(i + 1) * rows],
                   lengths[i * rows:(i + 1) * rows],
                   np.arange(i * rows, (i + 1) * rows, dtype=np.uint32))
                for i in range(B)
            ]
            walls = {}
            for pipelined in (False, True):
                best = None
                for _ in range(3):
                    t0 = time.perf_counter()
                    sc = shard_count.sharded_count_batches(
                        batches, k=args.k, m=args.m, parity=args.parity,
                        cutoff=1, mesh=mesh, pipelined=pipelined,
                    )
                    float(jnp.sum(sc.keep))  # hard sync
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                walls["pipelined" if pipelined else "serial"] = round(best, 4)
            print(json.dumps({
                "timed_shards": n, "n_batches": B, **walls,
                "overlap_gain": round(
                    walls["serial"] / max(walls["pipelined"], 1e-9), 4),
                "note": "on a real slice overlap_gain -> "
                        "(t_comp+t_comm)/max(t_comp,t_comm); on shared-core "
                        "virtual meshes it is ~1 by construction",
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
