"""End-to-end assembly pipelines.

Mirrors the reference driver's phase structure (main, binning.c:1147-1181):
ingest -> count -> prune -> [expand] -> extend(fwd) -> extend(bwd) -> print,
with the counting phases on device and (in parity mode) the order-faithful
extension replay on the host-native engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from genome_assembly_tpu.config import PipelineConfig
from genome_assembly_tpu.io import reads as reads_io
from genome_assembly_tpu.ops import count as count_ops
from genome_assembly_tpu.ops import minimizer
from genome_assembly_tpu.parity import table as table_ops


@dataclasses.dataclass
class PhaseStats:
    """Per-phase observability counters (metrics JSONL feeds off this)."""

    n_reads: int = 0
    n_windows: int = 0
    entries_pre_prune: int = 0
    entries_post_prune: int = 0
    entries_post_extension: int = 0
    wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def _extension_graph(
    khi, klo, valid, *, k: int, link_budget: int, bulk_jump_states: int
):
    """Link + jump with the same beyond-HBM auto-switches the scale runner
    uses (tools/run_scale.py): graphs whose 4N-record join sort would
    exceed ~3x ``link_budget`` build links out-of-core
    (dbg.build_unitig_links_ooc), and state counts above
    ``bulk_jump_states`` jump with the low-memory per-round form.  The
    in-core builder + fused jump OOM exactly where the out-of-core COUNT
    path is auto-engaged, so the library must switch all three together.
    """
    from genome_assembly_tpu.ops import dbg

    n_nodes = int(khi.shape[0])
    rec_bytes = 4 * n_nodes * 12  # 4 boundary records/node x 3 uint32 lanes
    if rec_bytes <= 3 * link_budget:
        links = dbg.build_unitig_links_join(khi, klo, valid, k=k)
    else:
        # chunk regeneration granularity: the builder pads the key array
        # to a chunk multiple, so cap chunks near the input size (its
        # 2^24 default would pad small inputs by orders of magnitude)
        chunk_nodes = min(
            1 << 24, 1 << int(np.ceil(np.log2(max(n_nodes, 2))))
        )
        links, overflow = dbg.build_unitig_links_ooc(
            khi, klo, valid, k=k,
            partitions=int(np.ceil(rec_bytes / link_budget)),
            chunk_nodes=chunk_nodes,
        )
        if int(overflow):
            raise RuntimeError(
                "out-of-core link building overflowed its per-chunk "
                f"capacity slack ({int(overflow)} records); raise "
                "link_budget_bytes or the builder's slack"
            )
    if 2 * n_nodes > bulk_jump_states:
        graph = dbg.pointer_jump_bulk(links)
    else:
        graph = dbg.pointer_jump(links)
    return links, graph


class CountPipeline:
    """Device-side ingest + count + prune shared by both modes.

    In parity mode the scan replicates process_read exactly; pruned-table
    parity is order-independent (the table is a multiset keyed by
    (signature, kmer) -- SURVEY.md 2.1.4's duplicate semantics are preserved
    because the key includes the signature bin).
    """

    def __init__(self, config: PipelineConfig):
        self.config = config

    def scan(self, codes: jnp.ndarray, lengths: jnp.ndarray) -> minimizer.WindowRecords:
        cfg = self.config
        if cfg.parity:
            return minimizer.parity_scan(codes, lengths, k=cfg.k, m=cfg.m)
        return minimizer.fast_scan(codes, lengths, k=cfg.k, m=cfg.m)

    def count_reads(
        self, reads: Sequence[str], start_id: int = 0
    ) -> Tuple[count_ops.CountedTable, PhaseStats]:
        """Count a full read set (batching + merge handled here)."""
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        batches = reads_io.batch_reads(
            reads, cfg.max_read_len, cfg.batch_reads, start_id=start_id,
            parity_chars=cfg.parity,
        )
        if not batches:
            raise ValueError("no reads")
        # Pad the final batch so every batch shares one compiled shape.
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
        per_batch = []
        final_cutoff = cfg.abundance_cutoff
        # single batch: prune directly; multi-batch: count with cutoff -1,
        # merge, then prune (a k-mer's occurrences may span batches).
        cutoff = final_cutoff if len(batches) == 1 else -1
        n_win = cfg.max_read_len - cfg.k + 1
        # double-buffered feed: batch t+1's transfers stage while t computes
        from genome_assembly_tpu.io import stream as stream_io

        # close() on exit: if the scan/count raises mid-loop the staging
        # worker stops instead of blocking forever on a full queue
        with stream_io.feed_read_batches(batches) as feeder:
            for bi, (codes, lengths, rids) in enumerate(feeder):
                recs = self.scan(codes, lengths)
                per_batch.append(
                    count_ops.count_and_prune(
                        recs,
                        rids,
                        cutoff=cutoff,
                        stream_offset=bi * cfg.batch_reads * n_win,
                    )
                )
                stats.n_windows += int(np.sum(np.asarray(recs.valid)))
        if len(per_batch) == 1:
            counted = per_batch[0]
        else:
            counted = count_ops.merge_sorted_tables(per_batch, cutoff=final_cutoff)
        stats.entries_pre_prune = int(counted.n_entries)
        stats.entries_post_prune = int(counted.n_kept)
        return counted, stats


class FastAssembler:
    """Throughput pipeline: true canonical k-mers, device dBG compaction.

    No reference quirks: proper reverse complements, strand-symmetric
    minimizers (used for sharding), value-complete neighbor lookups.  The
    unitig phase is parallel pointer jumping (ops/dbg.py) instead of the
    reference's serial greedy merge.
    """

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig(parity=False)
        if self.config.parity:
            raise ValueError("FastAssembler requires parity=False config")
        if self.config.k % 2 == 0:
            # fail before any device work: the dBG phase needs odd k (no
            # reverse-complement palindromes), and surfacing that only
            # after counting wastes a large scan+sort (or a remote compile)
            raise ValueError(
                "fast-mode assembly requires odd k (reverse-complement "
                f"palindromes break dBG strand pairing); got k={self.config.k}"
            )
        self.counter = CountPipeline(self.config)

    def load(self, path: str) -> List[str]:
        return reads_io.load_reads_fast(path)

    def unitigs_from_sequences(
        self, sequences: Sequence[str]
    ) -> Tuple[List[str], PhaseStats]:
        """Assemble from arbitrarily long sequences (contigs, genomes).

        Sequences longer than max_read_len are split into k-1-overlapping
        chunks so every window is scanned exactly once (the single-device
        analogue of parallel/halo.py's exchange).
        """
        cfg = self.config
        chunks: List[str] = []
        for s in sequences:
            if len(s) <= cfg.max_read_len:
                chunks.append(s)
            else:
                chunks.extend(
                    reads_io.chunk_long_sequence(s, cfg.max_read_len, cfg.k)
                )
        return self.unitigs(chunks)

    def unitigs(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], PhaseStats]:
        from genome_assembly_tpu.ops import dbg

        cfg = self.config
        if mesh is not None:
            return self._unitigs_sharded(reads, mesh)
        stats = PhaseStats(n_reads=len(reads))
        batches = reads_io.batch_reads(
            reads, cfg.max_read_len, cfg.batch_reads
        )
        if not batches:
            raise ValueError("no reads")
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)

        n_win = cfg.max_read_len - cfg.k + 1
        total_slots = len(batches) * cfg.batch_reads * n_win
        if total_slots * 8 > cfg.outofcore_bytes:
            # record set exceeds comfortable HBM residency: hash-partitioned
            # multi-pass counting, re-scanning batches per group of three
            # partitions (ops/outofcore.py)
            from genome_assembly_tpu.ops import outofcore

            sent = np.uint32(0xFFFFFFFF)

            def batch_keys(b):
                recs = self.counter.scan(
                    jnp.asarray(batches[b].codes),
                    jnp.asarray(batches[b].lengths),
                )
                hi = jnp.where(recs.valid, recs.kmer_hi, sent).reshape(-1)
                lo = jnp.where(recs.valid, recs.kmer_lo, sent).reshape(-1)
                return hi, lo

            partitions = max(
                1, int(np.ceil(total_slots * 8 / (cfg.outofcore_bytes / 3)))
            )
            pc = outofcore.partitioned_count(
                batch_keys,
                len(batches),
                partitions=partitions,
                cutoff=cfg.abundance_cutoff,
                kept_cap=total_slots,
            )
            if pc.batch_overflows or pc.kept_overflow:
                raise RuntimeError(
                    "out-of-core counting overflowed its capacity slack; "
                    f"overflows={pc.batch_overflows} kept={pc.kept_overflow}"
                )
            stats.n_windows = total_slots
            stats.entries_pre_prune = pc.n_distinct
            stats.entries_post_prune = pc.n_kept
            khi, klo, valid = pc.kmer_hi, pc.kmer_lo, pc.valid
            pc = None  # the NamedTuple aliases the key arrays; free it
            links, graph = _extension_graph(
                khi, klo, valid, k=cfg.k,
                link_budget=cfg.link_budget_bytes,
                bulk_jump_states=cfg.bulk_jump_states,
            )
            # beyond-HBM scale: walk sort + byte extraction on device, one
            # host placement pass (identical output to the host
            # materializer, differential-tested in ops/dbg tests)
            out, _, _ = dbg.materialize_unitigs_device(
                khi, klo, valid, graph, cfg.k
            )
            stats.entries_post_extension = len(out)
            return out, stats

        # Fast mode carries no per-occurrence payload: flatten all batches'
        # key lanes and count with the cheap two-lane sort.
        combined, _ = self._flat_fast_records(reads, stats)
        kc = count_ops.count_keys(combined, cutoff=cfg.abundance_cutoff)
        stats.entries_pre_prune = int(jnp.sum(kc.group_start & kc.valid))
        stats.entries_post_prune = int(jnp.sum(kc.keep))
        khi, klo, valid = count_ops.kept_keys_sorted(kc)
        links = dbg.build_unitig_links_join(khi, klo, valid, k=cfg.k)
        graph = dbg.pointer_jump(links)
        out = dbg.materialize_unitigs(
            np.asarray(khi), np.asarray(klo), np.asarray(valid), graph, cfg.k
        )
        stats.entries_post_extension = len(out)
        return out, stats

    def _flat_fast_records(self, reads: Sequence[str], stats: PhaseStats,
                           with_rids: bool = False):
        """Scan all batches and flatten their record lanes (in-core path).

        Returns (records, rid_flat): rid_flat is None unless with_rids.
        """
        from genome_assembly_tpu.io import stream as stream_io
        from genome_assembly_tpu.ops import minimizer as minimizer_ops

        cfg = self.config
        batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
        if not batches:
            raise ValueError("no reads")
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
        his, los, valids, rid_parts = [], [], [], []
        with stream_io.feed_read_batches(batches) as feeder:
            for codes, lengths, rids in feeder:
                recs = self.counter.scan(codes, lengths)
                his.append(recs.kmer_hi.reshape(-1))
                los.append(recs.kmer_lo.reshape(-1))
                valids.append(recs.valid.reshape(-1))
                if with_rids:
                    rid_parts.append(
                        jnp.broadcast_to(
                            rids[:, None], recs.kmer_hi.shape
                        ).reshape(-1)
                    )
                stats.n_windows += int(jnp.sum(recs.valid))
        combined = minimizer_ops.WindowRecords(
            mmer=jnp.zeros((0,), jnp.uint32),
            kmer_hi=jnp.concatenate(his),
            kmer_lo=jnp.concatenate(los),
            valid=jnp.concatenate(valids),
        )
        rid_flat = jnp.concatenate(rid_parts) if with_rids else None
        return combined, rid_flat

    def unitigs_with_coverage(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], np.ndarray, np.ndarray, PhaseStats]:
        """Fast-mode unitigs plus per-unitig abundance coverage.

        Returns (unitigs, occ_sum, n_kmers, stats): occ_sum[i] /
        n_kmers[i] is unitig i's mean k-mer occurrence count -- the
        coverage signal the reference carries as per-BP read-id lists
        (binning.c:154-195, 857-888), which fast mode's payload-free count
        previously discarded entirely.  Counts
        ride the compaction sort as one extra lane, in-core or over a
        device mesh (``mesh=``: the distributed counts come back through
        the same 3-lane device sort).
        """
        from genome_assembly_tpu.ops import dbg

        if mesh is not None:
            return self._unitigs_cov_sharded(reads, mesh)
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        combined, _ = self._flat_fast_records(reads, stats)
        kc = count_ops.count_keys(combined, cutoff=cfg.abundance_cutoff)
        stats.entries_pre_prune = int(jnp.sum(kc.group_start & kc.valid))
        stats.entries_post_prune = int(jnp.sum(kc.keep))
        khi, klo, valid, counts = count_ops.kept_keys_sorted_with_counts(kc)
        links = dbg.build_unitig_links_join(khi, klo, valid, k=cfg.k)
        graph = dbg.pointer_jump(links)
        out, occ_sum, n_kmers = dbg.materialize_unitigs_cov(
            np.asarray(khi), np.asarray(klo), np.asarray(valid), graph,
            cfg.k, np.asarray(counts),
        )
        stats.entries_post_extension = len(out)
        return out, occ_sum, n_kmers, stats

    def unitigs_with_read_ids(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], List[np.ndarray], PhaseStats]:
        """Fast-mode unitigs plus per-unitig supporting read ids.

        Returns (unitigs, read_ids, stats): read_ids[i] is the sorted
        array of distinct reads containing at least one of unitig i's
        canonical k-mers -- the provenance channel of the reference's
        per-BP read-id lists, as a per-unitig artifact.  Builds a CSR
        (offsets, values) over the kept k-mer table from a 3-lane
        (hi, lo, rid) sort, then merges member slices per unitig.
        ``mesh=`` routes the counting over the device mesh (the grouped
        per-shard record lanes become the same CSR host-side).
        """
        if mesh is not None:
            return self._unitigs_rids_sharded(reads, mesh)
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        combined, rid_flat = self._flat_fast_records(
            reads, stats, with_rids=True
        )
        krc = count_ops.count_keys_rids(
            combined, rid_flat, cutoff=cfg.abundance_cutoff
        )
        stats.entries_pre_prune = int(jnp.sum(krc.group_start & krc.valid))
        # host-side CSR over kept groups (exact sizes, no padding)
        keep = np.asarray(krc.keep)
        rid_s = np.asarray(krc.read_id)
        starts = np.flatnonzero(keep)
        counts = np.asarray(krc.count)[starts].astype(np.int64)
        stats.entries_post_prune = len(starts)
        offsets = np.zeros(len(starts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        # flat occurrence indices: group g's occupy rid_s[starts[g] + j]
        within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(
            offsets[:-1], counts
        )
        values = rid_s[np.repeat(starts, counts) + within]
        khi = np.asarray(krc.kmer_hi)[starts]
        klo = np.asarray(krc.kmer_lo)[starts]

        return self._assemble_with_read_ids(khi, klo, offsets, values, stats)

    def _assemble_with_read_ids(self, khi, klo, offsets, values, stats):
        """Shared tail of the read-id channel: build the dBG over the kept
        sorted keys, materialize, and merge each unitig's member CSR
        slices into one sorted-distinct id array (single vectorized pass).
        """
        from genome_assembly_tpu.ops import dbg

        cfg = self.config
        valid = jnp.ones(len(khi), dtype=bool)
        links = dbg.build_unitig_links_join(
            jnp.asarray(khi), jnp.asarray(klo), valid, k=cfg.k
        )
        graph = dbg.pointer_jump(links)
        out = dbg.materialize_unitigs(khi, klo, np.ones(len(khi), bool),
                                      graph, cfg.k)
        u_off, u_rows = dbg.unitig_member_nodes(khi, klo, out, cfg.k)
        # one vectorized gather + dedup for ALL unitigs: flatten every member
        # node's CSR slice, tag each id with its unitig, lexsort, and cut
        # per-unitig sorted-distinct runs out of one array.
        lens = offsets[u_rows + 1] - offsets[u_rows]
        tot = int(lens.sum())
        excl = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=excl[1:])
        pos = (
            np.arange(tot, dtype=np.int64)
            - np.repeat(excl[:-1], lens)
            + np.repeat(offsets[u_rows], lens)
        )
        ids_all = values[pos]
        member_unitig = np.repeat(
            np.arange(len(out), dtype=np.int64), np.diff(u_off)
        )
        uid_all = np.repeat(member_unitig, lens)
        order = np.lexsort((ids_all, uid_all))
        u_srt, id_srt = uid_all[order], ids_all[order]
        first = np.ones(tot, dtype=bool)
        first[1:] = (u_srt[1:] != u_srt[:-1]) | (id_srt[1:] != id_srt[:-1])
        u_u, id_u = u_srt[first], id_srt[first]
        u_counts = np.bincount(u_u, minlength=len(out))
        off2 = np.zeros(len(out) + 1, dtype=np.int64)
        np.cumsum(u_counts, out=off2[1:])
        per_unitig: List[np.ndarray] = [
            id_u[off2[i] : off2[i + 1]] for i in range(len(out))
        ]
        stats.entries_post_extension = len(out)
        return out, per_unitig, stats

    def _unitigs_rids_sharded(self, reads: Sequence[str], mesh):
        """Distributed form of the read-id channel.

        The sharded count's [n_shards, cap] lanes already hold every
        record grouped by key on its owner shard (keys are owned by
        exactly one shard, so shard-major group concatenation is the
        global grouping); the host flattens kept groups into the CSR,
        lexsorts the kept keys into dBG order, and permutes the CSR
        alongside.  Tail shared with the in-core path.
        """
        from genome_assembly_tpu.parallel import shard_count

        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        n_shards = int(np.prod(list(mesh.shape.values())))
        (batch,) = reads_io.batch_reads(reads, cfg.max_read_len)
        rows = ((batch.n + n_shards - 1) // n_shards) * n_shards
        batch = reads_io.pad_batch(batch, rows)
        sc = shard_count.sharded_count(
            *_put_sharded(mesh, batch.codes, batch.lengths, batch.read_ids),
            k=cfg.k,
            m=cfg.m,
            parity=False,
            cutoff=cfg.abundance_cutoff,
            mesh=mesh,
            route_by="key",
        )
        overflow = int(np.sum(np.asarray(sc.overflow)))
        if overflow:
            raise RuntimeError(f"key routing overflow ({overflow})")
        stats.n_windows = int(jnp.sum(sc.valid))
        stats.entries_pre_prune = int(jnp.sum(sc.group_start & sc.valid))

        keep2 = np.asarray(sc.keep)
        cap = keep2.shape[1]
        s_idx, g_idx = np.nonzero(keep2)
        counts = np.asarray(sc.count)[s_idx, g_idx].astype(np.int64)
        khi_g = np.asarray(sc.kmer_hi)[s_idx, g_idx]
        klo_g = np.asarray(sc.kmer_lo)[s_idx, g_idx]
        stats.entries_post_prune = len(s_idx)
        offsets = np.zeros(len(s_idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        tot = int(offsets[-1])
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            offsets[:-1], counts
        )
        flat_base = s_idx.astype(np.int64) * cap + g_idx
        values = np.asarray(sc.read_id).reshape(-1)[
            np.repeat(flat_base, counts) + within
        ]
        # dBG order: lexsort the kept keys, permute the CSR alongside
        order = np.lexsort((klo_g, khi_g))
        khi_s, klo_s = khi_g[order], klo_g[order]
        counts_s = counts[order]
        off_s = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(counts_s, out=off_s[1:])
        pos = (
            np.arange(tot, dtype=np.int64)
            - np.repeat(off_s[:-1], counts_s)
            + np.repeat(offsets[:-1][order], counts_s)
        )
        return self._assemble_with_read_ids(
            khi_s, klo_s, off_s, values[pos], stats
        )

    def _unitigs_sharded(self, reads: Sequence[str], mesh):
        """Distributed counting + sharded dBG compaction over the mesh.

        All O(N) steps stay on device: kept keys are compacted by a device
        sort (no host lexsort round-trip), and link building is the routed
        sort-join (parallel/part_dbg.py) -- the same formulation as the
        single-device default; the binary-search builders are kept only
        for differential tests.
        """
        from genome_assembly_tpu.ops import dbg

        khi, klo, valid, _, graph, wide, stats = self._sharded_graph(
            reads, mesh, with_counts=False
        )
        if wide:
            # bounded-memory bucketed assembly: chains materialize per
            # head-hash bucket (the single-host form of the pod-scale
            # materialization shuffle); same output set as the plain
            # materializer (differential-tested)
            out = dbg.materialize_unitigs_partitioned(
                np.asarray(khi), np.asarray(klo), np.asarray(valid),
                graph, self.config.k,
            )
        else:
            out = dbg.materialize_unitigs(
                np.asarray(khi), np.asarray(klo), np.asarray(valid),
                graph, self.config.k,
            )
        stats.entries_post_extension = len(out)
        return out, stats

    def _unitigs_cov_sharded(self, reads: Sequence[str], mesh):
        """Distributed form of ``unitigs_with_coverage``: the counts ride
        the kept-key compaction sort as one extra lane, exactly like the
        in-core path, and the host cov materializer consumes them
        unchanged (it is dtype-agnostic, so the wide pipeline's int64
        graph works too)."""
        from genome_assembly_tpu.ops import dbg

        khi, klo, valid, counts, graph, _, stats = self._sharded_graph(
            reads, mesh, with_counts=True
        )
        out, occ_sum, n_kmers = dbg.materialize_unitigs_cov(
            np.asarray(khi), np.asarray(klo), np.asarray(valid), graph,
            self.config.k, np.asarray(counts),
        )
        stats.entries_post_extension = len(out)
        return out, occ_sum, n_kmers, stats

    def _sharded_graph(self, reads: Sequence[str], mesh, *, with_counts):
        """Shared distributed pipeline up to the compacted graph."""
        from genome_assembly_tpu.ops import dbg
        from genome_assembly_tpu.parallel import part_dbg, shard_count, shard_dbg

        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        n_shards = int(np.prod(list(mesh.shape.values())))
        (batch,) = reads_io.batch_reads(reads, cfg.max_read_len)
        rows = ((batch.n + n_shards - 1) // n_shards) * n_shards
        batch = reads_io.pad_batch(batch, rows)
        sc = shard_count.sharded_count(
            *_put_sharded(mesh, batch.codes, batch.lengths, batch.read_ids),
            k=cfg.k,
            m=cfg.m,
            parity=False,
            cutoff=cfg.abundance_cutoff,
            mesh=mesh,
            # fast mode routes by canonical-key hash: minimizer mass is
            # heavy-tailed and skews shard loads at high shard counts
            route_by="key",
        )
        overflow = int(np.sum(np.asarray(sc.overflow)))
        if overflow:
            raise RuntimeError(f"key routing overflow ({overflow})")
        stats.n_windows = int(jnp.sum(sc.valid))
        stats.entries_pre_prune = int(jnp.sum(sc.group_start & sc.valid))
        # device-side kept-key compaction: mask to sentinels + one global
        # 2-lane sort; only the kept COUNT is read back (a scalar), then
        # the sorted array is sliced on device to the padded node count
        if with_counts:
            khi_c, klo_c, cnt_c = _sharded_kept_keys_counts(sc)
        else:
            khi_c, klo_c = _sharded_kept_keys(sc)
            cnt_c = None
        n_kept = int(jnp.sum(sc.keep))
        stats.entries_post_prune = n_kept
        pad = n_shards * max(1, -(-max(n_kept, 1) // n_shards))
        khi = khi_c[:pad]
        klo = klo_c[:pad]
        counts = cnt_c[:pad] if with_counts else None
        valid = khi != jnp.uint32(0xFFFFFFFF)
        n_states = 2 * pad
        wide = cfg.wide_state_ids is True or (
            cfg.wide_state_ids == "auto" and n_states >= (1 << 31)
        )
        if wide:
            # wide (shard, local) state ids: the >2**31-state form of the
            # same routed sort-join + list ranking (config 5's ~6e9
            # states exceed int32; SCALE.md section 1).  The compaction
            # never forms a global id; materialization below 2**31
            # converts to the int32 CompactedGraph (at config-5 scale it
            # instead streams the per-shard (head, rank) slices).
            no, nl, link_ovf = part_dbg.partitioned_unitig_links_join_wide(
                khi, klo, valid, k=cfg.k, mesh=mesh
            )
            ovf = int(np.sum(np.asarray(link_ovf)))
            if ovf:
                raise RuntimeError(f"wide link-join routing overflow ({ovf})")
            wgraph, jump_ovf = part_dbg.partitioned_pointer_jump_wide(
                no, nl, mesh=mesh
            )
            ovf = int(np.sum(np.asarray(jump_ovf)))
            if ovf:
                raise RuntimeError(f"wide jump routing overflow ({ovf})")
            # host-side int64 graph: the device compaction never formed a
            # global id; materialization is host numpy (dbg._materialize
            # is dtype-agnostic), so int64 ids carry any state count the
            # host can hold
            rows2 = n_states // n_shards
            no_np = np.asarray(no).astype(np.int64)
            nl_np = np.asarray(nl).astype(np.int64)
            ho_np = np.asarray(wgraph.head_owner).astype(np.int64)
            hl_np = np.asarray(wgraph.head_local).astype(np.int64)
            rank64 = (np.asarray(wgraph.rank_hi).astype(np.int64) << 32) | (
                np.asarray(wgraph.rank_lo).astype(np.int64)
            )
            graph = dbg.CompactedGraph(
                next_state=np.where(no_np >= 0, no_np * rows2 + nl_np, -1),
                head=ho_np * rows2 + hl_np,
                rank=rank64,
                is_cycle=np.asarray(wgraph.is_cycle),
            )
        else:
            links, link_ovf = part_dbg.partitioned_unitig_links_join(
                khi, klo, valid, k=cfg.k, mesh=mesh
            )
            ovf = int(np.sum(np.asarray(link_ovf)))
            if ovf:
                raise RuntimeError(f"link-join routing overflow ({ovf})")
            graph = shard_dbg.sharded_pointer_jump(links, mesh=mesh)
        return khi, klo, valid, counts, graph, wide, stats


def _put_sharded(mesh, *arrays):
    """Host arrays -> device arrays split on axis 0 across ``mesh``, so each
    device receives only its rows (not the whole batch on device 0)."""
    from genome_assembly_tpu.parallel import mesh as mesh_lib

    sharding = mesh_lib.batch_sharding(mesh)
    return tuple(jax.device_put(a, sharding) for a in arrays)


@jax.jit
def _sharded_kept_keys(sc):
    """Kept keys of a ShardedCount, globally sorted, sentinel-padded.

    Runs as one device sort over the sharded arrays (XLA inserts the
    collectives); replaces the old host np.lexsort round-trip that would
    dominate at genome scale.
    """
    sentinel = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(sc.keep, sc.kmer_hi, sentinel).reshape(-1)
    lo = jnp.where(sc.keep, sc.kmer_lo, sentinel).reshape(-1)
    return jax.lax.sort((hi, lo), num_keys=2)


@jax.jit
def _sharded_kept_keys_counts(sc):
    """_sharded_kept_keys plus the per-key abundance count riding the
    same device sort as a third lane (the distributed coverage channel)."""
    sentinel = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(sc.keep, sc.kmer_hi, sentinel).reshape(-1)
    lo = jnp.where(sc.keep, sc.kmer_lo, sentinel).reshape(-1)
    cnt = jnp.where(sc.keep, sc.count, 0).reshape(-1).astype(jnp.uint32)
    return jax.lax.sort((hi, lo, cnt), num_keys=2)


@jax.jit
def _kept_sorted_keys(counted: count_ops.CountedTable):
    """Surviving canonical keys re-sorted by (hi, lo) for dBG lookups.

    The counted table is ordered by (mmer, hi, lo); neighbor lookups need a
    plain (hi, lo) order.  Pruned/invalid rows become sentinels at the end.
    """
    sentinel = jnp.uint32(0xFFFFFFFF)
    khi = jnp.where(counted.keep, counted.kmer_hi, sentinel)
    klo = jnp.where(counted.keep, counted.kmer_lo, sentinel)
    khi_s, klo_s = jax.lax.sort((khi, klo), num_keys=2)
    valid = khi_s != sentinel
    return khi_s, klo_s, valid


class ParityAssembler:
    """Bit-parity pipeline: device counting + host-native extension replay."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig()
        if not self.config.parity:
            raise ValueError("ParityAssembler requires a parity config")
        self.counter = CountPipeline(self.config)

    def load(self, path: str) -> List[str]:
        # Any byte is accepted, as the reference accepts any byte (getval
        # scores unknown chars as 'A', binning.c:107-109); reads containing
        # non-ACGT take the exact exception path (parity/nonacgt.py).
        return reads_io.load_reads_parity(path, self.config.read_length)

    def pruned_table(
        self, reads: Sequence[str]
    ) -> Tuple[table_ops.HostTable, PhaseStats]:
        self._reject_dirty(reads, "pruned_table (packed HostTable cannot "
                           "carry raw bytes; use pruned_table_dict)")
        if self._needs_outofcore(reads):
            return self._groups_outofcore(reads, self.config.abundance_cutoff)
        counted, stats = self.counter.count_reads(reads)
        host = table_ops.extract_groups(counted, pruned=True)
        return host, stats

    def _reject_dirty(self, reads: Sequence[str], where: str) -> None:
        from genome_assembly_tpu.parity import nonacgt

        if nonacgt.has_non_acgt(reads):
            raise NotImplementedError(
                f"reads contain non-ACGT bytes, unsupported by {where}; "
                "the in-core assemble()/pruned_table_dict() paths handle "
                "them exactly (parity/nonacgt.py)"
            )

    def _needs_outofcore(self, reads: Sequence[str]) -> bool:
        """True when the 5-lane parity record set exceeds the HBM budget."""
        cfg = self.config
        n_batches = max(1, -(-len(reads) // cfg.batch_reads))
        n_win = cfg.max_read_len - cfg.k + 1
        total_slots = n_batches * cfg.batch_reads * n_win
        return total_slots * 20 > cfg.outofcore_bytes

    def _groups_outofcore(
        self, reads: Sequence[str], cutoff: int, with_streams: bool = False
    ):
        """Hash-partitioned multi-pass parity counting (ops/outofcore.py).

        Bit-parity is preserved: partitions cover complete (mmer, kmer)
        groups and every group carries its global first-seen stream index,
        so the merged table is in the reference's exact insertion order
        (binning.c:1158-1165's monotone read stream).
        """
        from genome_assembly_tpu.ops import outofcore

        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        batches = reads_io.batch_reads(
            reads, cfg.max_read_len, cfg.batch_reads, parity_chars=True
        )
        if not batches:
            raise ValueError("no reads")
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
        n_win = cfg.max_read_len - cfg.k + 1
        total_slots = len(batches) * cfg.batch_reads * n_win
        sent = np.uint32(0xFFFFFFFF)

        def batch_records(b):
            codes = jnp.asarray(batches[b].codes)
            lengths = jnp.asarray(batches[b].lengths)
            rids = jnp.asarray(batches[b].read_ids)
            recs = self.counter.scan(codes, lengths)
            rows, nw = recs.mmer.shape
            n = rows * nw
            mm = jnp.where(recs.valid, recs.mmer, sent).reshape(n)
            hi = recs.kmer_hi.reshape(n)
            lo = recs.kmer_lo.reshape(n)
            rid = jnp.broadcast_to(rids[:, None], (rows, nw)).reshape(n)
            stream = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(
                b * cfg.batch_reads * n_win
            )
            return mm, hi, lo, rid, stream

        partitions = max(
            1, int(np.ceil(total_slots * 20 / (cfg.outofcore_bytes / 3)))
        )
        out = outofcore.partitioned_count_parity(
            batch_records,
            len(batches),
            partitions=partitions,
            cutoff=cutoff,
            with_streams=with_streams,
        )
        if with_streams:
            host, streams, n_windows, overflows = out
        else:
            host, n_windows, overflows = out
            streams = None
        if overflows:
            raise RuntimeError(
                f"out-of-core parity counting overflowed ({overflows}); "
                "raise the slack factor"
            )
        stats.n_windows = n_windows
        stats.entries_pre_prune = len(host.mmer) if cutoff < 0 else 0
        stats.entries_post_prune = (
            len(host.mmer) if cutoff >= 0 else 0
        )
        if with_streams:
            return host, streams, stats
        return host, stats

    def pruned_table_dict(self, reads: Sequence[str]) -> Dict:
        from genome_assembly_tpu.parity import nonacgt

        if nonacgt.has_non_acgt(reads):
            # raw-byte keys can't ride the packed HostTable; the string
            # groups carry them (this is the path pruned_table's reject
            # message points dirty callers to)
            return {
                (sig, km): list(map(int, reversed(ids)))
                for sig, km, ids in self.pruned_table_groups(reads)
            }
        host, _ = self.pruned_table(reads)
        return table_ops.decode_table(host, self.config.k, self.config.m)

    def assemble(
        self, reads: Sequence[str], engine: str = "auto", verbose: bool = False,
        mesh=None, routing: str = "padded",
    ):
        """Full parity pipeline -> unitig lines in the reference's exact
        print order (print_kmers, binning.c:827-843).

        engine: 'python' (executable spec), 'native' (C++ engine), or
        'auto' (native if built, else python).
        verbose: return the print_kmer_read_ids text instead of unitig lines.
        mesh: optional jax Mesh -- counting runs distributed (minimizer
        all_to_all, any number of batches) and still feeds the same
        bit-exact replay, because each group carries its global first-seen
        stream index.
        routing: "padded" or "ragged" record exchange for the mesh path.
        """
        from genome_assembly_tpu.parity import nonacgt
        from genome_assembly_tpu.parity import replay as replay_mod

        cfg = self.config
        dirty = nonacgt.has_non_acgt(reads)
        if mesh is not None:
            return self._assemble_sharded(
                reads, mesh, verbose, routing=routing, dirty=dirty,
                engine=engine,
            ), PhaseStats(n_reads=len(reads))
        if dirty:
            # the exception path composes with any scale: _nonacgt_groups
            # routes past-HBM record sets through the 5-lane partitioned
            # count with per-occurrence streams
            return self._assemble_nonacgt(reads, engine, verbose)
        if self._needs_outofcore(reads):
            # hash-partitioned multi-pass counting; cutoff -1 keeps every
            # group -- the replay performs the reference's own pruning
            host_all, stats = self._groups_outofcore(reads, -1)
        else:
            counted, stats = self.counter.count_reads(reads)
            host_all = table_ops.extract_groups(counted, pruned=False)
        if engine == "auto":
            try:
                from genome_assembly_tpu.native import replay_native

                engine = "native" if replay_native.available() else "python"
            except ImportError:
                engine = "python"
        if engine == "native":
            from genome_assembly_tpu.native import replay_native

            return replay_native.assemble(
                host_all, cfg.k, cfg.m, cfg.abundance_cutoff, verbose=verbose
            ), stats
        groups = replay_mod.groups_from_host_table(host_all, cfg.k, cfg.m)
        rep = replay_mod.ReferenceReplay(cfg.k, cfg.m, cfg.abundance_cutoff)
        rep.build(groups)
        rep.prune()
        rep.expand()
        rep.extend_all(True)
        rep.extend_all(False)
        out = rep.print_kmer_read_ids() if verbose else rep.print_kmers()
        return out, stats

    def _nonacgt_groups(self, reads: Sequence[str]):
        """Device count + exact raw-byte regrouping (parity/nonacgt.py),
        unpruned, in insertion order.  Record sets past the HBM budget
        route through the 5-lane partitioned count (with_streams), so
        every dirty surface -- assemble, pruned_table_groups,
        pruned_table_dict -- is out-of-core-safe."""
        from genome_assembly_tpu.parity import nonacgt

        cfg = self.config
        if self._needs_outofcore(reads):
            host_all, streams, stats = self._groups_outofcore(
                reads, -1, with_streams=True
            )
        else:
            counted, stats = self.counter.count_reads(reads)
            host_all, streams = table_ops.extract_groups_with_streams(
                counted, pruned=False
            )
        groups = nonacgt.regroup_with_exceptions(
            host_all, streams, reads,
            k=cfg.k, m=cfg.m, n_win=cfg.max_read_len - cfg.k + 1,
        )
        return groups, stats

    def _assemble_nonacgt(
        self, reads: Sequence[str], engine: str, verbose: bool
    ):
        """Exact parity for read sets containing non-ACGT bytes: the
        regrouped string groups (raw bytes preserved) feed either replay
        engine; pruning happens inside the replay as always."""
        groups, stats = self._nonacgt_groups(reads)
        return self._replay_string_groups(groups, engine, verbose), stats

    def _replay_string_groups(self, groups, engine: str, verbose: bool):
        """Insertion-ordered string groups -> replay engine -> output
        lines (shared by the in-core and out-of-core non-ACGT paths)."""
        from genome_assembly_tpu.parity import replay as replay_mod

        cfg = self.config
        if engine == "auto":
            try:
                from genome_assembly_tpu.native import replay_native

                engine = "native" if replay_native.available() else "python"
            except ImportError:
                engine = "python"
        if engine == "native":
            from genome_assembly_tpu.native import replay_native

            return replay_native.assemble_groups(
                groups, cfg.k, cfg.m, cfg.abundance_cutoff, verbose=verbose
            )
        rep = replay_mod.ReferenceReplay(cfg.k, cfg.m, cfg.abundance_cutoff)
        rep.build(groups)
        rep.prune()
        rep.expand()
        rep.extend_all(True)
        rep.extend_all(False)
        return rep.print_kmer_read_ids() if verbose else rep.print_kmers()

    def pruned_table_groups(self, reads: Sequence[str]):
        """Pruned table as STRING groups [(mmer, kmer, ids)] -- the form
        that can carry raw non-ACGT key bytes (the reference stores raw
        bytes in uncomplemented keys, binning.c:1023-1028)."""
        from genome_assembly_tpu.parity import nonacgt

        groups, _ = self._nonacgt_groups(reads)
        return nonacgt.prune_groups(groups, self.config.abundance_cutoff)

    def expanded_table(self, reads: Sequence[str], engine: str = "auto"):
        """Post-extension expanded per-base-pair read-id table, queryable.

        The reference only ever prints this structure (print_kmer_read_ids,
        binning.c:804-825); here it is a first-class artifact:
        {(mmer, unitig_key): [per-bp descending read-id list, one per
        base pair]} -- the exact state expand_read_id_list
        (binning.c:857-888) builds and unitig merging maintains.
        """
        from genome_assembly_tpu.utils.plots import parse_verbose_table

        text, _ = self.assemble(reads, engine=engine, verbose=True)
        if isinstance(text, list):
            text = "\n".join(text)
        return parse_verbose_table(text)

    def _assemble_sharded(
        self, reads: Sequence[str], mesh, verbose: bool,
        routing: str = "padded", dirty: bool = False, engine: str = "auto",
    ):
        """Distributed counting (minimizer all_to_all) -> native replay.

        Reads of any size: batches stream through the mesh and each shard
        accumulates its owned records across batches, so groups spanning
        batches stay whole (sharded_count_batches).  routing="ragged"
        exchanges exact record counts -- the skew-robust path.

        dirty: reads contain non-ACGT bytes.  Shards own complete
        (mmer, kmer) groups and record streams are global, so the same
        exception regroup as the single-device paths runs on the merged
        table (parity/nonacgt.py); ``engine`` selects its replay (the
        clean path is native-only).
        """
        from genome_assembly_tpu.parallel import shard_count

        cfg = self.config
        n_shards = int(np.prod(list(mesh.shape.values())))
        rows = max(
            n_shards,
            ((cfg.batch_reads + n_shards - 1) // n_shards) * n_shards,
        )
        batches = reads_io.batch_reads(
            reads, cfg.max_read_len, rows, parity_chars=cfg.parity
        )
        batches = [reads_io.pad_batch(b, rows) for b in batches]
        sc = shard_count.sharded_count_batches(
            batches,
            k=cfg.k,
            m=cfg.m,
            parity=True,
            cutoff=-1,  # replay performs the reference's own pruning
            mesh=mesh,
            routing=routing,
        )
        overflow = int(np.sum(np.asarray(sc.overflow)))
        if overflow:
            raise RuntimeError(
                f"minimizer routing overflow ({overflow} records); rerun "
                "with a larger slack factor"
            )
        if dirty:
            from genome_assembly_tpu.parity import nonacgt

            host, streams = shard_count.sharded_host_table_with_streams(sc)
            # stream numbering: rows per batch (not cfg.batch_reads) set
            # the per-read row stride in the sharded batch layout
            groups = nonacgt.regroup_with_exceptions(
                host, streams, reads,
                k=cfg.k, m=cfg.m, n_win=cfg.max_read_len - cfg.k + 1,
            )
            return self._replay_string_groups(groups, engine, verbose)
        from genome_assembly_tpu.native import replay_native

        mmer, hi, lo, offsets, flat_ids = shard_count.sharded_groups_for_replay(sc)
        text, _ = replay_native.replay(
            mmer, hi, lo, offsets, flat_ids,
            cfg.k, cfg.m, cfg.abundance_cutoff, verbose=verbose,
        )
        return text if verbose else text.splitlines()
