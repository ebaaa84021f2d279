"""Two-level (ICI + DCN) routed counting vs the flat router.

Runs on the 8-device virtual CPU mesh reshaped 2x4 and 4x2: the mesh axes
exercise exactly the two bucketize+exchange stages a real multi-slice job
runs; equality against the flat 1-D router (same ownership hash) is the
correctness contract.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from genome_assembly_tpu.io import datagen, reads as reads_io
from genome_assembly_tpu.parallel import shard_count, two_level


def _batch(n_reads=64, read_len=40, max_len=48, seed=2):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=read_len, coverage=6, seed=seed,
        with_reverse=True,
    )
    reads = (reads * ((n_reads // len(reads)) + 1))[:n_reads]
    (b,) = reads_io.batch_reads(reads, max_len)
    b = reads_io.pad_batch(b, n_reads)
    return (
        jnp.asarray(b.codes),
        jnp.asarray(b.lengths),
        jnp.asarray(b.read_ids),
    )


@pytest.mark.parametrize("n_slices", [2, 4])
@pytest.mark.parametrize("parity", [False, True])
def test_two_level_equals_flat(n_slices, parity):
    assert jax.device_count() == 8
    codes, lengths, rids = _batch()
    k, m = 11, 5
    flat_mesh = Mesh(np.array(jax.devices()), (shard_count.SHARD_AXIS,))
    flat = shard_count.sharded_count(
        codes, lengths, rids, k=k, m=m, parity=parity, cutoff=1,
        mesh=flat_mesh,
    )
    mesh2 = two_level.two_level_mesh(n_slices)
    got = two_level.sharded_count_two_level(
        codes, lengths, rids, k=k, m=m, parity=parity, cutoff=1, mesh=mesh2,
    )
    assert int(np.sum(np.asarray(flat.overflow))) == 0
    assert int(np.sum(np.asarray(got.overflow))) == 0

    # same totals ...
    assert int(jnp.sum(got.valid)) == int(jnp.sum(flat.valid))
    assert int(jnp.sum(got.keep)) == int(jnp.sum(flat.keep))
    # ... same per-row ownership (global shard g = ds*n_ici + dd) ...
    np.testing.assert_array_equal(
        np.asarray(jnp.sum(got.valid, axis=1)),
        np.asarray(jnp.sum(flat.valid, axis=1)),
    )
    # ... and the same pruned table, entry for entry
    assert shard_count.sharded_to_host_dict(
        got, k, m
    ) == shard_count.sharded_to_host_dict(flat, k, m)


def test_two_level_3axis_equals_flat():
    """(2, 2, 2) (slices, x, y) mesh -- the ICI stage runs one all_to_all
    over the combined 2-D intra-slice torus -- must be bit-identical to
    the flat 8-shard router, including dead slots."""
    assert jax.device_count() == 8
    codes, lengths, rids = _batch()
    k, m = 11, 5
    flat_mesh = Mesh(np.array(jax.devices()), (shard_count.SHARD_AXIS,))
    flat = shard_count.sharded_count(
        codes, lengths, rids, k=k, m=m, parity=False, cutoff=1,
        mesh=flat_mesh,
    )
    mesh3 = two_level.two_level_mesh3(2, 2, 2)
    got = two_level.sharded_count_two_level(
        codes, lengths, rids, k=k, m=m, parity=False, cutoff=1, mesh=mesh3,
    )
    assert int(np.sum(np.asarray(got.overflow))) == 0
    for f in ("mmer", "kmer_hi", "kmer_lo", "read_id", "stream_idx",
              "valid", "group_start", "count", "keep"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(flat, f)),
            err_msg=f,
        )


def test_two_level_replay_groups_equal_flat():
    """Parity replay input (insertion-ordered groups) is identical, so the
    downstream bit-exact extension replay sees no difference at all."""
    assert jax.device_count() == 8
    codes, lengths, rids = _batch(seed=5)
    k, m = 7, 3
    flat_mesh = Mesh(np.array(jax.devices()), (shard_count.SHARD_AXIS,))
    flat = shard_count.sharded_count(
        codes, lengths, rids, k=k, m=m, parity=True, cutoff=-1,
        mesh=flat_mesh,
    )
    got = two_level.sharded_count_two_level(
        codes, lengths, rids, k=k, m=m, parity=True, cutoff=-1,
        mesh=two_level.two_level_mesh(2),
    )
    a = shard_count.sharded_groups_for_replay(flat)
    b = shard_count.sharded_groups_for_replay(got)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_routing_switch_dispatches_two_level():
    """shard_count.sharded_count(routing="two_level") over a (slices,
    shards) mesh == the flat padded router over the same devices."""
    import numpy as np
    import jax.numpy as jnp

    from genome_assembly_tpu.parallel import mesh as mesh_lib, shard_count
    from genome_assembly_tpu.parallel import two_level

    rng = np.random.default_rng(3)
    codes = jnp.asarray(rng.integers(0, 4, size=(64, 48), dtype=np.uint8))
    lengths = jnp.full((64,), 48, dtype=jnp.int32)
    rids = jnp.arange(64, dtype=jnp.uint32)
    kw = dict(k=11, m=5, parity=False, cutoff=1)
    flat = shard_count.sharded_count(
        codes, lengths, rids, mesh=mesh_lib.make_mesh(8), **kw
    )
    two = shard_count.sharded_count(
        codes, lengths, rids, mesh=two_level.two_level_mesh(2),
        routing="two_level", **kw
    )
    for f in shard_count.ShardedCount._fields:
        a, b = np.asarray(getattr(flat, f)), np.asarray(getattr(two, f))
        assert np.array_equal(a, b), f
