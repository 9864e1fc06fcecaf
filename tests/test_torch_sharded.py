"""Parity of ``mcaat_tpu_torch.parallel.sharded`` with
``mcaat_tpu.parallel.sharded``: the same read arrays (numpy, from a seed)
go through the JAX functions on the 8 virtual CPU devices and through the
port on 8 CPU shards. Tolerance: exact (integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcaat_tpu.parallel.sharded as jsh
import mcaat_tpu_torch.parallel.sharded as tsh
from mcaat_tpu.kmer.count import SENTINEL, count_kmers_for_reads
from mcaat_tpu_torch.parallel.exchange import Mesh, all_to_all, host_shards
from tests.torch_sharded_util import CPU8, make_reads


def test_mesh_shape(monkeypatch):
    jmesh = jsh.make_pipeline_mesh()
    tmesh = tsh.make_pipeline_mesh(CPU8)
    assert tmesh.shape == dict(jmesh.shape) == {"dp": 1, "kp": len(jax.devices())}
    # the JAX rules: kp the largest power of two dividing the count
    for n in (1, 2, 6, 8, 12):
        assert tsh.make_pipeline_mesh(CPU8[:1] * n).shape == dict(
            jsh.make_pipeline_mesh(jax.devices()[:1] * n).shape
        )
    assert tsh.make_pipeline_mesh(CPU8, dp=2).shape == {"dp": 2, "kp": 4}
    with pytest.raises(ValueError):
        tsh.make_pipeline_mesh(CPU8[:6], dp=2)  # kp = 3
    # the default mesh: one CPU shard, or MCAAT_TORCH_SHARDS of them
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MCAAT_TORCH_SHARDS", raising=False)
    assert tsh.make_pipeline_mesh().shape == {"dp": 1, "kp": 1}
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "8")
    mesh = tsh.make_pipeline_mesh()
    assert mesh.shape == {"dp": 1, "kp": 8} and mesh.n_local == 8


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_count_matches_single_device(dp):
    batch = make_reads(n=16, length=40)
    k = 11
    ju, jc, dropped = jsh.sharded_count_kmers(
        jsh.make_pipeline_mesh(dp=dp), jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
        k, route_cap=1 << 10, unique_cap=1 << 10,
    )
    assert int(dropped) == 0
    ju, jc = np.asarray(ju), np.asarray(jc)
    live = ju != int(SENTINEL)
    mesh = tsh.make_pipeline_mesh(CPU8, dp=dp)
    tu, tc = tsh.sharded_count_kmers(mesh, batch.codes, batch.lengths, k)
    # per kp shard the same sorted table, and the dp replicas agree
    kp = mesh.kp
    cap = ju.shape[0] // kp
    for i, s in enumerate(mesh.local_kp):
        rows = slice(s * cap, (s + 1) * cap)
        np.testing.assert_array_equal(tu[i].numpy(), ju[rows][live[rows]])
        np.testing.assert_array_equal(tc[i].numpy(), jc[rows][live[rows]])
    ref_u, ref_c = count_kmers_for_reads(batch.codes, batch.lengths, k)
    np.testing.assert_array_equal(np.concatenate(host_shards(mesh, tu)), ref_u)
    np.testing.assert_array_equal(np.concatenate(host_shards(mesh, tc)), ref_c)


def test_sharded_lookup_roundtrip():
    batch = make_reads(n=16, length=40, seed=3)
    k = 11
    jmesh = jsh.make_pipeline_mesh()
    ju, _jc, _ = jsh.sharded_count_kmers(
        jmesh, jnp.asarray(batch.codes), jnp.asarray(batch.lengths), k,
        route_cap=1 << 10, unique_cap=1 << 10,
    )
    ref_u, _ = count_kmers_for_reads(batch.codes, batch.lengths, k)
    queries = np.full(64, int(SENTINEL), dtype=np.int64)
    queries[:48] = ref_u[:48]
    queries[48] = 0  # AAAA...A, absent
    rng = np.random.default_rng(4)
    queries[49:60] = rng.integers(0, 1 << (2 * k), size=11)
    rng.shuffle(queries)
    want, dropped = jsh.sharded_lookup(jmesh, ju, jnp.asarray(queries), k, route_cap=1 << 10)
    assert int(dropped) == 0
    mesh = tsh.make_pipeline_mesh(CPU8)
    tu, _tc = tsh.sharded_count_kmers(mesh, batch.codes, batch.lengths, k)
    # the queries dealt unevenly over the slots (one slot asks nothing)
    cuts = [0, 0, 5, 20, 21, 40, 41, 60, 64]
    got = tsh.sharded_lookup(
        mesh, tu, [torch.from_numpy(queries[a:b]) for a, b in zip(cuts, cuts[1:])], k
    )
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got]), np.asarray(want))
    assert (np.asarray(want)[queries != int(SENTINEL)] >= 0).sum() >= 48


def test_sharded_pipeline_step_stats():
    batch = make_reads(n=8, length=40, seed=7)
    k = 11
    want = jsh.sharded_pipeline_step(
        jsh.make_pipeline_mesh(), jnp.asarray(batch.codes), jnp.asarray(batch.lengths), k,
        route_cap=1 << 10, unique_cap=1 << 10,
    )
    assert int(want["dropped"]) == 0
    got = tsh.sharded_pipeline_step(tsh.make_pipeline_mesh(CPU8), batch.codes, batch.lengths, k)
    for key in ("n_unique", "n_hit", "total_mult"):
        assert got[key] == int(want[key]), key
    assert got["n_hit"] == int(np.maximum(batch.lengths - k + 1, 0).sum())


def test_exchange_needs_a_process_group():
    """A mesh over several processes moves nothing without an initialised
    process group: it raises."""
    with pytest.raises(ValueError, match="process group"):
        Mesh(dp=1, kp=2, slot_proc=(0, 1), local_devices=(torch.device("cpu"),), n_proc=2)
    mesh = Mesh(
        dp=1, kp=2, slot_proc=(0, 1), local_devices=(torch.device("cpu"),), n_proc=2,
        distributed=True,
    )
    empty = torch.zeros(0, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="not initialised"):
        all_to_all(mesh, [[empty, empty]])
