"""Parity of ``mcaat_tpu_torch.parallel.sharded_graph`` with
``mcaat_tpu.parallel.sharded_graph``: the distributed build, the tagged
adjacency, the frontier exchange, the distributed prune and the candidate
scan, on the same read arrays (numpy, from a seed), JAX on its 8 virtual
CPU devices against the port on 8 CPU shards. Tolerance: exact; node ids
are compared as ``(shard, local rank)`` through compact ranks
(``tests/torch_sharded_util.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcaat_tpu.parallel.sharded_graph as jsg
import mcaat_tpu_torch.parallel.sharded_graph as tsg
from mcaat_tpu.parallel.sharded import make_pipeline_mesh as jmesh
from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads
from mcaat_tpu_torch.parallel.exchange import host_replicated
from mcaat_tpu_torch.parallel.sharded import make_pipeline_mesh
from tests.torch_sharded_util import (
    CPU8,
    assert_same_graph,
    canon_torch,
    compact_ids,
    compact_tagged,
    global_ids,
    jax_layout,
    jax_live_rows,
    make_reads,
)


def _both(batch, k=11, **kw):
    sj, dropped = jsg.build_sharded_dbg(jmesh(), batch.codes, batch.lengths, k=k, **kw)
    assert dropped == 0
    st = tsg.build_sharded_dbg(make_pipeline_mesh(CPU8), batch.codes, batch.lengths, k=k, **kw)
    return sj, st


def test_sharded_build_matches_single_device():
    batch = make_reads(n=16, length=60, seed=1)
    sj, st = _both(batch)
    assert_same_graph(sj, st)
    # and the port's own single-device build, compacted
    ref = build_dbg_from_reads(
        batch.codes, batch.lengths, k=11, add_reverse_complement=False, device="cpu"
    )
    g = tsg.sharded_dbg_to_dbg(st, "cpu")
    for f in ("kmers", "mult", "out", "in_", "valid"):
        assert torch.equal(getattr(g, f), getattr(ref, f)), f
    # the exact stride, and the JAX package's host view of the same shape rule
    assert st.T == int(st.n_live.max()) == st.shard_capacity
    kmers, mult, out, valid, in_ = st.to_single_device()
    assert kmers.shape == (8 * st.T,) and out.shape == (8 * st.T, 4)
    assert int(valid.sum()) == st.n_nodes


def test_sharded_prune_and_candidates():
    """Distributed prune + candidate mask, on a graph with real chains,
    branches and tips (a planted CRISPR array at k=23)."""
    from mcaat_tpu.io.fastq import encode_sequences
    from tests.synthetic import make_metagenome

    meta = make_metagenome(seed=3, n_arrays=1, n_spacers=4, coverage=30.0)
    batch = encode_sequences(meta["reads"])
    sj, st = _both(batch, k=23, add_rc=True)
    assert_same_graph(sj, st)
    for thr in (0, 20):
        jv, jc = jsg.sharded_prune_and_candidates(
            jmesh(), sj.mult, sj.out, sj.in_, sj.valid, threshold_multiplicity=thr
        )
        tv, tc = tsg.sharded_prune_and_candidates(
            st.mesh, st.mult, st.out, st.in_, st.valid, st.T, threshold_multiplicity=thr
        )
        np.testing.assert_array_equal(host_replicated(st.mesh, tv), jax_live_rows(sj, jv))
        np.testing.assert_array_equal(host_replicated(st.mesh, tc), jax_live_rows(sj, jc))
    assert 0 < int(host_replicated(st.mesh, tv).sum()) < st.n_nodes
    assert int(host_replicated(st.mesh, tc).sum()) > 0


def test_frontier_step_expands_correctly():
    batch = make_reads(n=8, length=50, seed=3)
    sj, st = _both(batch)
    Tj, n_live = jax_layout(sj)
    rng = np.random.default_rng(0)
    compact = rng.choice(st.n_nodes, size=24, replace=False)
    # kill a third of the nodes so both tag states occur
    kill = rng.choice(st.n_nodes, size=st.n_nodes // 3, replace=False)
    jvalid = np.asarray(sj.valid).copy()
    jvalid.reshape(-1)[global_ids(kill, Tj, n_live)] = False
    offs = np.concatenate([[0], np.cumsum(n_live)])
    tvalid = []
    for s, v in enumerate(st.valid):
        v = v.clone()
        mine = kill[(kill >= offs[s]) & (kill < offs[s + 1])] - offs[s]
        v[torch.from_numpy(mine)] = False
        tvalid.append(v)

    fj = np.full(32, -1, dtype=np.int32)
    fj[:24] = global_ids(compact, Tj, n_live)
    outv_j = jsg.tag_adjacency(jmesh(), sj.out, jnp.asarray(jvalid))
    want = np.asarray(jsg.frontier_step(jmesh(), outv_j, jnp.asarray(fj), route_cap=1 << 8))
    ft = np.full(32, -1, dtype=np.int64)
    ft[:24] = global_ids(compact, st.T, st.n_live)
    outv_t = tsg.tag_adjacency(st.mesh, st.out, tvalid, st.T)
    got = tsg.frontier_step(st.mesh, outv_t, ft, st.T)
    assert got.shape == (32, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(
        compact_tagged(got, st.T, st.n_live), compact_tagged(want, Tj, n_live)
    )
    assert (got <= -2).any() and (got >= 0).any() and (got[24:] == -1).all()


def test_tag_adjacency_roundtrip():
    """Tags encode exactly the target validity and decode to the raw
    adjacency; the port's tags equal the JAX package's."""
    batch = make_reads(n=8, length=50, seed=5)
    sj, st = _both(batch)
    Tj, n_live = jax_layout(sj)
    rng = np.random.default_rng(0)
    kill = rng.choice(st.n_nodes, size=max(st.n_nodes // 3, 1), replace=False)
    jvalid = np.asarray(sj.valid).copy()
    jvalid.reshape(-1)[global_ids(kill, Tj, n_live)] = False
    dead = np.zeros(st.n_nodes, dtype=bool)
    dead[kill] = True
    offs = np.concatenate([[0], np.cumsum(n_live)])
    tvalid = [
        v & ~torch.from_numpy(dead[offs[s] : offs[s + 1]]) for s, v in enumerate(st.valid)
    ]
    for field in ("out", "in_"):
        want = jsg.tag_adjacency(jmesh(), getattr(sj, field), jnp.asarray(jvalid))
        got = tsg.tag_adjacency(st.mesh, getattr(st, field), tvalid, st.T)
        np.testing.assert_array_equal(
            compact_tagged(host_replicated(st.mesh, got), st.T, st.n_live),
            compact_tagged(jax_live_rows(sj, want), Tj, n_live),
        )
        for g, raw in zip(got, getattr(st, field)):
            assert torch.equal(tsg.decode_tagged(g), raw)
    raw = host_replicated(st.mesh, st.in_)
    tag = host_replicated(st.mesh, got)  # the in-adjacency, tagged last
    present = raw >= 0
    np.testing.assert_array_equal(
        tag[present] >= 0, ~dead[compact_ids(raw[present], st.T, st.n_live)]
    )
    assert (tag[~present] == -1).all()


def test_pipeline_sharded_build_matches_single_device(monkeypatch):
    """The --mesh auto build branch == the single-device build, in both
    packages."""
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu.pipeline import _build_graph_sharded as jbuild
    from mcaat_tpu.settings import Settings as JSettings
    from mcaat_tpu_torch.pipeline import _build_graph_sharded as tbuild
    from mcaat_tpu_torch.settings import Settings

    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(33)]
    b = encode_sequences(seqs)
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "8")
    got = tbuild(b.codes, b.lengths, Settings(), torch.device("cpu"))
    want = jbuild(b.codes, b.lengths, JSettings())
    ref = build_dbg_from_reads(b.codes, b.lengths, k=23, add_reverse_complement=True, device="cpu")
    for f in ("kmers", "mult", "out", "in_", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_sharded_build_parted_counting_matches():
    """Counting in row parts (a per-part budget far below the input, so
    the per-shard merge stack reduces many part tables) gives the graph
    of the unparted build, in both packages."""
    batch = make_reads(n=48, length=60, seed=7)
    sj_p, st_p = _both(batch, count_shard_rows=1)
    sj_1, st_1 = _both(batch)
    assert st_p.n_parts >= 6 and st_1.n_parts == 1
    assert_same_graph(sj_p, st_p)
    assert_same_graph(sj_1, st_1)
    for a, b in zip(canon_torch(st_p), canon_torch(st_1)):
        np.testing.assert_array_equal(a, b)
    assert st_p.shard_capacity == int(st_p.n_live.max())


def test_sharded_build_rc_bitmath_matches_rc_rows():
    """add_rc=True (RC as packed-k-mer bit math, no RC code matrix)
    equals the single-device build over both strands."""
    batch = make_reads(n=12, length=50, seed=9)
    sj, st = _both(batch, add_rc=True)
    assert_same_graph(sj, st)
    ref = build_dbg_from_reads(
        batch.codes, batch.lengths, k=11, add_reverse_complement=True, device="cpu"
    )
    g = tsg.sharded_dbg_to_dbg(st, "cpu")
    for f in ("kmers", "mult", "out", "in_"):
        assert torch.equal(getattr(g, f), getattr(ref, f)), f


def test_global_id_range_is_checked():
    with pytest.raises(ValueError, match="int32 global-id range"):
        tsg._check_gid_range(8, 1 << 28)
    tsg._check_gid_range(8, (1 << 28) - 1)


@pytest.mark.parametrize("shards", [1, 8])
def test_pipeline_sharded_node_table_equals_jax(shards, monkeypatch):
    """The release pipeline's sharded build (``build_sharded_graph_for_pipeline``
    over ``MCAAT_TORCH_SHARDS`` CPU shards) of a small planted metagenome,
    both strands: its live node table and multiplicities, compacted, are
    the JAX single-device build's; 8 shards split the rows."""
    from mcaat_tpu.graph.dbg import build_dbg_from_reads as jbuild
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu.kmer.count import SENTINEL
    from mcaat_tpu_torch.parallel.sharded_pipeline import build_sharded_graph_for_pipeline
    from mcaat_tpu_torch.settings import Settings
    from tests.synthetic import make_metagenome

    meta = make_metagenome(seed=123, n_arrays=2, n_spacers=6, background_len=20_000,
                           background_coverage=8.0, coverage=35.0)
    b = encode_sequences(meta["reads"])
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", str(shards))
    sg = build_sharded_graph_for_pipeline(b.codes, b.lengths, Settings(), torch.device("cpu"))
    assert sg.mesh.kp == shards
    g = tsg.sharded_dbg_to_dbg(sg, "cpu")
    jg = jbuild(b.codes, b.lengths, k=23)
    n = int((np.asarray(jg.kmers) != int(SENTINEL)).sum())
    np.testing.assert_array_equal(g.kmers.numpy(), np.asarray(jg.kmers)[:n])
    np.testing.assert_array_equal(g.mult.numpy(), np.asarray(jg.mult)[:n])
    assert sg.n_nodes == n and (int(sg.n_live.max()) < n) == (shards > 1)
