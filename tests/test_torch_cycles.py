"""Prune and cycle-search parity: mcaat_tpu_torch vs mcaat_tpu.

The JAX package builds the graph; its arrays go to the port through
``DBG.from_numpy`` and every later stage runs in both packages on the
same graph. Validity masks, candidate lists, reachability flags,
extracted subgraphs and cycle maps compare exactly, including with the
big-graph thresholds lowered so the lazy-clip and neighbourhood branches
run at this size.
"""

import numpy as np
import pytest
import torch

import mcaat_tpu.cycles.finder as jfinder
import mcaat_tpu_torch.cycles.finder as tfinder
from mcaat_tpu.cycles import neighborhood as jnb
from mcaat_tpu.cycles import start_nodes as jsn
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu.io.fastq import encode_sequences
from mcaat_tpu.prune import prune as jprune
from mcaat_tpu_torch.cycles import neighborhood as tnb
from mcaat_tpu_torch.cycles import start_nodes as tsn
from mcaat_tpu_torch.graph import dbg as tdbg
from mcaat_tpu_torch.prune import prune as tprune
from tests.synthetic import make_metagenome
from tests.test_prune import make_graph
from tests.test_torch_graph import port_graph


@pytest.fixture(scope="module")
def meta_graph():
    meta = make_metagenome(
        seed=29, n_arrays=2, n_spacers=5, background_len=4000,
        background_coverage=6.0, coverage=40.0,
    )
    b = encode_sequences(meta["reads"])
    return jax_build(b.codes, b.lengths, k=23)


@pytest.fixture(scope="module")
def pruned(meta_graph):
    return jprune.prune_graph(meta_graph, verbose=False)


def _valid(g):
    v = g.valid
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _random_graph(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    edges = {}
    indeg = np.zeros(n, dtype=int)
    for u in range(n):
        deg = int(rng.integers(0, 3))
        vs = sorted({int(v) for v in rng.integers(0, n, deg) if indeg[v] < 4})
        indeg[vs] += 1
        edges[u] = vs
    g = make_graph(edges, n, mult=rng.integers(1, 4, n))
    return g


def test_prune_matches_jax_on_metagenome(meta_graph):
    jg, jn = jprune.invalidate_low_multiplicity(meta_graph)
    tg, tn = tprune.invalidate_low_multiplicity(port_graph(meta_graph))
    assert tn == jn
    np.testing.assert_array_equal(_valid(tg), _valid(jg))
    jg, jc = jprune.clip_tips(jg)
    tg, tc = tprune.clip_tips(tg)
    assert tc == jc
    np.testing.assert_array_equal(_valid(tg), _valid(jg))
    tp = tprune.prune_graph(port_graph(meta_graph), verbose=False)
    np.testing.assert_array_equal(_valid(tp), _valid(jg))


@pytest.mark.parametrize("seed", range(4))
def test_clip_tips_matches_jax_and_fixpoint_random(seed):
    jg = _random_graph(seed)
    tg = port_graph(jg)
    n = jg.size
    n_passes = int(np.ceil(np.log2(n))) + 1
    jt, jp = jprune._chain_collapse(jg.out, jg.valid, n_passes)
    tt, tp = tprune._chain_collapse(tg.out, tg.valid, n_passes)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tprune._condensed_slots(tg.out, tg.valid, tt, tp).numpy(),
        np.asarray(jprune._condensed_slots(jg.out, jg.valid, jt, jp)),
    )
    jc, _ = jprune.clip_tips(jg)
    tc, _ = tprune.clip_tips(tg)
    np.testing.assert_array_equal(_valid(tc), _valid(jc))
    fix = np.asarray(jprune._clip_tips_fixpoint(jg.out, jg.valid))
    np.testing.assert_array_equal(_valid(tc), fix)


@pytest.mark.parametrize("seed", range(6))
def test_clip_tips_fixpoint_matches_jax(seed):
    """The per-level fixpoint (tests/test_prune.py's model of clip_tips)
    in both packages, on random graphs with random pre-invalidation."""
    jg = _random_graph(seed, n=int(np.random.default_rng(seed).integers(5, 120)))
    valid0 = np.random.default_rng(100 + seed).random(jg.size) > 0.2
    jg = jg.with_valid(jg.valid & valid0)
    tg = port_graph(jg)
    want = np.asarray(jprune._clip_tips_fixpoint(jg.out, jg.valid))
    got = tprune._clip_tips_fixpoint(tg.out, tg.valid)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_valid(tprune.clip_tips(tg)[0]), want)


@pytest.mark.parametrize("dense, thr", [(False, 10), (True, 1), (False, 50)])
def test_candidate_mask_matches_jax_and_candidate_ids(dense, thr):
    """The fused whole-graph predicate in both packages, and the port's
    two-stage ``candidate_ids`` against it (tests/test_cycles.py's case
    on random adjacency, self-loops included)."""
    rng = np.random.default_rng(11 + thr)
    n = int(rng.integers(500, 3000))
    out = rng.integers(-1, n, size=4 * n).astype(np.int32)
    in_ = rng.integers(-1, n, size=4 * n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if dense:
        mult = rng.integers(1, 40, size=n).astype(np.int32)
    else:
        mult = np.ones(n, np.int32)
        mult[rng.choice(n, n // 20, replace=False)] = thr + 5
    out[4 * 7 + 2] = 7  # a planted self-loop
    mult[7], valid[7] = thr + 1, True
    want = np.asarray(jsn._candidate_mask(out, in_, valid, mult, thr))
    tg = tdbg.DBG.from_numpy(23, np.zeros(n, np.int64), mult, out, in_, valid, "cpu")
    got = tsn._candidate_mask(tg.out, tg.in_, tg.valid, tg.mult, thr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[7]
    np.testing.assert_array_equal(tsn.candidate_ids(tg, thr), np.nonzero(want)[0])


def test_candidates_match_jax(pruned):
    tg = port_graph(pruned)
    for thr in (2, 20):
        np.testing.assert_array_equal(
            tsn.candidate_ids(tg, thr), jsn.candidate_ids(pruned, thr)
        )
        order, cnt = jsn._precand_order(pruned.valid, pruned.mult, thr)
        ids, c = tsn._precand_order(tg.valid, tg.mult, thr)
        assert c == int(cnt)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(order)[:c])


def test_self_reach_matches_jax_including_overflow(pruned):
    tg = port_graph(pruned)
    cand = jsn.candidate_ids(pruned, 2)
    starts = np.concatenate([cand[:30], [-1, -1]]).astype(np.int32)
    for cap in (2, 64):  # cap 2 overflows on branching lanes
        jf, jo = jsn._self_reach_kernel(pruned.out, pruned.valid, starts, 77, cap)
        tf, to = tsn._self_reach_kernel(
            tg.out, tg.valid, torch.as_tensor(starts.astype(np.int64)), 77, cap
        )
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert np.asarray(jsn._self_reach_kernel(pruned.out, pruned.valid, starts, 77, 2)[1]).any()
    np.testing.assert_array_equal(
        tsn.self_reachable_batch(tg, cand, 77, frontier_cap=2),
        jsn.self_reachable_batch(pruned, cand, 77, frontier_cap=2),
    )
    buckets = tsn.select_start_nodes(tg, 20, 77, verbose=False)
    assert buckets == jsn.select_start_nodes(pruned, 20, 77, verbose=False)


def test_touched_mask_and_extraction_match_jax(pruned):
    tg = port_graph(pruned)
    seeds = jsn.candidate_ids(pruned, 20)
    jm = jnb.touched_mask(pruned.out, pruned.valid, seeds, 77, pruned.size)
    tm = tnb.touched_mask(tg.out, tg.valid, seeds, 77, tg.size)
    np.testing.assert_array_equal(tm, jm)
    for a, b in zip(tnb.extract_subgraph(tg, tm), jnb.extract_subgraph(pruned, jm)):
        np.testing.assert_array_equal(a, b)
    visited, overflow = tnb._union_reach_kernel(
        tg.out, tg.valid, torch.as_tensor(np.unique(seeds)), 77, 4
    )
    assert overflow  # a 4-entry frontier cannot hold this neighbourhood


def test_undirected_region_mask_matches_jax(pruned):
    tg = port_graph(pruned)
    seeds = np.unique(jsn.candidate_ids(pruned, 20))
    for hops in (3, 78):
        want = jnb.undirected_region_mask(pruned, seeds, hops)
        np.testing.assert_array_equal(tnb.undirected_region_mask(tg, seeds, hops), want)
        np.testing.assert_array_equal(
            tnb._undirected_region_mask_host(tg, seeds, hops), want
        )
    region, gids = tnb.extract_region_graph(tg, want)
    jregion, jgids = jnb.extract_region_graph(pruned, want)
    np.testing.assert_array_equal(gids, jgids)
    np.testing.assert_array_equal(region.out.numpy(), np.asarray(jregion.out))
    np.testing.assert_array_equal(region.kmers.numpy(), np.asarray(jregion.kmers))


@pytest.mark.parametrize("forced", [False, True])
def test_find_cycles_cycle_maps_match_jax(meta_graph, forced, monkeypatch):
    """Equal cycle maps; with the thresholds at 0 both packages take the
    lazy-clip + neighbourhood-extraction branch."""
    if forced:
        for mod in (jfinder, tfinder):
            monkeypatch.setattr(mod, "NEIGHBORHOOD_MIN_NODES", 0)
            monkeypatch.setattr(mod, "LAZY_CLIP_MIN_NODES", 0)
    jg, jmap = jfinder.find_cycles(meta_graph, verbose=False)
    tg, tmap = tfinder.find_cycles(port_graph(meta_graph), verbose=False)
    assert tmap == jmap
    assert len(jmap) > 0 and sum(len(c) for c in jmap.values()) > 0
    np.testing.assert_array_equal(_valid(tg), _valid(jg))
    assert tfinder.cycles_map_to_cycles(tmap) == jfinder.cycles_map_to_cycles(jmap)


def _tangle(n_segments: int):
    edges, nid, cur = {}, 1, 0
    for _ in range(n_segments):
        a1, a2, b1, b2, nxt = nid, nid + 1, nid + 2, nid + 3, nid + 4
        nid += 5
        edges[cur] = [a1, b1]
        edges[a1], edges[b1], edges[a2], edges[b2] = [a2], [b2], [nxt], [nxt]
        cur = nxt
    edges[cur] = [0]
    return make_graph(edges, nid, mult=[50] * nid)


@pytest.mark.parametrize("native", [True, False])
def test_tangle_over_500_cycles_aborts_like_jax(native, monkeypatch):
    """2^10 = 1024 bounded cycles through node 0 exceed CLUSTER_BOUNDS
    (500): a clean abort with no cycles; 2^8 = 256 enumerate fully."""
    if not native:
        import mcaat_tpu_torch.native as tnative

        monkeypatch.setattr(tnative, "enumerate_cycles", lambda *a, **k: None)
    for segs, n_cycles in ((10, 0), (8, 256)):
        g = _tangle(segs)
        tg = port_graph(g).to_host()
        args = ({5: [0]},)
        got = tfinder.enumerate_on_arrays(
            tg.out, tg.in_, tg.valid, tg.mult, *args,
            cycle_min_length=3, cycle_max_length=77, verbose=False,
        )
        want = jfinder.enumerate_on_arrays(
            tg.out, tg.in_, tg.valid, tg.mult, *args,
            cycle_min_length=3, cycle_max_length=77, verbose=False,
        )
        assert got == want
        assert len(got[0]) == n_cycles
