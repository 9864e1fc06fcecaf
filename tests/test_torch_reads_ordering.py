"""Read mapping and spacer ordering parity: mcaat_tpu_torch vs mcaat_tpu.

Both packages map the same FASTQ files against the same graph (built by
JAX, handed over with ``DBG.from_numpy``) and order the same cycles.
Read chains, region masks, SCC subgraphs and the found systems (repeat,
spacers, sequence and both confidences) compare exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaat_tpu.cycles.finder import cycles_map_to_cycles, find_cycles
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu.io.fastq import read_encoded_batch
from mcaat_tpu.ordering import ordering as jord
from mcaat_tpu.pipeline import spacer_ordering_step as jax_ordering_step
from mcaat_tpu.reads.mapper import get_reads as jax_get_reads
from mcaat_tpu_torch.ordering import ordering as tord
from mcaat_tpu_torch.pipeline import spacer_ordering_step as torch_ordering_step
from mcaat_tpu_torch.reads.mapper import get_reads as torch_get_reads
from tests.synthetic import make_metagenome, write_fastq
from tests.test_torch_graph import port_graph

DATA = os.path.join(os.path.dirname(__file__), "data")


def _setup(files: list[str]):
    """JAX graph + endpoint stash + cycles for the concatenated files."""
    batches = [read_encoded_batch(f) for f in files]
    L = max(b.max_len for b in batches)
    codes = np.zeros((sum(b.num_reads for b in batches), L), dtype=np.uint8)
    lengths = np.concatenate([b.lengths for b in batches]).astype(np.int32)
    row = 0
    for b in batches:
        codes[row : row + b.num_reads, : b.max_len] = b.codes
        row += b.num_reads
    eps = {}
    jg = jax_build(codes, lengths, k=23, endpoints_out=eps)
    jg, cmap = find_cycles(jg, verbose=False)
    j_eps, t_eps, off = {}, {}, 0
    for f, b in zip(files, batches):
        first = np.array(eps["first_km"])[off : off + b.num_reads]
        last = np.array(eps["last_km"])[off : off + b.num_reads]
        j_eps[f] = (jnp.asarray(first), jnp.asarray(last))
        t_eps[f] = (torch.as_tensor(first), torch.as_tensor(last))
        off += b.num_reads
    return jg, cycles_map_to_cycles(cmap), j_eps, t_eps


@pytest.fixture(scope="module")
def single_end(tmp_path_factory):
    meta = make_metagenome(seed=17, n_arrays=2, n_spacers=5, coverage=40.0)
    path = str(tmp_path_factory.mktemp("se") / "r.fq")
    write_fastq(path, meta["reads"])
    return (path, *_setup([path]))


@pytest.fixture(scope="module")
def paired_end():
    f1, f2 = os.path.join(DATA, "golden_pe_1.fq"), os.path.join(DATA, "golden_pe_2.fq")
    return (f1, f2, *_setup([f1, f2]))


def _same_chains(a, b):
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.flat, b.flat)


@pytest.mark.parametrize("use_endpoints", [False, True])
def test_single_end_chains_match_jax(single_end, use_endpoints):
    path, jg, cycles, j_eps, t_eps = single_end
    want = jax_get_reads(jg, path, None, cycles, endpoints=j_eps if use_endpoints else None)
    got = torch_get_reads(port_graph(jg), path, None, cycles, endpoints=t_eps if use_endpoints else None)
    assert len(got) > 0
    _same_chains(got, want)


@pytest.mark.parametrize("use_endpoints", [False, True])
def test_paired_end_chains_match_jax(paired_end, use_endpoints):
    """Mate 2 is reverse-complemented; from the endpoint stash its first
    and last windows are the swapped RCs of the raw ones."""
    f1, f2, jg, cycles, j_eps, t_eps = paired_end
    want = jax_get_reads(jg, f1, f2, cycles, endpoints=j_eps if use_endpoints else None)
    got = torch_get_reads(port_graph(jg), f1, f2, cycles, endpoints=t_eps if use_endpoints else None)
    assert len(got) > 0
    _same_chains(got, want)


def test_map_batch_matches_jax(single_end):
    """The direct two-phase entry (keep decision + chains for one batch)."""
    from mcaat_tpu.reads.mapper import _map_batch as jax_map_batch
    from mcaat_tpu_torch.reads.mapper import _map_batch as torch_map_batch

    path, jg, cycles, _j, _t = single_end
    batch = read_encoded_batch(path)
    nodes = {n for c in cycles for n in c}
    _same_chains(torch_map_batch(port_graph(jg), batch, nodes), jax_map_batch(jg, batch, nodes))


def test_region_first_mapping_matches_jax(single_end):
    from mcaat_tpu.cycles.neighborhood import undirected_region_mask as j_mask
    from mcaat_tpu_torch.cycles.neighborhood import undirected_region_mask as t_mask

    path, jg, cycles, j_eps, t_eps = single_end
    tg = port_graph(jg)
    seeds = np.asarray(sorted({n for c in cycles for n in c}), dtype=np.int64)

    def j_provider(rcl):
        gids = np.nonzero(j_mask(jg, seeds, rcl))[0]
        return jg.kmers[jnp.asarray(gids)], jnp.asarray(gids)

    def t_provider(rcl):
        gids = torch.as_tensor(np.nonzero(t_mask(tg, seeds, rcl))[0])
        return tg.kmers[gids], gids

    want = jax_get_reads(jg, path, None, cycles, endpoints=j_eps, region_provider=j_provider)
    got = torch_get_reads(tg, path, None, cycles, endpoints=t_eps, region_provider=t_provider)
    _same_chains(got, want)
    # out-of-region windows map to -1, so the full-table chains differ
    full = torch_get_reads(tg, path, None, cycles)
    assert (got.flat == -1).sum() >= (full.flat == -1).sum()


def test_grow_region_matches_jax(single_end):
    _path, jg, cycles, _j, _t = single_end
    tg = port_graph(jg)
    seed = np.zeros(jg.size, dtype=bool)
    seed[[n for c in cycles for n in c]] = True
    for hops in (1, 5, 40):
        want = np.asarray(jord._grow_region(jg.out, jg.in_, jg.valid, jnp.asarray(seed), hops))
        got = tord._grow_region(tg.out, tg.in_, tg.valid, torch.as_tensor(seed), hops).numpy()
        np.testing.assert_array_equal(got, want)
    jr, jsub = jord.get_crispr_regions_extended_by_k(jg, 78, cycles)
    tr, tsub = tord.get_crispr_regions_extended_by_k(tg, 78, cycles)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    assert [(s.adjacency, s.nodes) for s in tsub] == [(s.adjacency, s.nodes) for s in jsub]


@pytest.mark.parametrize("condense", [False, True])
def test_ordered_systems_match_jax(single_end, condense):
    path, jg, cycles, j_eps, t_eps = single_end
    tg = port_graph(jg)
    j_reads = jax_get_reads(jg, path, None, cycles)
    t_reads = torch_get_reads(tg, path, None, cycles)
    cmn = 0 if condense else 10**12
    _, want = jax_ordering_step(jg, j_reads, cycles, verbose=False, condense_min_nodes=cmn)
    _, got = torch_ordering_step(tg, t_reads, cycles, verbose=False, condense_min_nodes=cmn)
    assert len(want) >= 1
    assert [vars(s) for s in got] == [vars(s) for s in want]


def _random_consistent_graph(rng, n: int):
    """tests/test_ordering.py's random graph with a consistent adjacency
    (u in out[v] <=> v in in_[u]) and random validity, as numpy arrays."""
    out = np.full((n, 4), -1, dtype=np.int32)
    in_ = np.full((n, 4), -1, dtype=np.int32)
    for v in range(n):
        for b in range(int(rng.integers(0, 3))):
            w = int(rng.integers(0, n))
            free = np.nonzero(in_[w] < 0)[0]
            if len(free):
                out[v, b] = w
                in_[w, free[0]] = v
    return out, in_, rng.random(n) > 0.3


@pytest.mark.parametrize("trial", range(4))
def test_keep_crispr_regions_growth_paths_match(trial, monkeypatch):
    """tests/test_ordering.py's case: the frontier growth (big graphs) and
    the full-array growth give the same validity, in the port, and equal
    the JAX package's on the same graph, cycles and hops."""
    from mcaat_tpu.graph.dbg import DBG as JDBG
    from mcaat_tpu_torch.graph.dbg import DBG as TDBG

    rng = np.random.default_rng(9 + 1000 * trial)
    n = int(rng.integers(200, 800))
    out, in_, valid = _random_consistent_graph(rng, n)
    cycles = [rng.integers(0, n, size=rng.integers(2, 6)).tolist() for _ in range(3)]
    hops = int(rng.integers(1, 8))
    jg = JDBG(k=23, kmers=jnp.zeros((n,), jnp.int64), mult=jnp.ones((n,), jnp.int32),
              out=jnp.asarray(out.reshape(-1)), in_=jnp.asarray(in_.reshape(-1)),
              valid=jnp.asarray(valid))
    tg = TDBG.from_numpy(23, np.zeros(n, np.int64), np.ones(n, np.int32), out, in_, valid, "cpu")
    got = {}
    for name, thr in (("frontier", 1), ("full", 1 << 60)):
        monkeypatch.setattr(tord, "GROW_FRONTIER_MIN_NODES", thr)
        monkeypatch.setattr(jord, "GROW_FRONTIER_MIN_NODES", thr)
        got[name] = tord.keep_crispr_regions_extended_by_k(tg, hops, cycles).valid.numpy()
        want = np.asarray(jord.keep_crispr_regions_extended_by_k(jg, hops, cycles).valid)
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(got["frontier"], got["full"])


def test_host_region_growth_matches_device(monkeypatch):
    """tests/test_ordering.py's case: the host growth over downloaded
    adjacency equals keep_crispr_regions_extended_by_k's, and the split
    entry takes the host tier when the thresholds allow; both packages,
    the same graph."""
    from mcaat_tpu.io.fastq import encode_sequences

    rng = np.random.default_rng(29)
    seqs = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(60)]
    b = encode_sequences(seqs)
    jg = jax_build(b.codes, b.lengths, k=23)
    tg = port_graph(jg)
    valid_ids = np.nonzero(np.asarray(jg.valid))[0]
    cycles = [valid_ids[:5].tolist(), valid_ids[50:53].tolist()]
    dev = tord.keep_crispr_regions_extended_by_k(tg, 7, cycles).valid.numpy()
    np.testing.assert_array_equal(dev, np.asarray(jord.keep_crispr_regions_extended_by_k(jg, 7, cycles).valid))
    h = tg.to_host()
    seeds = np.unique(np.asarray(sorted({v for c in cycles for v in c}), dtype=np.int64))
    reached = tord._region_mask_host_arrays(h.out, h.in_, h.valid, seeds, 7)
    np.testing.assert_array_equal(h.valid & reached, dev)
    np.testing.assert_array_equal(
        reached,
        jord._region_mask_host_arrays(np.asarray(jg.out).reshape(-1, 4),
                                      np.asarray(jg.in_).reshape(-1, 4), np.asarray(jg.valid), seeds, 7),
    )
    monkeypatch.setattr(tord, "GROW_FRONTIER_MIN_NODES", 1)
    monkeypatch.setattr(jord, "GROW_FRONTIER_MIN_NODES", 1)
    host = []
    monkeypatch.setattr(tord, "_region_mask_host_arrays",
                        lambda *a, f=tord._region_mask_host_arrays: host.append(1) or f(*a))
    t2, tsubs = tord.get_crispr_regions_extended_by_k(tg, 7, cycles)
    j2, jsubs = jord.get_crispr_regions_extended_by_k(jg, 7, cycles)
    assert host, "the split entry did not take the host tier"
    np.testing.assert_array_equal(t2.valid.numpy(), dev)
    np.testing.assert_array_equal(t2.valid.numpy(), np.asarray(j2.valid))
    assert [(s.adjacency, s.nodes) for s in tsubs] == [(s.adjacency, s.nodes) for s in jsubs]
