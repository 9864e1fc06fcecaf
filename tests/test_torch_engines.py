"""The two build engines, the counting sort with ids and the three joins:
mcaat_tpu_torch against mcaat_tpu on the same seeded inputs, on the CPU.

Everything here is integers, so every comparison is exact. The JAX
build pads to bucket sizes; the port builds exact sizes, so graphs are
compared on their live rows (``tests/test_torch_graph.py``).
"""

import numpy as np
import pytest
import torch

from mcaat_tpu.graph import dbg as jdbg
from mcaat_tpu.io.fastq import encode_sequences
from mcaat_tpu.kmer import count as jcount
from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.graph import dbg as tdbg
from mcaat_tpu_torch.kmer import count as tcount
from tests.test_torch_graph import CPU, assert_same_graph, rand_reads

import jax.numpy as jnp


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _same_port_graph(a: tdbg.DBG, b: tdbg.DBG) -> None:
    assert a.k == b.k and a.size == b.size
    for name in ("kmers", "mult", "out", "in_", "valid"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.dtype == tb.dtype, name
        assert torch.equal(ta, tb), name


def _engine_reads() -> list[str]:
    seqs = rand_reads(11)
    return seqs + seqs[:10]  # duplicates: multiplicity > 1 and repeated edges


@pytest.mark.parametrize("add_rc", [False, True])
def test_build_engines_identical(add_rc):
    """inst == join == the JAX graph's live rows (of both JAX engines)."""
    batch = encode_sequences(_engine_reads())
    kw = dict(k=23, add_reverse_complement=add_rc)
    a = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="inst", device=CPU, **kw)
    b = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="join", device=CPU, **kw)
    _same_port_graph(a, b)
    assert int(a.mult.max()) > 1
    for engine in ("inst", "join"):
        assert_same_graph(a, jdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine=engine, **kw))


def test_build_engine_argument():
    """None means BUILD_ENGINE ("join"), another string is refused, and
    "inst" refuses a build past the single-pass budget as the JAX one."""
    batch = encode_sequences(rand_reads(5))
    assert tdbg.BUILD_ENGINE == jdbg.BUILD_ENGINE == "join"
    g0 = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, device=CPU)
    g1 = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine=None, device=CPU)
    _same_port_graph(g0, g1)
    with pytest.raises(ValueError, match="engine"):
        tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="sort", device=CPU)
    for build, extra in ((tdbg.build_dbg_from_reads, {"device": CPU}), (jdbg.build_dbg_from_reads, {})):
        with pytest.raises(ValueError, match="engine='join'"):
            build(batch.codes, batch.lengths, engine="inst", chunk_windows=100, **extra)
    parted = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, chunk_windows=100, device=CPU)
    _same_port_graph(parted, g0)


def test_inst_engine_endpoints_before_rc_rows():
    """``endpoints_out`` holds one row per input read, though the inst
    engine doubles the rows for the RC strand."""
    seqs = rand_reads(3, lo=10, hi=70)  # some reads shorter than k
    batch = encode_sequences(seqs)
    eps = {e: {} for e in ("inst", "join")}
    for e in eps:
        tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine=e, endpoints_out=eps[e], device=CPU)
    j_eps: dict = {}
    jdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="inst", endpoints_out=j_eps)
    for key in ("first_km", "last_km"):
        assert eps["inst"][key].shape == (len(seqs),)
        assert torch.equal(eps["inst"][key], eps["join"][key])
        np.testing.assert_array_equal(eps["inst"][key].numpy(), np.asarray(j_eps[key])[: len(seqs)])


@pytest.mark.parametrize("lens", [[5], [22, 23, 24, 60], [10, 12]])
def test_inst_engine_degenerate_inputs(lens):
    """Reads below k, a read of exactly k (a node, no edge)."""
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in lens]
    batch = encode_sequences(seqs)
    a = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="inst", device=CPU)
    b = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, engine="join", device=CPU)
    _same_port_graph(a, b)


def test_reverse_complement_batch_matches_jax():
    batch = encode_sequences(rand_reads(9, lo=1, hi=50) + [""])
    codes_t, lengths_t = tdbg._reverse_complement_batch(_t(batch.codes, torch.uint8), _t(batch.lengths, torch.int32))
    codes_j, lengths_j = jdbg._reverse_complement_batch(jnp.asarray(batch.codes), jnp.asarray(batch.lengths))
    assert codes_t.dtype == torch.uint8
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))


@pytest.mark.parametrize("seed", [4, 12])
def test_count_unique_with_ids_matches_jax(seed):
    """Table, counts and the ids of the live instances (a SENTINEL window
    gets "an arbitrary in-range id" in JAX and -1 in the port)."""
    batch = encode_sequences(_engine_reads() if seed == 4 else rand_reads(seed, lo=5, hi=40))
    k = 7
    km_j = jcount.extract_kmers(jnp.asarray(batch.codes), jnp.asarray(batch.lengths), k).reshape(-1)
    km_t = tcount.extract_kmers(_t(batch.codes, torch.uint8), _t(batch.lengths, torch.int32), k).reshape(-1)
    np.testing.assert_array_equal(km_t.numpy(), np.asarray(km_j))
    uj, cj, nj, ij = jcount.count_unique_with_ids(km_j)
    ut, ct, nt, it = tcount.count_unique_with_ids(km_t)
    nj = int(nj)
    assert nt == nj and ut.shape == (nj,) and ct.dtype == torch.int32 and it.dtype == torch.int32
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj)[:nj])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj)[:nj])
    live = km_t.numpy() != SENTINEL
    assert live.any() and not live.all()
    np.testing.assert_array_equal(it.numpy()[live], np.asarray(ij)[live])
    assert (it.numpy()[~live] == -1).all()
    # an id is the rank of its window in the table
    np.testing.assert_array_equal(ut.numpy()[it.numpy()[live]], km_t.numpy()[live])
    u2, c2, n2 = tcount.count_unique(km_t)
    assert n2 == nt and torch.equal(u2, ut) and torch.equal(c2, ct)
    empty = tcount.count_unique_with_ids(torch.zeros(0, dtype=torch.int64))
    assert empty[2] == 0 and empty[3].shape == (0,)


def test_adjacency_from_instances_matches_jax():
    batch = encode_sequences(_engine_reads())
    k = 23
    codes_t, lengths_t = _t(batch.codes, torch.uint8), _t(batch.lengths, torch.int32)
    km = tcount.extract_kmers(codes_t, lengths_t, k)
    _u, _c, n, inst = tcount.count_unique_with_ids(km.reshape(-1))
    out_t, in_t = tdbg._adjacency_from_instances(inst.reshape(km.shape), codes_t, lengths_t, n, k=k)
    out_j, in_j = jdbg._adjacency_from_instances(
        jnp.asarray(np.maximum(inst.numpy(), 0).reshape(km.shape)), jnp.asarray(batch.codes),
        jnp.asarray(batch.lengths), n, k=k,
    )
    assert out_t.dtype == torch.int32 and out_t.shape == (4 * n,)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))


def _join_inputs():
    rng = np.random.default_rng(11)
    table = np.unique(rng.integers(0, 1 << 46, size=500, dtype=np.int64))
    # pad the table tail with SENTINEL (bucketed builds do this)
    table = np.concatenate([table, np.full(20, int(SENTINEL), np.int64)])
    q1 = rng.integers(0, 1 << 46, size=300, dtype=np.int64)
    q1[:100] = rng.choice(table[:-20], size=100)  # guaranteed hits
    q2 = rng.integers(0, 1 << 46, size=200, dtype=np.int64)
    q2[-5:] = int(SENTINEL)  # sentinel queries must miss
    return table, q1, q2


def test_join_lookups_match_jax_and_searchsorted():
    table, q1, q2 = _join_inputs()
    r1, r2 = tdbg._join_lookup2(_t(table), _t(q1), _t(q2))
    j1, j2 = jdbg._join_lookup2(jnp.asarray(table), jnp.asarray(q1), jnp.asarray(q2))
    assert r1.dtype == torch.int32 and (r1.numpy() >= 0).sum() >= 100
    for got, jax_got, q in ((r1, j1, q1), (r2, j2, q2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_got))
        np.testing.assert_array_equal(got.numpy(), tdbg._lookup(_t(table), _t(q)).numpy())
        np.testing.assert_array_equal(tdbg._join_lookup1(_t(table), _t(q)).numpy(), got.numpy())
        np.testing.assert_array_equal(
            np.asarray(jdbg._join_lookup1(jnp.asarray(table), jnp.asarray(q))), got.numpy()
        )
    # the trusted join agrees wherever the query is in the table
    hits = r1.numpy() >= 0
    np.testing.assert_array_equal(
        tdbg._join_lookup1_trusted(_t(table), _t(q1[hits])).numpy(), r1.numpy()[hits]
    )


@pytest.mark.parametrize("side", ["port", "jax"])
def test_join_lookup_boundaries(side):
    table = np.array([10, 20, 30], dtype=np.int64)
    q1 = np.array([5, 10, 30, 35, 20], dtype=np.int64)
    q2 = np.array([10, 10, 25], dtype=np.int64)
    if side == "port":
        r1, r2 = tdbg._join_lookup2(_t(table), _t(q1), _t(q2))
        s1 = tdbg._join_lookup1(_t(table), _t(q1))
        e1, e2 = tdbg._join_lookup2(_t(table[:0]), _t(q1), _t(q2[:0]))
        assert (e1.numpy() == -1).all() and e2.shape == (0,)
    else:
        r1, r2 = jdbg._join_lookup2(jnp.asarray(table), jnp.asarray(q1), jnp.asarray(q2))
        s1 = jdbg._join_lookup1(jnp.asarray(table), jnp.asarray(q1))
    np.testing.assert_array_equal(np.asarray(r1), [-1, 0, 2, -1, 1])
    np.testing.assert_array_equal(np.asarray(r2), [0, 0, -1])
    np.testing.assert_array_equal(np.asarray(s1), [-1, 0, 2, -1, 1])


def _tables(add_rc=True, seed=11):
    """The join engine's tables for a read set: (u23, c23, u24, u_id, graph)."""
    batch = encode_sequences(rand_reads(seed))
    codes_t, lengths_t = _t(batch.codes, torch.uint8), _t(batch.lengths, torch.int32)
    k = 23
    km1 = tcount.extract_kmers(codes_t, lengths_t, k + 1).reshape(-1)
    last = tcount.extract_last_kmer(codes_t, lengths_t, k)
    if add_rc:
        km1 = torch.cat([km1, tcount.revcomp_kmers(km1, k + 1)])
        last = torch.cat([last, tcount.revcomp_kmers(tcount.extract_first_kmer(codes_t, lengths_t, k), k)])
    u24, c24, _n = tcount.count_unique(km1)
    u_l, c_l, _n = tcount.count_unique(last)
    u23, c23, _n23, u_id = tcount.derive_nodes_from_edges(u24, c24, u_l, c_l)
    graph = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, k=k, add_reverse_complement=add_rc, device=CPU)
    return u23, c23, u24, u_id, graph, batch


@pytest.mark.parametrize("add_rc", [False, True])
def test_build_dbg_without_u_id_equals_with_it(add_rc, monkeypatch):
    u23, c23, u24, u_id, graph, batch = _tables(add_rc)
    _same_port_graph(tdbg.build_dbg(u23, c23, u24, u_id), graph)
    two_sided = tdbg.build_dbg(u23, c23, u24)
    _same_port_graph(two_sided, graph)
    # in chunks, and against the JAX build_dbg on the same tables
    monkeypatch.setattr(tdbg, "ADJ_SINGLE_SHOT_MAX_EDGES", 64)
    _same_port_graph(tdbg.build_dbg(u23, c23, u24), graph)
    jg = jdbg.build_dbg(u23.numpy(), c23.numpy(), u24.numpy())
    assert_same_graph(two_sided, jg)


def test_build_dbg_verify_adj_switches_the_join(monkeypatch):
    """MCAAT_VERIFY_ADJ=1 sends the destination join through the checked
    ``_join_lookup1``; the graph is the same."""
    u23, c23, u24, u_id, graph, _batch = _tables()
    calls = {"checked": 0, "trusted": 0}
    real1, real_t = tdbg._join_lookup1, tdbg._join_lookup1_trusted
    monkeypatch.setattr(tdbg, "_join_lookup1", lambda *a: (calls.__setitem__("checked", calls["checked"] + 1), real1(*a))[1])
    monkeypatch.setattr(tdbg, "_join_lookup1_trusted", lambda *a: (calls.__setitem__("trusted", calls["trusted"] + 1), real_t(*a))[1])
    monkeypatch.delenv("MCAAT_VERIFY_ADJ", raising=False)
    _same_port_graph(tdbg.build_dbg(u23, c23, u24, u_id), graph)
    assert calls == {"checked": 0, "trusted": 1}
    monkeypatch.setenv("MCAAT_VERIFY_ADJ", "1")
    _same_port_graph(tdbg.build_dbg(u23, c23, u24, u_id), graph)
    assert calls == {"checked": 1, "trusted": 1}
    # the two-sided join never takes either
    _same_port_graph(tdbg.build_dbg(u23, c23, u24), graph)
    assert calls == {"checked": 1, "trusted": 1}


def test_build_dbg_untrusted_edge_table_drops_foreign_edges():
    """An edge whose prefix or suffix is no node is left out by the
    two-sided join, in both packages, and so is a SENTINEL row."""
    u23, c23, u24, _u_id, graph, _batch = _tables()
    table = set(u23.tolist())
    mask = (1 << 46) - 1
    rng = np.random.default_rng(1)
    foreign = []
    while len(foreign) < 3:
        e = int(rng.integers(0, 1 << 48))
        if (e >> 2) not in table and (e & mask) not in table:
            foreign.append(e)
    # one edge from a node into nowhere, one from nowhere into a node
    half_u = (int(u23[5]) << 2) | 1
    if (half_u & mask) in table or half_u in set(u24.tolist()):
        half_u = (int(u23[5]) << 2) | 2
    assert (half_u & mask) not in table
    planted = np.unique(np.concatenate([u24.numpy(), np.array(foreign + [half_u], dtype=np.int64)]))
    assert planted.shape[0] == u24.shape[0] + 4
    with_sentinel = torch.cat([_t(planted), torch.full((3,), SENTINEL, dtype=torch.int64)])
    g = tdbg.build_dbg(u23, c23, with_sentinel)
    _same_port_graph(g, graph)
    jg = jdbg.build_dbg(u23.numpy(), c23.numpy(), planted)
    assert_same_graph(g, jg)
