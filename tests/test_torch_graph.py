"""Graph build parity: mcaat_tpu_torch vs mcaat_tpu on the same reads.

The port builds exact-size tables; the JAX build pads to bucket sizes
with SENTINEL rows that sort last, so node ids agree and the live rows
(k-mers, multiplicities, out/in adjacency, validity) must be equal.
Integer results compare exactly. Also the shared helpers of the
``test_torch_*`` files.
"""

import numpy as np
import pytest
import torch

from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu.io.fastq import encode_sequences
from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.graph import dbg as tdbg

CPU = torch.device("cpu")


def rand_reads(seed: int, n: int = 40, lo: int = 20, hi: int = 90) -> list[str]:
    rng = np.random.default_rng(seed)
    return [
        "".join("ACGT"[i] for i in rng.integers(0, 4, size=int(rng.integers(lo, hi))))
        for _ in range(n)
    ]


def port_graph(jg) -> tdbg.DBG:
    """The JAX graph's arrays handed to the port (the checkpoint fields)."""
    return tdbg.DBG.from_numpy(
        jg.k, np.asarray(jg.kmers), np.asarray(jg.mult), np.asarray(jg.out),
        np.asarray(jg.in_), np.asarray(jg.valid), CPU,
    )


def live_rows(kmers, mult, out, in_, valid) -> dict:
    kmers = np.asarray(kmers)
    n = int((kmers != SENTINEL).sum())
    return {
        "kmers": kmers[:n],
        "mult": np.asarray(mult)[:n],
        "out": np.asarray(out).reshape(-1)[: 4 * n],
        "in_": np.asarray(in_).reshape(-1)[: 4 * n],
        "valid": np.asarray(valid)[:n],
    }


def assert_same_graph(tg, jg) -> None:
    a = live_rows(tg.kmers.numpy(), tg.mult.numpy(), tg.out.numpy(), tg.in_.numpy(), tg.valid.numpy())
    b = live_rows(jg.kmers, jg.mult, jg.out, jg.in_, jg.valid)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("add_rc", [False, True])
@pytest.mark.parametrize("seed", [7, 11])
def test_build_live_rows_match_jax(seed, add_rc):
    batch = encode_sequences(rand_reads(seed))
    jg = jax_build(batch.codes, batch.lengths, k=23, add_reverse_complement=add_rc)
    tg = tdbg.build_dbg_from_reads(
        batch.codes, batch.lengths, k=23, add_reverse_complement=add_rc, device=CPU
    )
    assert tg.size == int((np.asarray(jg.kmers) != SENTINEL).sum())
    assert_same_graph(tg, jg)


def test_build_endpoints_out_match_jax():
    seqs = rand_reads(3, lo=10, hi=70)  # some reads shorter than k
    batch = encode_sequences(seqs)
    j_eps, t_eps = {}, {}
    jax_build(batch.codes, batch.lengths, k=23, endpoints_out=j_eps)
    tdbg.build_dbg_from_reads(batch.codes, batch.lengths, k=23, endpoints_out=t_eps, device=CPU)
    R = len(seqs)
    for key in ("first_km", "last_km"):
        np.testing.assert_array_equal(t_eps[key].numpy(), np.asarray(j_eps[key])[:R])


def test_from_numpy_round_trips_jax_graph():
    """DBG.from_numpy reads exactly the checkpoint fields; padding rows
    included, the port's queries agree with the JAX graph's."""
    batch = encode_sequences(rand_reads(5))
    jg = jax_build(batch.codes, batch.lengths, k=23)
    tg = port_graph(jg)
    h = tg.to_host()
    np.testing.assert_array_equal(h.kmers, np.asarray(jg.kmers))
    np.testing.assert_array_equal(h.out, np.asarray(jg.out).reshape(-1, 4))
    np.testing.assert_array_equal(h.in_, np.asarray(jg.in_).reshape(-1, 4))
    np.testing.assert_array_equal(h.valid, np.asarray(jg.valid))
    np.testing.assert_array_equal(h.mult, np.asarray(jg.mult))
    assert tg.size == jg.size
    np.testing.assert_array_equal(tg.out_degree().numpy(), np.asarray(jg.out_degree()))
    np.testing.assert_array_equal(tg.in_degree().numpy(), np.asarray(jg.in_degree()))
    ids = np.arange(-1, jg.size, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        tg.outgoing(torch.as_tensor(ids)).numpy(), np.asarray(jg.outgoing(ids))
    )
    np.testing.assert_array_equal(
        tg.incoming(torch.as_tensor(ids)).numpy(), np.asarray(jg.incoming(ids))
    )
    assert tg.label(3) == jg.label(3)


def test_lookup_matches_jax():
    batch = encode_sequences(rand_reads(9))
    jg = jax_build(batch.codes, batch.lengths, k=23)
    tg = port_graph(jg)
    live = np.asarray(jg.kmers)[: int((np.asarray(jg.kmers) != SENTINEL).sum())]
    rng = np.random.default_rng(0)
    q = np.concatenate([
        live[::3], rng.integers(0, 1 << 46, 200), [SENTINEL, 0, (1 << 46) - 1]
    ]).astype(np.int64)
    np.testing.assert_array_equal(tg.lookup(torch.as_tensor(q)).numpy(), np.asarray(jg.lookup(q)))


def test_join_lookup1_trusted_matches_jax():
    from mcaat_tpu.graph.dbg import _join_lookup1_trusted as jax_join

    rng = np.random.default_rng(4)
    table = np.unique(rng.integers(0, 1 << 46, 500)).astype(np.int64)
    padded = np.concatenate([table, np.full(24, SENTINEL, np.int64)])
    q = np.concatenate([rng.choice(table, 300), np.full(5, SENTINEL, np.int64)])
    got = tdbg._join_lookup1_trusted(torch.as_tensor(padded), torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_join(padded, q)))
    np.testing.assert_array_equal(got[:300], np.searchsorted(table, q[:300]))


def test_build_adjacency_matches_jax_dump_slot():
    """Dead edge rows land in the sliced-off dump slot 4N."""
    from mcaat_tpu.graph.dbg import _build_adjacency as jax_adj

    batch = encode_sequences(rand_reads(12))
    jg = jax_build(batch.codes, batch.lengths, k=23, add_reverse_complement=False, bucket_shapes=False)
    kmers = np.array(jg.kmers)
    from mcaat_tpu.kmer.count import count_unique, extract_kmers

    km1 = np.asarray(extract_kmers(batch.codes, batch.lengths, 24)).reshape(-1)
    u24, _c, n24 = count_unique(km1)
    edges = np.asarray(u24)[: int(n24)]
    u_id = tdbg._lookup(torch.as_tensor(kmers), torch.as_tensor(edges >> 2))
    edges_dead = np.concatenate([edges, np.full(3, SENTINEL, np.int64)])
    u_dead = torch.cat([u_id, torch.full((3,), -1, dtype=torch.int32)])
    out, in_ = tdbg.build_adjacency_chunked(torch.as_tensor(kmers), torch.as_tensor(edges_dead), u_dead)
    jo, ji = jax_adj(kmers, edges, int(n24), k=23)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(in_.numpy(), np.asarray(ji))


def test_build_over_window_budget_goes_in_parts():
    """Above the window budget the build counts row parts and merges
    them; the graph is the single pass's (tests/test_torch_chunked.py
    holds the parted build against mcaat_tpu)."""
    batch = encode_sequences(rand_reads(1, n=10))
    one = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, chunk_windows=0, device=CPU)
    parted = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, chunk_windows=100, device=CPU)
    for f in ("kmers", "mult", "out", "in_", "valid"):
        assert torch.equal(getattr(parted, f), getattr(one, f)), f
