"""k-mer extraction and counting parity: mcaat_tpu_torch vs mcaat_tpu.

Same seeded inputs through both packages; integer results compare
exactly (the port's tables are the JAX tables' live rows).
"""

import numpy as np
import pytest
import torch

from mcaat_tpu.io.fastq import encode_sequences
from mcaat_tpu.kmer import count as jcount
from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.kmer import count as tcount
from tests.test_torch_graph import rand_reads


def _batch(seed, lo=5, hi=90):
    b = encode_sequences(rand_reads(seed, n=30, lo=lo, hi=hi))
    return b.codes, b.lengths, torch.as_tensor(b.codes), torch.as_tensor(b.lengths)


@pytest.mark.parametrize("k", [5, 23, 24])
def test_extract_kmers_matches_jax(k):
    codes, lengths, c_t, l_t = _batch(1)
    want = np.asarray(jcount.extract_kmers(codes, lengths, k))
    got = tcount.extract_kmers(c_t, l_t, k).numpy()
    np.testing.assert_array_equal(got, want)
    w = 40
    np.testing.assert_array_equal(
        tcount.extract_kmers(c_t, l_t, k, w_cap=w).numpy(),
        np.asarray(jcount.extract_kmers(codes, lengths, k, w_cap=w)),
    )


@pytest.mark.parametrize("k", [23, 24])
def test_revcomp_matches_jax_unsigned(k):
    """int64 ``>>`` is arithmetic: every shift in the port is masked, so
    high-bit patterns and SENTINEL come out as in JAX's uint64 math."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << (2 * k), 2000, dtype=np.int64)
    x = np.concatenate([x, [0, (1 << (2 * k)) - 1, SENTINEL]]).astype(np.int64)
    got = tcount.revcomp_kmers(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcount.revcomp_kmers(x, k)))
    live = got != SENTINEL
    np.testing.assert_array_equal(
        tcount.revcomp_kmers(torch.as_tensor(got), k).numpy()[live], x[live]
    )


def test_first_last_kmer_match_jax():
    codes, lengths, c_t, l_t = _batch(2, lo=10, hi=60)
    for name in ("extract_first_kmer", "extract_last_kmer"):
        want = np.asarray(getattr(jcount, name)(codes, lengths, 23))
        got = getattr(tcount, name)(c_t, l_t, 23).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_count_unique_matches_jax_live_rows():
    codes, lengths, c_t, l_t = _batch(3)
    km = np.array(jcount.extract_kmers(codes, lengths, 6)).reshape(-1)
    ju, jc, jn = jcount.count_unique(km)
    tu, tc, tn = tcount.count_unique(torch.as_tensor(km))
    assert tn == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju)[:tn])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:tn])


def test_derive_nodes_from_edges_matches_jax():
    codes, lengths, c_t, l_t = _batch(4, lo=24, hi=90)
    km1 = np.asarray(jcount.extract_kmers(codes, lengths, 24)).reshape(-1)
    km1 = np.concatenate([km1, np.asarray(jcount.revcomp_kmers(km1, 24))])
    last = np.array(jcount.extract_last_kmer(codes, lengths, 23))
    u24, c24, n24 = jcount.count_unique(km1)
    ul, cl, _nl = jcount.count_unique(last)
    ju, jc, jn, jid = jcount.derive_nodes_from_edges(u24, c24, n24, ul, cl)
    tu24, tc24, tn24 = tcount.count_unique(torch.as_tensor(km1))
    tul, tcl, _ = tcount.count_unique(torch.as_tensor(last))
    tu, tc, tn, tid = tcount.derive_nodes_from_edges(tu24, tc24, tul, tcl)
    assert tn == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju)[:tn])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:tn])
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid)[: int(n24)])


def test_compact_counted_sorted_matches_jax():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 50, 300)).astype(np.int64)
    # JAX's bounded-run contract: no key more than max_run times
    keys = np.concatenate([np.unique(keys)] * 3)
    keys.sort()
    cnts = rng.integers(1, 9, keys.shape[0]).astype(np.int32)
    ju, jc, jn, _h, ovf = jcount._compact_counted_sorted(keys, cnts, max_run=3)
    assert int(ovf) == 0
    tu, tc, tn, inv = tcount._compact_counted_sorted(torch.as_tensor(keys), torch.as_tensor(cnts))
    assert tn == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju)[:tn])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:tn])
    np.testing.assert_array_equal(tu.numpy()[inv.numpy()], keys)
