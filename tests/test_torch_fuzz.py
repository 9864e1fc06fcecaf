"""Batched LCS / fuzz::ratio parity: the port's plain torch version (what
the CUDA kernel is held against) vs ``mcaat_tpu``'s lax.scan
(``batched_fuzz.lcs_batch``), its Pallas kernel in interpret mode
(``pallas_dp.lcs_batch_pallas(..., interpret=True)``, as
``tests/test_pallas_dp.py`` runs it) and the host ``report.fuzz``.

LCS lengths compare exactly, ratios bit for bit against the JAX float32
results and within 1e-4 of the host float64 scores (the tolerance of
``tests/test_batched_fuzz.py``). Kernel-versus-plain cases need a card
and carry the ``cuda`` marker.

``partial_ratio``: the port's table route (distinct strings encoded
once, windows expanded by the device code; on the CPU its plain torch
version) against ``mcaat_tpu``'s expanded route bit for bit, against a
direct per-window loop, and within 1e-4 of the host ``partial_ratio``.

The all-pairs matrix: the port's table route (one table up, the pairs
enumerated by the device code; on the CPU ``ratio_matrix_plain``) against
``mcaat_tpu``'s ``pairwise_ratio_matrix`` and against its Pallas kernel in
interpret mode on the gathered pairs, bit for bit.
"""

import numpy as np
import pytest
import torch

from mcaat_tpu.report import batched_fuzz as jfuzz
from mcaat_tpu.report.fuzz import lcs_length, partial_ratio, ratio
from mcaat_tpu.report.pallas_dp import lcs_batch_pallas, ratio_batch_pallas
from mcaat_tpu_torch.report import batched_fuzz as tfuzz
from mcaat_tpu_torch.report import lcs_cuda
from torch_fuzz_windows import (
    EDGE_LENGTHS,
    edge_pairs,
    expanded_partial_ratio,
    rand_dna,
)

CPU = torch.device("cpu")


def _rand_strings(rng, n, lo=0, hi=64):
    return [rand_dna(rng, int(rng.integers(lo, hi + 1))) for _ in range(n)]


def _enc(a, b):
    a_c, a_l = tfuzz.encode_batch(a)
    b_c, b_l = tfuzz.encode_batch(b)
    return (a_c, a_l, b_c, b_l), [torch.as_tensor(x) for x in (a_c, a_l, b_c, b_l)]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_plain_lcs_matches_jax_scan_and_host(seed):
    rng = np.random.default_rng(seed)
    a, b = _rand_strings(rng, 60), _rand_strings(rng, 60)
    np_in, t_in = _enc(a, b)
    got = tfuzz.lcs_batch(*t_in).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfuzz.lcs_batch(*np_in)))
    for i in range(len(a)):
        assert got[i] == lcs_length(a[i], b[i]), (a[i], b[i])


@pytest.mark.parametrize("n", [1, 127, 1025])
def test_plain_lcs_matches_pallas_interpret_odd_batches(n):
    rng = np.random.default_rng(2 + n)
    np_in, t_in = _enc(_rand_strings(rng, n, lo=5), _rand_strings(rng, n, lo=5))
    want = np.asarray(lcs_batch_pallas(*np_in, interpret=True))
    np.testing.assert_array_equal(tfuzz.lcs_batch(*t_in).numpy(), want)


def test_plain_ratio_bitwise_equals_pallas_ratio():
    rng = np.random.default_rng(1)
    a, b = _rand_strings(rng, 64, lo=20, hi=50), _rand_strings(rng, 64, lo=20, hi=50)
    np_in, t_in = _enc(a, b)
    lcs, r = tfuzz.lcs_ratio_plain(*t_in)
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(ratio_batch_pallas(*np_in, interpret=True)))
    for i in range(len(a)):
        assert abs(r[i].item() - ratio(a[i], b[i])) < 1e-4


def test_word_edges_and_empty_strings():
    """Every length pair around the 32-bit word edge and at 0 and 64."""
    rng = np.random.default_rng(7)
    lens = [0, 1, 31, 32, 33, 63, 64]
    a = [rand_dna(rng, x) for x in lens for _ in lens]
    b = [rand_dna(rng, y) for _ in lens for y in lens]
    a += ["ACGTACGTACGTACGTACGTACGT", "", "AAAA", "A" * 64]
    b += ["ACGTACGTACGTACGTACGTACGT", "ACGT", "TTTT", "A" * 64]
    np_in, t_in = _enc(a, b)
    lcs, r = tfuzz.lcs_ratio_plain(*t_in)
    np.testing.assert_array_equal(lcs.numpy(), np.asarray(jfuzz.lcs_batch(*np_in)))
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(jfuzz.ratio_batch(*np_in)))
    assert lcs[-4].item() == 24 and lcs[-3].item() == 0 and lcs[-2].item() == 0
    assert lcs[-1].item() == 64
    assert r[0].item() == 100.0  # both empty


def test_pairwise_and_partial_ratio_match_jax_and_host():
    rng = np.random.default_rng(4)
    strings = _rand_strings(rng, 12, lo=10, hi=50) + ["ACGTACGT", "ACGTACGA"]
    got = tfuzz.pairwise_ratio_matrix(strings, CPU)
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))
    assert (np.diag(got) == 100.0).all()
    shorts = [rand_dna(rng, int(rng.integers(5, 30))) for _ in range(10)] + ["", ""]
    longs = [rand_dna(rng, int(rng.integers(30, 60))) for _ in range(10)] + ["", "AC"]
    longs[0] = rand_dna(rng, 10) + shorts[0] + rand_dna(rng, 10)
    got = tfuzz.partial_ratio_pairs(shorts, longs, CPU)
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.partial_ratio_pairs(shorts, longs)))
    assert got[0] == 100.0
    for i in range(len(shorts)):
        assert abs(got[i] - partial_ratio(shorts[i], longs[i])) < 1e-4


def test_ratio_batch_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    _np_in, t_in = _enc(_rand_strings(rng, 9), _rand_strings(rng, 9))
    before = lcs_cuda.LAUNCHES
    r = tfuzz.ratio_batch(*t_in)
    assert lcs_cuda.LAUNCHES == before
    np.testing.assert_array_equal(r.numpy(), tfuzz.lcs_ratio_plain(*t_in)[1].numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        lcs_cuda.lcs_ratio_cuda(*t_in)


def _spacer_systems(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    systems = {}
    for r in range(3):
        sp = [rand_dna(rng, 30) for _ in range(30)]
        sp += [sp[0][:-2], sp[1][2:], sp[2][:-1] + "A"]  # near-substrings
        systems[rand_dna(rng, 28) + "ACG"[r]] = sp
    # a low-diversity system: the diversity check rejects it
    base = rand_dna(rng, 30)
    systems[rand_dna(rng, 29)] = [base[:i] + "A" + base[i + 1 :] for i in range(30)]
    return systems


def test_analyzer_batched_path_matches_jax(tmp_path):
    """More than BATCH_THRESHOLD (24) spacers: the report cascade takes the
    batched path in both packages, and the reports are identical."""
    from mcaat_tpu.report.analyzer import CRISPRAnalyzer as JAnalyzer
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer as TAnalyzer

    systems = _spacer_systems(12)
    assert all(len(s) > TAnalyzer.BATCH_THRESHOLD for s in systems.values())
    want = JAnalyzer(systems, str(tmp_path / "j.txt")).run_analysis()
    got = TAnalyzer(systems, str(tmp_path / "t.txt"), device=CPU).run_analysis()
    assert got == want
    assert "Number of Systems: 3" in got


def _assert_partial_ratio_parity(shorts, longs):
    """The port on the CPU equals mcaat_tpu bit for bit and the host score
    within 1e-4; returns the port's scores. Strings of equal length are
    the exception both batched routes share: the host scores them with
    one plain ``ratio``, the batched routes also slide the clipped
    windows, so there the batched score is at least the host's."""
    got = tfuzz.partial_ratio_pairs(shorts, longs, CPU)
    assert got.dtype == np.float32 and got.shape == (len(shorts),)
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.partial_ratio_pairs(shorts, longs)))
    for i, (a, b) in enumerate(zip(shorts, longs)):
        if len(a) == len(b):
            assert got[i] >= partial_ratio(a, b) - 1e-4, (a, b)
        else:
            assert abs(got[i] - partial_ratio(a, b)) < 1e-4, (a, b)
    return got


@pytest.mark.parametrize("seed", range(6))
def test_partial_ratio_pairs_matches_jax_and_host(seed):
    """Random pairs in any order of lengths, with strings that repeat
    across pairs (they share a table row) and near-substrings."""
    rng = np.random.default_rng(100 + seed)
    pool = _rand_strings(rng, 14) + ["", "A", "ACGT" * 16]
    pool += [pool[0][2:], pool[1][:-3] + "T", pool[2][1:-1]]
    ii = rng.integers(0, len(pool), size=40)
    jj = rng.integers(0, len(pool), size=40)
    shorts, longs = [pool[i] for i in ii], [pool[j] for j in jj]
    got = _assert_partial_ratio_parity(shorts, longs)
    for k in range(len(shorts)):
        if shorts[k] and shorts[k] in longs[k]:
            assert got[k] == 100.0


@pytest.mark.parametrize("ls", EDGE_LENGTHS)
def test_partial_ratio_pairs_edge_lengths(ls):
    """Every length pair over the word edges (0, 1, 2, 31..33, 63, 64),
    both argument orders, and a planted substring: clipped windows at
    both ends, ``ls == ll``, ``ls == 1``, empty strings, a full row."""
    rng = np.random.default_rng(200 + ls)
    shorts, longs = edge_pairs(rng, short_lengths=(ls,))
    got = _assert_partial_ratio_parity(shorts, longs)
    for k in range(len(shorts)):
        if shorts[k] in longs[k]:
            assert got[k] == (100.0 if shorts[k] or not longs[k] else 0.0)


@pytest.mark.parametrize("n", [1, 7, 32, 64])
def test_partial_ratio_tie_rule_both_orders(n):
    """Equal lengths are not symmetric under windowing: the first argument
    is the one that is windowed over the second, as in mcaat_tpu."""
    rng = np.random.default_rng(300 + n)
    a = [rand_dna(rng, n) for _ in range(12)]
    b = [rand_dna(rng, n) for _ in range(12)]
    fwd = _assert_partial_ratio_parity(a, b)
    rev = _assert_partial_ratio_parity(b, a)
    both = _assert_partial_ratio_parity(a + b, b + a)  # one table, both orders
    np.testing.assert_array_equal(_bits(both), _bits(np.concatenate([fwd, rev])))


def test_partial_ratio_pairs_encodes_each_distinct_string_once(monkeypatch):
    rng = np.random.default_rng(8)
    pool = [rand_dna(rng, 30) for _ in range(5)] + ["ACGTAC"]
    shorts = [pool[i % 6] for i in range(60)]
    longs = [pool[(i // 6) % 6] for i in range(60)]
    seen = {}
    plain = tfuzz.partial_ratio_table_plain

    def spy(codes, lengths, s_idx, l_idx):
        seen.update(n=codes.shape[0], pairs=s_idx.shape[0], dtypes=(
            codes.dtype, lengths.dtype, s_idx.dtype, l_idx.dtype))
        assert (lengths[s_idx.long()] <= lengths[l_idx.long()]).all()
        return plain(codes, lengths, s_idx, l_idx)

    monkeypatch.setattr(tfuzz, "partial_ratio_table_plain", spy)
    before = lcs_cuda.launch_counts()
    _assert_partial_ratio_parity(shorts, longs)
    assert lcs_cuda.launch_counts() == before  # CPU tensors: no kernel launch
    assert seen["n"] == 6 and seen["pairs"] == 60
    assert seen["dtypes"] == (torch.uint8, torch.int32, torch.int32, torch.int32)


def test_partial_ratio_pairs_empty_input():
    got = tfuzz.partial_ratio_pairs([], [], CPU)
    assert got.shape == (0,) and got.dtype == np.float32


@pytest.mark.parametrize("seed", range(3))
def test_partial_ratio_table_plain_matches_per_window_loop(seed):
    """The plain table route against a direct loop over the windows of
    each pair (host LCS, float32 ratio in the kernel's order) and against
    the expanded route through the plain per-pair version."""
    rng = np.random.default_rng(400 + seed)
    table = _rand_strings(rng, 10) + ["", "G"]
    codes, lengths = tfuzz.encode_batch(table)
    # any row against any row: the table route does not need ls <= ll
    s_idx = rng.integers(0, len(table), size=50).astype(np.int32)
    l_idx = rng.integers(0, len(table), size=50).astype(np.int32)
    got = tfuzz.partial_ratio_table_plain(
        *(torch.as_tensor(x) for x in (codes, lengths, s_idx, l_idx))
    ).numpy()
    want = np.zeros(len(s_idx), dtype=np.float32)
    for p, (si, li) in enumerate(zip(s_idx, l_idx)):
        s, l = table[si], table[li]
        if not s:
            want[p] = 100.0 if not l else 0.0
            continue
        for start in range(-(len(s) - 1), max(len(l), 1)):
            win = l[max(0, start) : max(0, start + len(s))]
            if win:
                r = np.float32(200.0) * np.float32(lcs_length(s, win)) / np.float32(len(s) + len(win))
                want[p] = max(want[p], r)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ordered = [i for i in range(len(s_idx)) if len(table[s_idx[i]]) <= len(table[l_idx[i]])]
    shorts = [table[s_idx[i]] for i in ordered]
    longs = [table[l_idx[i]] for i in ordered]

    def plain_ratio(*arrays):
        return tfuzz.lcs_ratio_plain(*(torch.as_tensor(x) for x in arrays))[1].numpy()

    np.testing.assert_array_equal(
        _bits(got[ordered]), _bits(expanded_partial_ratio(shorts, longs, plain_ratio))
    )


@pytest.mark.parametrize("where", ["short", "long", "both"])
def test_partial_ratio_pairs_refuses_strings_over_64_bases(where):
    """mcaat_tpu cuts such strings to 64 bases lane by lane; the port's
    table route raises instead of answering differently in silence."""
    rng = np.random.default_rng(9)
    ok, over = rand_dna(rng, 40), rand_dna(rng, 65)
    shorts = [ok, over if where in ("short", "both") else ok]
    longs = [ok, over if where in ("long", "both") else ok]
    with pytest.raises(ValueError, match="65 bases"):
        tfuzz.partial_ratio_pairs(shorts, longs, CPU)
    assert tfuzz.partial_ratio_pairs([ok], [rand_dna(rng, 64)], CPU).shape == (1,)


@pytest.mark.parametrize("n_spacers", [30, 64])
def test_filter_substring_spacers_matches_jax(n_spacers, tmp_path):
    """The greedy near-substring filter on the batched path (more than 24
    spacers): the same spacers in the same order as mcaat_tpu's."""
    from mcaat_tpu.report.analyzer import CRISPRAnalyzer as JAnalyzer
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer as TAnalyzer

    rng = np.random.default_rng(n_spacers)
    sp = [rand_dna(rng, int(rng.integers(26, 41))) for _ in range(n_spacers - 6)]
    sp += [sp[0][:-2], sp[1][2:], sp[2][:-1] + "A", sp[3][1:], "A" + sp[4][:-1], sp[5]]
    order = rng.permutation(len(sp))
    sp = [sp[i] for i in order]
    assert len(sp) == n_spacers > TAnalyzer.BATCH_THRESHOLD
    want = JAnalyzer({}, str(tmp_path / "j.txt")).filter_substring_spacers(sp)
    got = TAnalyzer({}, str(tmp_path / "t.txt"), device=CPU).filter_substring_spacers(sp)
    assert got == want
    assert len(got) < len(set(sp))  # the near-substrings went


def _table_inputs(n=3, pairs=5):
    return [
        torch.zeros((n, 64), dtype=torch.uint8),
        torch.full((n,), 20, dtype=torch.int32),
        torch.zeros(pairs, dtype=torch.int32),
        torch.ones(pairs, dtype=torch.int32),
    ]


@pytest.mark.parametrize(
    "arg,bad,match",
    [
        (None, None, "CUDA tensors"),
        (0, torch.zeros((3, 64), dtype=torch.int32), "codes must be"),
        (0, torch.zeros((3, 32), dtype=torch.uint8), "codes must be"),
        (1, torch.full((3,), 20, dtype=torch.int64), "lengths must be"),
        (1, torch.full((4,), 20, dtype=torch.int32), "lengths must be"),
        (2, torch.zeros(5, dtype=torch.int64), "s_idx must be"),
        (3, torch.zeros(4, dtype=torch.int32), "l_idx must be"),
        (3, torch.zeros(10, dtype=torch.int32)[::2], "l_idx must be contiguous"),
    ],
)
def test_partial_ratio_cuda_refuses_what_the_kernel_does_not_take(arg, bad, match):
    """CPU tensors, a wrong dtype, a wrong shape and a strided view raise;
    nothing falls back to the plain version."""
    inputs = _table_inputs()
    if arg is not None:
        inputs[arg] = bad
    before = lcs_cuda.PARTIAL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        lcs_cuda.partial_ratio_cuda(*inputs)
    assert lcs_cuda.PARTIAL_LAUNCHES == before


def test_partial_ratio_table_takes_plain_version_for_cpu_tensors():
    inputs = _table_inputs()
    before = lcs_cuda.launch_counts()
    r = tfuzz.partial_ratio_table(*inputs)
    assert lcs_cuda.launch_counts() == before
    np.testing.assert_array_equal(r.numpy(), np.full(5, 100.0, dtype=np.float32))


def test_launch_counts_are_per_kernel(monkeypatch):
    monkeypatch.setattr(lcs_cuda, "LAUNCHES", 3)
    monkeypatch.setattr(lcs_cuda, "PARTIAL_LAUNCHES", 2)
    monkeypatch.setattr(lcs_cuda, "MATRIX_LAUNCHES", 5)
    assert lcs_cuda.launch_counts() == {"lcs_ratio": 3, "partial_ratio": 2, "ratio_matrix": 5}
    lcs_cuda.reset_launch_counts()
    assert lcs_cuda.launch_counts() == {"lcs_ratio": 0, "partial_ratio": 0, "ratio_matrix": 0}


def test_build_covers_every_kernel_source():
    import glob
    import os

    sources = sorted(os.path.basename(p) for p in glob.glob(os.path.join(lcs_cuda.SOURCE_DIR, "*.cu")))
    # the three kernels, and the integer-rate probe that is built with them
    assert sources == ["int_rate.cu", "lcs.cu", "partial_ratio.cu", "ratio_matrix.cu"]
    for src in sources:  # all three kernels on the one register core
        with open(os.path.join(lcs_cuda.SOURCE_DIR, src)) as fh:
            assert ('#include "lcs_core.cuh"' in fh.read()) == (src != "int_rate.cu")


def _table(strings):
    codes, lengths = tfuzz.encode_batch(strings)
    return (codes, lengths), (torch.as_tensor(codes), torch.as_tensor(lengths))


def _gathered(codes, lengths):
    """The n² pairs as lanes, the way mcaat_tpu's pairwise_ratio_matrix
    lays them out: row i against row j at lane i * n + j."""
    n = len(lengths)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    return codes[ii], lengths[ii], codes[jj], lengths[jj]


MATRIX_TABLES = {
    "empty strings": lambda rng: ["", rand_dna(rng, 20), "", rand_dna(rng, 41)],
    "64-base strings": lambda rng: [rand_dna(rng, 64) for _ in range(3)] + ["A" * 64, rand_dna(rng, 63)],
    "duplicates": lambda rng: [rand_dna(rng, 30)] * 3 + [rand_dna(rng, 30), "ACGT", "ACGT"],
    "n = 1": lambda rng: [rand_dna(rng, 33)],
    "n = 1, empty": lambda rng: [""],
    "n = 0": lambda rng: [],
    "a 30-spacer system": lambda rng: _rand_strings(rng, 30, lo=26, hi=40),
    "33 strings of any length": lambda rng: _rand_strings(rng, 33),
}


@pytest.mark.parametrize("case", list(MATRIX_TABLES))
def test_pairwise_ratio_matrix_matches_jax(case):
    strings = MATRIX_TABLES[case](np.random.default_rng(500 + len(case)))
    n = len(strings)
    got = tfuzz.pairwise_ratio_matrix(strings, CPU)
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))
    np.testing.assert_array_equal(_bits(got), _bits(got.T))  # symmetric bit for bit
    assert (np.diag(got) == 100.0).all()  # the empty string too
    for i in range(n):
        for j in range(n):
            assert abs(got[i, j] - ratio(strings[i], strings[j])) < 1e-4


@pytest.mark.parametrize("seed", range(3))
def test_ratio_matrix_plain_matches_jax_and_pallas_interpret(seed):
    rng = np.random.default_rng(600 + seed)
    strings = _rand_strings(rng, 5 + 9 * seed) + ["", "A" * 64]
    strings.append(strings[0])
    (codes, lengths), t_in = _table(strings)
    n = len(strings)
    got = tfuzz.ratio_matrix_plain(*t_in)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    got = got.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))
    lanes = _gathered(codes, lengths)
    want = np.asarray(ratio_batch_pallas(*lanes, interpret=True)).reshape(n, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # and what the per-pair route of the port gives on the same lanes
    per_pair = tfuzz.ratio_batch(*(torch.as_tensor(x) for x in lanes)).numpy().reshape(n, n)
    np.testing.assert_array_equal(_bits(got), _bits(per_pair))


def test_pairwise_ratio_matrix_random_tables():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=30, deadline=None, derandomize=True, database=None)
    @hypothesis.given(st.lists(st.text(alphabet="ACGTN", max_size=64), max_size=12))
    def check(strings):
        got = tfuzz.pairwise_ratio_matrix(strings, CPU)
        assert got.shape == (len(strings), len(strings))
        np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))
        np.testing.assert_array_equal(_bits(got), _bits(got.T))
        assert (np.diag(got) == 100.0).all()

    check()


def test_pairwise_ratio_matrix_cuts_longer_strings_like_jax():
    rng = np.random.default_rng(10)
    strings = [rand_dna(rng, 80), rand_dna(rng, 65), rand_dna(rng, 30)]
    got = tfuzz.pairwise_ratio_matrix(strings, CPU)
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))
    cut = tfuzz.pairwise_ratio_matrix([s[:64] for s in strings], CPU)
    np.testing.assert_array_equal(_bits(got), _bits(cut))


def test_pairwise_ratio_matrix_sends_the_table_in_one_buffer(monkeypatch):
    """One upload: the codes and the lengths are views of one tensor, and
    no pair index exists on the host side of the call."""
    rng = np.random.default_rng(11)
    strings = _rand_strings(rng, 9)
    seen = {}
    plain = tfuzz.ratio_matrix_plain

    def spy(codes, lengths):
        seen.update(
            shapes=(tuple(codes.shape), tuple(lengths.shape)),
            dtypes=(codes.dtype, lengths.dtype),
            one_buffer=codes.untyped_storage().data_ptr() == lengths.untyped_storage().data_ptr(),
            aligned=codes.data_ptr() % 16 == 0 and codes.is_contiguous() and lengths.is_contiguous(),
        )
        return plain(codes, lengths)

    monkeypatch.setattr(tfuzz, "ratio_matrix_plain", spy)
    before = lcs_cuda.launch_counts()
    got = tfuzz.pairwise_ratio_matrix(strings, CPU)
    assert lcs_cuda.launch_counts() == before  # CPU tensors: no kernel launch
    assert seen == {
        "shapes": ((9, 64), (9,)), "dtypes": (torch.uint8, torch.int32),
        "one_buffer": True, "aligned": True,
    }
    np.testing.assert_array_equal(_bits(got), _bits(jfuzz.pairwise_ratio_matrix(strings)))


def test_ratio_matrix_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(12)
    _np_in, t_in = _table(_rand_strings(rng, 7))
    before = lcs_cuda.launch_counts()
    r = tfuzz.ratio_matrix(*t_in)
    assert lcs_cuda.launch_counts() == before
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(tfuzz.ratio_matrix_plain(*t_in).numpy()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        lcs_cuda.ratio_matrix_cuda(*t_in)
    with pytest.raises(ValueError, match="unsupported device"):
        tfuzz.ratio_matrix(*(t.to("meta") for t in t_in))


@pytest.mark.parametrize(
    "arg,bad,match",
    [
        (0, torch.zeros((3, 64), dtype=torch.int32), "codes must be"),
        (0, torch.zeros((3, 32), dtype=torch.uint8), "codes must be"),
        (0, torch.zeros((3, 128), dtype=torch.uint8)[:, ::2], "codes must be contiguous"),
        (0, torch.zeros(3 * 64 + 4, dtype=torch.uint8)[4:].view(3, 64), "16-byte aligned"),
        (1, torch.full((3,), 20, dtype=torch.int64), "lengths must be"),
        (1, torch.full((4,), 20, dtype=torch.int32), "lengths must be"),
    ],
)
def test_ratio_matrix_cuda_refuses_what_the_kernel_does_not_take(arg, bad, match):
    inputs = _table_inputs()[:2]
    inputs[arg] = bad
    before = lcs_cuda.MATRIX_LAUNCHES
    with pytest.raises(ValueError, match=match):
        lcs_cuda.ratio_matrix_cuda(*inputs)
    assert lcs_cuda.MATRIX_LAUNCHES == before


@pytest.mark.parametrize(
    "n,run", [(0, 1), (1, 1), (30, 1), (64, 1), (257, 1), (512, 1), (1024, 2), (2048, 8), (4096, 32), (100000, 64)]
)
def test_matrix_run_spreads_small_tables_and_caps_large_ones(n, run):
    assert lcs_cuda.matrix_run(n) == run
    assert 1 <= lcs_cuda.matrix_run(n) <= lcs_cuda.MATRIX_MAX_RUN


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LCS kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B in (1, 31, 32, 33, 4097):
        a = _rand_strings(rng, B)
        b = [s if i % 5 == 0 else rand_dna(rng, int(rng.integers(0, 65))) for i, s in enumerate(a)]
        a_c, a_l, b_c, b_l = (torch.as_tensor(x, device=dev) for x in _enc(a, b)[0])
        before = lcs_cuda.LAUNCHES
        l1, r1 = lcs_cuda.lcs_ratio_cuda(a_c, a_l, b_c, b_l)
        assert lcs_cuda.LAUNCHES == before + 1
        l2, r2 = tfuzz.lcs_ratio_plain(a_c, a_l, b_c, b_l)
        torch.cuda.synchronize()
        assert torch.equal(l1, l2)
        assert torch.equal(r1.view(torch.int32), r2.view(torch.int32))


@pytest.mark.cuda
def test_kernel_refuses_misshapen_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LCS kernel has no CPU mode")
    dev = torch.device("cuda")
    codes = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
    lens = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="a_codes"):
        lcs_cuda.lcs_ratio_cuda(codes, lens, codes, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge grid", "tables of 1, 2 and 64", "pair counts"])
def test_partial_ratio_kernel_matches_plain_and_expanded_route_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partial_ratio kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    if case == "edge grid":
        tables = [edge_pairs(rng)]
    elif case == "tables of 1, 2 and 64":
        tables = []
        for n in (1, 2, 64):
            pool = _rand_strings(rng, n)
            ii, jj = rng.integers(0, n, size=200), rng.integers(0, n, size=200)
            tables.append(([pool[i] for i in ii], [pool[j] for j in jj]))
    else:
        pool = _rand_strings(rng, 40, lo=20, hi=45)
        tables = []
        for P in (1, 31, 32, 33, 4097):
            ii, jj = rng.integers(0, 40, size=P), rng.integers(0, 40, size=P)
            tables.append(([pool[i] for i in ii], [pool[j] for j in jj]))

    def kernel_ratio(*arrays):
        return lcs_cuda.lcs_ratio_cuda(*(torch.as_tensor(x, device=dev) for x in arrays))[1].cpu().numpy()

    for shorts, longs in tables:
        before = lcs_cuda.PARTIAL_LAUNCHES
        got = tfuzz.partial_ratio_pairs(shorts, longs, dev)
        assert lcs_cuda.PARTIAL_LAUNCHES == before + 1
        np.testing.assert_array_equal(_bits(got), _bits(tfuzz.partial_ratio_pairs(shorts, longs, CPU)))
        np.testing.assert_array_equal(_bits(got), _bits(expanded_partial_ratio(shorts, longs, kernel_ratio)))


@pytest.mark.cuda
def test_partial_ratio_kernel_marks_out_of_range_pairs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partial_ratio kernel has no CPU mode")
    dev = torch.device("cuda")
    codes, lengths, s_idx, l_idx = (t.to(dev) for t in _table_inputs())
    s_idx[1] = 3
    l_idx[2] = -1
    out = lcs_cuda.partial_ratio_cuda(codes, lengths, s_idx, l_idx).cpu().numpy()
    assert np.isnan(out[[1, 2]]).all() and (out[[0, 3, 4]] == 100.0).all()


def _matrix_case_tables(rng):
    """Tables of 1, 2, 30, 33, 64 and 257 strings over every length, with
    empty strings, 64-base strings and duplicates among them."""
    for n in (1, 2, 30, 33, 64, 257):
        strings = _rand_strings(rng, n)
        strings[0] = rand_dna(rng, 64)
        if n > 2:
            strings[1] = ""
            strings[2] = strings[0]
        yield strings


@pytest.mark.cuda
def test_ratio_matrix_kernel_matches_plain_and_gathered_route_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ratio_matrix kernel has no CPU mode")
    dev = torch.device("cuda")
    for strings in _matrix_case_tables(np.random.default_rng(13)):
        (codes, lengths), _t = _table(strings)
        n = len(strings)
        before = lcs_cuda.launch_counts()
        got = tfuzz.pairwise_ratio_matrix(strings, dev)
        after = lcs_cuda.launch_counts()
        assert after["ratio_matrix"] == before["ratio_matrix"] + 1
        assert after["lcs_ratio"] == before["lcs_ratio"]
        np.testing.assert_array_equal(_bits(got), _bits(tfuzz.pairwise_ratio_matrix(strings, CPU)))
        lanes = [torch.as_tensor(x, device=dev) for x in _gathered(codes, lengths)]
        per_pair = lcs_cuda.lcs_ratio_cuda(*lanes)[1].cpu().numpy().reshape(n, n)
        np.testing.assert_array_equal(_bits(got), _bits(per_pair))
    # larger tables, where a warp walks a run of several columns
    rng = np.random.default_rng(15)
    for n in (1024, 2048):
        assert lcs_cuda.matrix_run(n) > 1
        codes = rng.integers(0, 4, (n, 64), dtype=np.uint8)
        lengths = rng.integers(0, 65, n).astype(np.int32)
        got = lcs_cuda.ratio_matrix_cuda(
            torch.as_tensor(codes, device=dev), torch.as_tensor(lengths, device=dev)
        )
        lanes = [torch.as_tensor(x, device=dev) for x in _gathered(codes, lengths)]
        per_pair = lcs_cuda.lcs_ratio_cuda(*lanes)[1].view(n, n)
        assert torch.equal(got.view(torch.int32), per_pair.view(torch.int32))


@pytest.mark.cuda
def test_ratio_matrix_kernel_marks_out_of_range_lengths_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ratio_matrix kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    strings = _rand_strings(rng, 40)
    (codes, lengths), _t = _table(strings)
    want = tfuzz.pairwise_ratio_matrix(strings, CPU)
    lengths[5], lengths[37] = 65, -1
    out = lcs_cuda.ratio_matrix_cuda(
        torch.as_tensor(codes, device=dev), torch.as_tensor(lengths, device=dev)
    ).cpu().numpy()
    bad = np.zeros((40, 40), dtype=bool)
    bad[[5, 37], :] = True
    bad[:, [5, 37]] = True
    assert np.isnan(out[bad]).all()
    np.testing.assert_array_equal(_bits(out[~bad]), _bits(want[~bad]))
