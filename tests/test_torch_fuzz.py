"""Batched LCS / fuzz::ratio parity: the port's plain torch version (what
the CUDA kernel is held against) vs ``mcaat_tpu``'s lax.scan
(``batched_fuzz.lcs_batch``), its Pallas kernel in interpret mode
(``pallas_dp.lcs_batch_pallas(..., interpret=True)``, as
``tests/test_pallas_dp.py`` runs it) and the host ``report.fuzz``.

LCS lengths compare exactly, ratios bit for bit against the JAX float32
results and within 1e-4 of the host float64 scores (the tolerance of
``tests/test_batched_fuzz.py``). Kernel-versus-plain cases need a card
and carry the ``cuda`` marker.
"""

import numpy as np
import pytest
import torch

from mcaat_tpu.report import batched_fuzz as jfuzz
from mcaat_tpu.report.fuzz import lcs_length, partial_ratio, ratio
from mcaat_tpu.report.pallas_dp import lcs_batch_pallas, ratio_batch_pallas
from mcaat_tpu_torch.report import batched_fuzz as tfuzz
from mcaat_tpu_torch.report import lcs_cuda

CPU = torch.device("cpu")


def rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


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
