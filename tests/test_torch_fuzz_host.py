"""The report's host route in compiled code (``mcaat_tpu_torch/native/fuzz.cpp``)
against the Python route (``report/fuzz.py`` and the analyzer's loops),
bit for bit: ``ratio`` and ``partial_ratio`` on seeded pairs of 0-64
bytes (equal and unequal lengths, empty, identical, one inside the
other, N bases, 64 bytes exactly); the diversity check and the substring
filter on seeded systems of 2-24 spacers, with ties at exactly 90.0 and
a mean exactly at ``mean_similarity``, each with the compiled route and
with it forced off; whole reports; a string over 64 bytes and a failed
build, which take the Python route."""

import os
import shutil

import numpy as np
import pytest

from mcaat_tpu_torch import native as tnative
from mcaat_tpu_torch.report import fuzz as tfuzz
from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer
from mcaat_tpu_torch.utils import profiling as tprof

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX", "g++")) is None, reason="no C++ compiler"
)


def _bases(rng, n: int, alphabet: str = "ACGT") -> str:
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=n))


def _pairs(seed: int, n: int = 2000):
    """Pairs of every kind the scores branch on, in turns."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 8
        la, lb = (int(x) for x in rng.integers(0, 65, size=2))
        if kind == 0:  # any lengths
            a, b = _bases(rng, la), _bases(rng, lb)
        elif kind == 1:  # equal lengths
            a, b = _bases(rng, la), _bases(rng, la)
        elif kind == 2:  # an empty string, or both
            a, b = "", _bases(rng, lb) if i % 16 == 2 else ""
        elif kind == 3:  # identical
            a = _bases(rng, la)
            b = a
        elif kind == 4:  # one inside the other
            b = _bases(rng, max(lb, 1))
            s = int(rng.integers(0, len(b)))
            a = b[s:s + int(rng.integers(1, len(b) - s + 1))]
        elif kind == 5:  # N bases
            a, b = _bases(rng, la, "ACGTN"), _bases(rng, lb, "ACGTNN")
        elif kind == 6:  # 64 bytes exactly, against any length
            a, b = _bases(rng, 64), _bases(rng, lb)
        else:  # a near copy: substitutions and a clipped end
            a = _bases(rng, max(la, 2))
            b = "".join(c if rng.random() > 0.1 else "A" for c in a)[int(rng.integers(0, 2)):]
        out.append((a, b) if rng.random() < 0.5 else (b, a))
    return out


def _bits(scores) -> np.ndarray:
    return np.asarray(scores, dtype=np.float64).view(np.uint64)


def _python_route(monkeypatch):
    monkeypatch.setattr(tnative, "_fuzz", None)
    monkeypatch.setattr(tnative, "_fuzz_tried", True)


@pytest.mark.parametrize("scorer", ["ratio", "partial_ratio"])
def test_scores_equal_the_python_bit_for_bit(scorer):
    pairs = _pairs(18)
    a, b = [p[0] for p in pairs], [p[1] for p in pairs]
    assert {len(s) for s in a + b} >= {0, 1, 64}
    want = [getattr(tfuzz, scorer)(x, y) for x, y in pairs]
    got = tnative.fuzz_pair_scores(a, b, partial=scorer == "partial_ratio")
    assert got is not None and got.dtype == np.float64
    assert np.array_equal(_bits(got), _bits(want))
    # the pairs reach the branches: scores of 0, 100 and in between
    assert {0.0, 100.0} <= set(want) and len(set(want)) > 100


def _system(rng, n: int) -> list[str]:
    """n spacers of 20-47 bases with near copies, substrings and N bases,
    as a report's systems carry them."""
    base = int(rng.integers(23, 48))
    out = []
    while len(out) < n:
        r = rng.random()
        if out and r < 0.2:  # a near copy of an earlier spacer
            src = out[int(rng.integers(0, len(out)))]
            s = "".join(c if rng.random() > 0.06 else "G" for c in src)
            out.append(s[: len(s) - int(rng.integers(0, 3))])
        elif out and r < 0.3:  # a part of one
            src = out[int(rng.integers(0, len(out)))]
            out.append(src[int(rng.integers(0, 4)):])
        else:
            length = max(20, base + int(rng.integers(-3, 4)))
            out.append(_bases(rng, length, "ACGT" if r < 0.9 else "ACGTN"))
    return out


def _counted(fn, *args):
    """``fn(*args)`` and the counters it left on a stage."""
    prof = tprof.Profiler()
    with prof.stage("report"):
        got = fn(*args)
    return got, prof.span_records()[0]["counters"]


def _both_routes(monkeypatch, fn, *args):
    compiled = _counted(fn, *args)
    with monkeypatch.context() as m:
        _python_route(m)
        python = _counted(fn, *args)
    return compiled, python


@pytest.mark.parametrize("seed", range(6))
def test_the_filter_and_the_check_agree_on_seeded_systems(seed, monkeypatch):
    rng = np.random.default_rng(1800 + seed)
    an = CRISPRAnalyzer({}, os.devnull, device="cpu")
    for n in range(2, 25):
        spacers = _system(rng, n)
        (kept, c_ctr), (kept_py, p_ctr) = _both_routes(monkeypatch, an.filter_substring_spacers,
                                                        spacers)
        assert kept == kept_py
        assert c_ctr["host_route_pairs"] == p_ctr["host_route_pairs"] > 0
        assert c_ctr["host_route_compiled_pairs"] == c_ctr["host_route_pairs"]
        assert p_ctr["host_route_compiled_pairs"] == 0
        # the mean the check compares: the same double
        want = [tfuzz.ratio(spacers[i], spacers[j]) for i in range(n) for j in range(i + 1, n)]
        got = tnative.fuzz_ratio_all_pairs(spacers).tolist()
        assert _bits(got).tolist() == _bits(want).tolist()
        mean = sum(want) / len(want)
        assert sum(got) / len(got) == mean
        for limit in (an.mean_similarity, mean, float(np.nextafter(mean, -np.inf))):
            an.mean_similarity = limit
            (ok, c_ctr), (ok_py, p_ctr) = _both_routes(monkeypatch, an.validate_spacer_diversity,
                                                        spacers)
            assert ok == ok_py
            assert c_ctr["host_route_pairs"] == p_ctr["host_route_pairs"] == len(want)
            assert c_ctr["host_route_compiled_pairs"] == len(want)
            assert p_ctr["host_route_compiled_pairs"] == 0
        an.mean_similarity = 90
        assert ok is False  # just below the mean


def _ties(seed: int, want: int = 6) -> list[tuple[str, str]]:
    """(spacer, other) of equal and unequal lengths whose partial_ratio
    is 90.0 exactly."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < want:
        k = int(rng.integers(0, 2))  # other is 20 or 22 bases
        other = _bases(rng, 20 + 2 * k)
        spacer = "".join(c if rng.random() > 0.1 else "T" for c in other[k:k + 20])
        if tfuzz.partial_ratio(spacer, other) == 90.0:
            out.append((spacer, other))
    return out


def test_ties_at_ninety_and_a_mean_at_the_limit(monkeypatch):
    an = CRISPRAnalyzer({}, os.devnull, mean_similarity=90, device="cpu")
    ties = _ties(7)
    assert {len(s) == len(o) for s, o in ties} == {True, False}
    for spacer, other in ties:
        assert tnative.fuzz_pair_scores([spacer], [other], partial=True).tolist() == [90.0]
        # the tie drops the spacer on both routes
        (kept, _), (kept_py, _) = _both_routes(monkeypatch, an.filter_substring_spacers,
                                               [other, spacer])
        assert kept == kept_py == [other]
    exact = [(s, o) for s, o in ties if len(s) == len(o)]
    for spacer, other in exact:
        assert tfuzz.ratio(spacer, other) == 90.0  # a mean of 90.0 exactly
        for limit, ok in ((90, True), (89, False)):
            an.mean_similarity = limit
            (got, _), (got_py, _) = _both_routes(monkeypatch, an.validate_spacer_diversity,
                                                 [spacer, other])
            assert got is got_py is ok


def test_whole_reports_are_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(1818)
    systems = {}
    for k in range(40):
        repeat = _bases(rng, int(rng.integers(23, 40)))
        flank = _bases(rng, int(rng.integers(0, 3)))  # a common prefix to trim
        systems[repeat] = [flank + s for s in _system(rng, int(rng.integers(2, 25)))]
    texts = []
    for route in ("compiled", "python"):
        with monkeypatch.context() as m:
            if route == "python":
                _python_route(m)
            an = CRISPRAnalyzer(systems, str(tmp_path / f"{route}.txt"), device="cpu")
            text, ctr = _counted(an.run_analysis)
        texts.append((text, ctr))
    (text, ctr), (text_py, ctr_py) = texts
    assert text == text_py
    assert ctr["host_route_pairs"] == ctr_py["host_route_pairs"] > 1000
    assert ctr["host_route_compiled_pairs"] == ctr["host_route_pairs"]
    assert ctr_py["host_route_compiled_pairs"] == 0
    assert 0 < ctr["systems"] < len(systems)


@pytest.mark.parametrize("odd", ["A" * 65, "ACGT✓ACGT"])
def test_a_string_that_does_not_fit_takes_the_python_route(odd, monkeypatch):
    """Over 64 bytes (a user's --max-sl above 64), or a character over one
    byte: the Python loops, and no pair counted as compiled."""
    rng = np.random.default_rng(65)
    spacers = _system(rng, 6) + [odd]
    assert tnative.fuzz_ratio_all_pairs(spacers) is None
    assert tnative.fuzz_substring_keep(spacers) is None
    an = CRISPRAnalyzer({}, os.devnull, max_sl=80, device="cpu")
    for fn in (an.filter_substring_spacers, an.validate_spacer_diversity):
        (got, ctr), (got_py, ctr_py) = _both_routes(monkeypatch, fn, spacers)
        assert got == got_py
        assert ctr["host_route_pairs"] == ctr_py["host_route_pairs"] > 0
        assert ctr["host_route_compiled_pairs"] == 0


def test_a_failed_build_takes_the_python_route(tmp_path, monkeypatch, capsys):
    """``CXX=false``: no library, a line saying so, and the same results."""
    rng = np.random.default_rng(404)
    systems = [_system(rng, n) for n in (3, 8, 17)]
    an = CRISPRAnalyzer({}, os.devnull, device="cpu")
    want = [(an.filter_substring_spacers(s), an.validate_spacer_diversity(s)) for s in systems]
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(tnative, "_ROOT", str(tmp_path))
    monkeypatch.setattr(tnative, "_fuzz", None)
    monkeypatch.setattr(tnative, "_fuzz_tried", False)
    assert tnative.fuzz_ratio_all_pairs(systems[0]) is None
    assert "fuzz build failed" in capsys.readouterr().out
    assert os.listdir(tmp_path / "build" / "mcaat_tpu_torch") == []
    for s, (kept, ok) in zip(systems, want):
        (got_kept, ctr) = _counted(an.filter_substring_spacers, s)
        assert got_kept == kept and ctr["host_route_compiled_pairs"] == 0
        (got_ok, ctr) = _counted(an.validate_spacer_diversity, s)
        assert got_ok == ok and ctr["host_route_compiled_pairs"] == 0
