"""Reads as a sequencer gives them: paired-end mates with substitution
errors, plain and gzipped (``tests/torch_reads.py``).

Every input here is made from a seed; the tolerance is a byte-identical
report. The JAX package and the port must agree on mates with errors at
0.5% and 1% a base with the big-graph branches forced on; the gzipped
pair must give the plain pair's report; the port's report of
``planted-20x30-err-pe-1M`` must equal the committed JAX-written one
(its input's SHA-1 first); the sharded path and a two-process gloo group
must give the single-device report on two files, plain and gzipped. The
helper itself: one seed, one byte stream; the substitution count near
``rate`` times the bases; mate 2 the reverse complement of the reads it
came from.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

import mcaat_tpu.cycles.finder as jfinder
import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.cycles.finder as tfinder
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.settings import Settings
from tests import torch_reads
from tests.torch_probes import probe_pipeline

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# two arrays of 26 spacers (past the batched report's 24) in a small background
SMALL = dict(seed=29, n_arrays=2, n_spacers=26, background_len=6000, background_coverage=6.0,
             coverage=40.0)


@pytest.fixture(autouse=True)
def _synthetic_on_path(monkeypatch):
    # torch_reads imports synthetic as chip_smoke.py does, from tests/
    monkeypatch.syspath_prepend(HERE)


def _port(files, out, **kw):
    return tpipeline.run_pipeline(
        Settings(input_files=" ".join(files), output_file=str(out), **kw), verbose=False,
        device="cpu",
    )


@pytest.mark.parametrize("rate", [0.005, 0.01])
def test_paired_error_reads_report_matches_jax(rate, tmp_path, monkeypatch):
    got = torch_reads.make_input(str(tmp_path / "in"), rate, error_seed=3, **SMALL)
    assert got["substitutions"] > 0 and len(got["files"]) == 2
    for mod in (jfinder, tfinder):
        monkeypatch.setattr(mod, "NEIGHBORHOOD_MIN_NODES", 0)
        monkeypatch.setattr(mod, "LAZY_CLIP_MIN_NODES", 0)
    monkeypatch.setattr(jpipeline, "REGION_CONDENSE_MIN_NODES", 0)
    monkeypatch.setattr(tpipeline, "REGION_CONDENSE_MIN_NODES", 0)
    want = jpipeline.run_pipeline(
        JSettings(input_files=" ".join(got["files"]), output_file=str(tmp_path / "j.txt")),
        verbose=False,
    )
    with probe_pipeline() as probe:
        mine = _port(got["files"], tmp_path / "t.txt")
    assert mine.report_text == want.report_text
    assert f"Number of Systems: {SMALL['n_arrays']}" in mine.report_text
    # mate 2 went through its reverse complement
    assert probe["rc_reads"] == got["n_reads"] - got["n_reads"] // 2


def test_gzipped_pair_gives_the_plain_report(tmp_path):
    plain = torch_reads.make_input(str(tmp_path / "plain"), 0.01, **SMALL)
    gz = torch_reads.make_input(str(tmp_path / "gz"), 0.01, gz=True, **SMALL)
    assert gz["sha1"] == plain["sha1"]
    for p, g in zip(plain["files"], gz["files"]):
        assert g.endswith(".fq.gz")
        with open(p, "rb") as fh, gzip.open(g, "rb") as gh:
            assert gh.read() == fh.read()
    a = _port(plain["files"], tmp_path / "a.txt")
    b = _port(gz["files"], tmp_path / "b.txt")
    assert a.report_text and b.report_text == a.report_text


def test_err_pe_1m_report_equals_the_jax_fixture(tmp_path):
    """planted-20x30-err-pe-1M (97,860 reads, 0.5% substitutions, two
    mates): the input's SHA-1 is checked first, so that a generator that
    drifted fails as such, then the port's report on the CPU must equal
    the one the JAX package wrote (``tests/torch_data/err_pe_1M/``)."""
    got = torch_reads.make_named(torch_reads.FIXTURE_INPUT, str(tmp_path / "in"))
    assert got["sha1"] == torch_reads.fixture_sha1(), "the input generator drifted"
    _port(got["files"], tmp_path / "t.txt")
    assert (tmp_path / "t.txt").read_bytes() == torch_reads.fixture_report()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_sharded_two_files_equal_the_single_device(gz, tmp_path, monkeypatch):
    got = torch_reads.make_input(str(tmp_path / "in"), 0.01, gz=gz, **SMALL)
    single = _port(got["files"], tmp_path / "single.txt", mesh="off")
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "4")
    with probe_pipeline() as probe:
        sharded = _port(got["files"], tmp_path / "sharded.txt", mesh="auto")
    assert "map_sources" in [s.name for s in sharded.profile.stages]  # the sharded path ran
    assert probe["rc_reads"] == got["n_reads"] - got["n_reads"] // 2
    assert single.report_text and sharded.report_text == single.report_text


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_two_process_group_two_files(gz, tmp_path):
    """Two gloo processes of 4 CPU shards on two mate files with 1%
    substitutions: a plain file is cut into byte ranges, a gzipped one is
    parsed whole by each process, which keeps records ``pid::2``; the
    report equals the single-process one."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multihost_dryrun.py"),
         str(tmp_path / "work"), "--paired", "--error-rate", "0.01", *(["--gz"] if gz else [])],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "MULTIHOST DRYRUN PASSED" in res.stdout
    assert "in 2 file(s)" in res.stdout
    ext = ".fq.gz" if gz else ".fq"
    assert sorted(os.listdir(tmp_path / "work")).count("reads_2" + ext) == 1
    assert (tmp_path / "work" / "mh_CRISPR_Arrays.txt").read_text() == (
        tmp_path / "work" / "sp_CRISPR_Arrays.txt"
    ).read_text()


# --- the helper ---------------------------------------------------------


def _fastq_reads(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    assert lines[0] == b"@read0"
    return np.array([np.frombuffer(s, dtype=np.uint8) for s in lines[1::4]])


def test_one_seed_one_byte_stream(tmp_path):
    a = torch_reads.make_input(str(tmp_path / "a"), 0.005, error_seed=1, **SMALL)
    b = torch_reads.make_input(str(tmp_path / "b"), 0.005, error_seed=1, **SMALL)
    c = torch_reads.make_input(str(tmp_path / "c"), 0.005, error_seed=2, **SMALL)
    assert a["sha1"] == b["sha1"] != c["sha1"]
    for x, y in zip(a["files"], b["files"]):
        assert open(x, "rb").read() == open(y, "rb").read()
    assert a["arrays"] == c["arrays"]


@pytest.mark.parametrize("rate", [0.005, 0.01])
def test_substitutions_near_the_rate(rate):
    _arrays, clean = torch_reads.metagenome_matrix(**SMALL)
    reads = clean.copy()
    n = torch_reads.add_substitutions(reads, rate, error_seed=5, block_rows=1000)
    diff = reads != clean
    assert int(diff.sum()) == n  # every hit became another base
    expect = rate * reads.size
    assert abs(n - expect) < 5 * np.sqrt(expect), (n, expect)
    assert set(np.unique(reads)) <= set(b"ACGT")
    # the new base is one of the other three, each about a third of the time
    shift = (torch_reads._CODE[reads[diff]].astype(int) - torch_reads._CODE[clean[diff]]) % 4
    counts = np.bincount(shift, minlength=4)
    assert counts[0] == 0 and all(abs(c - n / 3) < 5 * np.sqrt(n / 3) for c in counts[1:])


def test_mate_two_is_the_reverse_complement(tmp_path):
    from mcaat_tpu_torch.io.fastq import reverse_complement

    _arrays, reads = torch_reads.metagenome_matrix(**SMALL)
    torch_reads.add_substitutions(reads, 0.01, error_seed=1)
    got = torch_reads.write_reads(str(tmp_path), reads, paired=True, gz=True)
    m1, m2 = (_fastq_reads(f) for f in got["files"])
    half = reads.shape[0] // 2
    assert np.array_equal(m1, reads[:half]) and m2.shape[0] == reads.shape[0] - half
    for i in (0, 1, m2.shape[0] - 1):
        assert bytes(m2[i]).decode() == reverse_complement(bytes(reads[half + i]).decode())
    assert np.array_equal(torch_reads.reverse_complement_matrix(m2), reads[half:])


# --- the at-scale script -------------------------------------------------


def test_e2e_script_rehearses_error_bearing_mates(tmp_path):
    """``scripts/torch_e2e_big.py`` with ``--error-rate --paired --gz`` on
    the CPU at a small size: cold, warm, ``--ram`` and 4 shards give one
    report, and every run reverse-complements mate 2 once."""
    out = tmp_path / "e2e.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_e2e_big.py"), "2", "200000", "8",
         "--device", "cpu", "--error-rate", "0.005", "--paired", "--gz", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    import json

    fig = json.loads(out.read_text())
    assert fig["reports_identical"] and fig["paired"] and fig["gz"]
    assert fig["substitutions"] > 0.8 * 0.005 * fig["n_reads"] * 100
    assert set(fig["runs"]) == {"cold", "warm", "ram", "shards"}
    for run in fig["runs"].values():
        assert run["reverse_complement_reads"] == fig["n_reads"] - fig["n_reads"] // 2
        assert run["systems"] == 2 and run["nodes"] > 0
    assert "map_sources" in [st["name"] for st in fig["runs"]["shards"]["stages"]]


def test_e2e_script_card_peaks_fold_the_profilers_unindexed_card(monkeypatch):
    """The profiler resets a card's peak as ``torch.device("cuda")`` at
    every stage boundary; ``card_peaks`` must fold that card's running peak
    into ``cuda:0`` first, or a single-device run reports the peak of its
    last stage only."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "torch_e2e_big", os.path.join(REPO, "scripts", "torch_e2e_big.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    peak = {"bytes": 0}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d=None: peak["bytes"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda d=None: peak.update(bytes=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with mod.card_peaks([torch.device("cuda", 0)]) as out:
        peak["bytes"] = 46 << 30  # the build stage
        torch.cuda.reset_peak_memory_stats(torch.device("cuda"))  # a stage boundary
        peak["bytes"] = 1 << 30  # a later, smaller stage
    assert out == {"cuda:0": 46 << 30}
