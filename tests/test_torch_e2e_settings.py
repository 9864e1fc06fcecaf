"""The settings cases of ``tests/test_e2e.py`` and
``tests/test_aux_components.py`` through both packages on the CPU: the
``threshold_multiplicity`` sweep, the cycle-length window, the forked
ordering pool against the serial loop, and ``--threads`` driving that
pool. Reports compare byte for byte; each JAX run is made once per
module."""

import contextlib
import io
import os
import re

import pytest

import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.settings import Settings
from tests.synthetic import make_metagenome, write_fastq

INPUTS = {
    "threshold": dict(seed=31, n_arrays=1, n_spacers=6, coverage=40.0),
    "window": dict(seed=33, n_arrays=1, n_spacers=6, coverage=40.0),
    "pool": dict(seed=31, n_arrays=2, n_spacers=4, coverage=35.0),
    "threads": dict(seed=5, n_arrays=1, n_spacers=3, coverage=25.0),
}
# settings-file lines of each case (both packages load the same file)
CASES = {
    "threshold_default": ("threshold", ""),
    "threshold_5000": ("threshold", "threshold_multiplicity=5000\n"),
    "window_27_30": ("window", "cycle_min_length=27\ncycle_max_length=30\n"),
    "threads_1": ("threads", "threads=1\n"),
}


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e_settings")
    paths = {}
    for name, kw in INPUTS.items():
        paths[name] = str(d / f"{name}.fq")
        write_fastq(paths[name], make_metagenome(**kw)["reads"])
    return d, paths


def _settings(cls, d, fq: str, case: str, lines: str):
    s = cls(input_files=fq, output_file=str(d / f"{case}_{cls.__module__.split('.')[0]}.txt"))
    if lines:
        cfg = d / f"{case}.txt"
        cfg.write_text(lines)
        assert s.load_from_file(str(cfg))
    return s


@pytest.fixture(scope="module")
def jax_runs(fastqs):
    """The JAX package's result of every case, made on first use."""
    d, paths = fastqs
    cache: dict = {}

    def get(case: str):
        if case not in cache:
            inp, lines = CASES[case]
            try:
                cache[case] = jpipeline.run_pipeline(
                    _settings(JSettings, d, paths[inp], case, lines), verbose=False
                )
            finally:
                jpipeline.configure_threads(0)
        return cache[case]

    return get


def _port_run(fastqs, case: str):
    d, paths = fastqs
    inp, lines = CASES[case]
    s = _settings(Settings, d, paths[inp], case, lines)
    return s, tpipeline.run_pipeline(s, verbose=False, device="cpu")


@pytest.mark.parametrize("case", ["threshold_default", "threshold_5000"])
def test_settings_sweep_threshold_multiplicity(fastqs, jax_runs, case):
    """A threshold above the array's coverage suppresses every start node;
    at the default the array is found (settings.h:33-38)."""
    s, got = _port_run(fastqs, case)
    want = jax_runs(case)
    if case == "threshold_5000":
        assert s.cycle_finder_settings.threshold_multiplicity == 5000
        assert got.found_systems == [] and want.found_systems == []
    else:
        assert len(got.found_systems) >= 1
    assert got.report_text == want.report_text
    assert [vars(x) for x in got.found_systems] == [vars(x) for x in want.found_systems]


def test_settings_sweep_cycle_length_window(fastqs, jax_runs):
    """A cycle_max_length below the array's period finds no system."""
    s, got = _port_run(fastqs, "window_27_30")
    assert (s.cycle_finder_settings.cycle_min_length, s.cycle_finder_settings.cycle_max_length) == (27, 30)
    want = jax_runs("window_27_30")
    assert got.found_systems == [] and want.found_systems == []
    assert got.report_text == want.report_text
    assert got.cycles_map == want.cycles_map


def _strip_timings(text: str) -> str:
    tail = text.split("Splitting into subproblems")[-1]
    return "\n".join(
        ln for ln in tail.splitlines()
        if not re.search(r"\d+\.\d+s", ln) and not ln.startswith("Saved in:")
    )


def test_parallel_ordering_pool_matches_serial(fastqs, monkeypatch):
    """The forked pool gives the serial loop's report and verbose text
    (``MCAAT_ORDERING_PROCS`` 1 and 2), and the JAX package's serial
    report."""
    d, paths = fastqs
    monkeypatch.setattr(tpipeline, "_ORDERING_POOL_MIN_SUBPROBLEMS", 1)
    pools: list = []
    solve = tpipeline._solve_subproblems

    def spy(host_graph, remaining):
        pools.append((tpipeline._ordering_worker_count(), len(remaining)))
        return solve(host_graph, remaining)

    monkeypatch.setattr(tpipeline, "_solve_subproblems", spy)
    runs = {}
    for procs in ("1", "2"):
        monkeypatch.setenv("MCAAT_ORDERING_PROCS", procs)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = tpipeline.run_pipeline(
                Settings(input_files=paths["pool"], output_file=str(d / f"pool{procs}.txt")),
                verbose=True, device="cpu",
            )
        runs[procs] = (r, buf.getvalue())
    assert [p for p, _n in pools] == [1, 2] and all(n >= 2 for _p, n in pools), pools
    (r1, out1), (r2, out2) = runs["1"], runs["2"]
    assert r2.report_text == r1.report_text
    assert [vars(x) for x in r2.found_systems] == [vars(x) for x in r1.found_systems]
    assert _strip_timings(out2) == _strip_timings(out1)
    monkeypatch.setenv("MCAAT_ORDERING_PROCS", "1")
    want = jpipeline.run_pipeline(
        JSettings(input_files=paths["pool"], output_file=str(d / "pool_jax.txt")), verbose=False
    )
    assert r1.report_text == want.report_text
    assert [vars(x) for x in r1.found_systems] == [vars(x) for x in want.found_systems]


def test_threads_drives_ordering_pool(monkeypatch):
    """--threads bounds the ordering pool in both packages alike: 1 is
    serial, ``MCAAT_ORDERING_PROCS`` overrides, 0 resets to the CPU
    count."""
    monkeypatch.delenv("MCAAT_ORDERING_PROCS", raising=False)
    seen = {}
    for name, pl in (("jax", jpipeline), ("port", tpipeline)):
        counts = []
        try:
            pl.configure_threads(1)
            counts.append(pl._ordering_worker_count())
            pl.configure_threads(3)
            counts.append(pl._ordering_worker_count())
            monkeypatch.setenv("MCAAT_ORDERING_PROCS", "5")
            counts.append(pl._ordering_worker_count())
            monkeypatch.delenv("MCAAT_ORDERING_PROCS")
            pl.configure_threads(0)
            counts.append(pl._ordering_worker_count())
        finally:
            pl.configure_threads(0)
        seen[name] = counts
    assert seen["port"] == [1, 3, 5, os.cpu_count() or 1]
    assert seen["port"] == seen["jax"]


def test_run_pipeline_applies_settings_threads(fastqs, jax_runs, monkeypatch):
    """``threads=1`` from a settings file reaches the ordering pool of
    ``run_pipeline``; the report equals the JAX package's."""
    monkeypatch.delenv("MCAAT_ORDERING_PROCS", raising=False)
    try:
        s, got = _port_run(fastqs, "threads_1")
        assert s.threads == 1
        assert tpipeline._ORDERING_THREADS == 1
        assert tpipeline._ordering_worker_count() == 1
    finally:
        tpipeline.configure_threads(0)
    want = jax_runs("threads_1")
    assert got.report_text == want.report_text
    assert tpipeline._ORDERING_THREADS is None
