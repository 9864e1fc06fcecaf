"""The names of the port that the benchmark's harness (``benchmark/``)
replaces at run time, each held to its contract on the CPU.

The harness reads the program through hooks that swap a module attribute
for the length of a ``with`` block (``benchmark/probes.py``,
``benchmark/spans.py``, ``benchmark/control.py``) and builds the host
libraries through ``native._load()`` (``benchmark/harness.py``). A
refactor that binds one of these names at import time, or calls around
it, would leave a hook blind with no other test failing: a blind score
hook reads as no batched call, which is a passing value. So each case
checks that a ``cli.run_cli`` sample run inside the harness's own hook
went through the patched name.

Three samples serve the cases: one with every observing hook open at
once, one with half the reads left out, one with both kernel entry points
giving 0. The input takes both report routes: one planted array of 26
spacers (past ``CRISPRAnalyzer.BATCH_THRESHOLD``: the batched route, one
call of each kernel entry point) and one of 8 (the host route).
"""

import contextlib
import io
import itertools
import os
import shutil
import types

import numpy as np
import pytest
import torch

from benchmark import control, probes, spans
from mcaat_tpu_torch import native
from mcaat_tpu_torch.cli import run_cli
from tests.synthetic import make_metagenome, write_fastq

BIG, SMALL = 26, 8  # spacers of the two planted arrays


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """``sample(*hooks)``: one run of ``cli.run_cli`` on the CPU inside
    the context managers ``hooks``, its console kept out of the test's
    output; the ``PipelineResult``."""
    folder = tmp_path_factory.mktemp("contract")
    reads = str(folder / "reads.fq")
    write_fastq(reads, [r for seed, n in ((31, BIG), (32, SMALL)) for r in make_metagenome(
        seed=seed, n_arrays=1, n_spacers=n, background_len=0, coverage=20.0)["reads"]])
    outs = itertools.count()

    def run(*hooks):
        with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
            mp.setenv("MCAAT_TORCH_DEVICE", "cpu")
            for hook in hooks:
                stack.enter_context(hook)
            with contextlib.redirect_stdout(io.StringIO()):
                out = str(folder / f"out{next(outs)}")
                result = run_cli(["--input-files", reads, "--output-folder", out])
        assert result is not None
        return result

    return run


@pytest.fixture(scope="module")
def observed(sample):
    """The sample with every observing hook open: the graph digests (a),
    the span records (c), the ``record_function`` ranges opened (d) and
    the batched calls (e, f)."""
    digests, calls, ranges = [], [], []
    run = types.SimpleNamespace(probes={})
    opened = torch.profiler.record_function

    def record_function(name, *args):
        ranges.append(name)
        return opened(name, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record_function)
        result = sample(probes.graph_digests(digests), spans.hook(run), probes.stage_spans(),
                        probes.batched_scores(calls))
    systems = sorted(len(s.spacers) for s in result.found_systems)
    assert systems == [SMALL, BIG], systems
    return {"nodes": _nodes(result), "digests": digests, "records": run.probes["spans"],
            "ranges": ranges, "calls": calls}


def _nodes(result) -> int:
    return next(s.counters["nodes"] for s in result.profile.stages if s.name == "graph_build")


def _batched(calls, kernel) -> list:
    return [c[1:] for c in calls if c[0] == kernel]


def _build_graph_from_settings(t):
    assert [d["nodes"] for d in t.observed["digests"]] == [t.observed["nodes"]]


def _load_input_batches(t):
    assert 0 < _nodes(t.sample(control.half_the_reads())) < t.observed["nodes"]


def _run_pipeline(t):
    (records,) = t.observed["records"]
    names = {r["name"] for r in records}
    assert set(spans.STAGES) | {"graph_build/parse"} <= names, names


def _profiler_stage(t):
    stages = [r for r in t.observed["ranges"] if r.startswith("stage.")]
    assert stages == [f"stage.{s}" for s in spans.STAGES], stages


def _partial_ratio_pairs(t):
    ((shorts, longs, scores),) = _batched(t.observed["calls"], "partial_ratio")
    assert len(shorts) == len(longs) == len(scores) == BIG * (BIG - 1) // 2


def _pairwise_ratio_matrix(t):
    ((strings, scores),) = _batched(t.observed["calls"], "ratio_matrix")
    assert len(strings) == BIG and scores.shape == (BIG, BIG)


@pytest.fixture(scope="module")
def zeroed(sample):
    """The batched calls of the sample with ``control.zero_kernels``."""
    calls: list = []
    sample(probes.batched_scores(calls), control.zero_kernels())
    return calls


def _zeroed(kernel):
    """The scores ``kernel``'s route hands the analyzer under the control
    that replaces both kernel entry points by zeros are all 0, where the
    observed sample's are not."""

    def case(t):
        ((*_, got),) = _batched(t.fixture("zeroed"), kernel)
        ((*_, want),) = _batched(t.observed["calls"], kernel)
        assert got.shape == want.shape and not np.any(got) and np.any(want)

    return case


def _native_load(t):
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    for name in ("_lib", "_fastx", "_fuzz", "_split"):
        t.monkeypatch.setattr(native, name, None)
    for name in ("_tried", "_fastx_tried", "_fuzz_tried", "_split_tried"):
        t.monkeypatch.setattr(native, name, False)
    native._load()

    def again(src_path):
        raise AssertionError(f"{src_path} built after native._load()")

    t.monkeypatch.setattr(native, "_open", again)
    assert all(lib() is not None for lib in (native._load_fastx, native._load_fuzz,
                                             native._load_split))
    # and the sample took the three compiled routes
    (records,) = t.observed["records"]
    counted = {k: sum(r["counters"].get(k, 0) for r in records)
               for k in ("parse_fast_files", "host_route_compiled_pairs", "split_compiled_nodes")}
    assert (counted["parse_fast_files"] == 1 and counted["host_route_compiled_pairs"] > 0
            and counted["split_compiled_nodes"] > 0), counted


CASES = {
    "a-pipeline.build_graph_from_settings": _build_graph_from_settings,
    "b-pipeline._load_input_batches": _load_input_batches,
    "c-pipeline.run_pipeline": _run_pipeline,
    "d-Profiler.stage": _profiler_stage,
    "e-batched_fuzz.partial_ratio_pairs": _partial_ratio_pairs,
    "f-batched_fuzz.pairwise_ratio_matrix": _pairwise_ratio_matrix,
    "g-batched_fuzz.partial_ratio_table": _zeroed("partial_ratio"),
    "h-batched_fuzz.ratio_matrix": _zeroed("ratio_matrix"),
    "i-native._load": _native_load,
}


@pytest.mark.parametrize("hook", sorted(CASES))
def test_benchmark_hook_sees_the_run(hook, sample, observed, monkeypatch, request):
    CASES[hook](types.SimpleNamespace(sample=sample, observed=observed, monkeypatch=monkeypatch,
                                      fixture=request.getfixturevalue))
