"""Spans, timers and counters inside the port's stages
(``mcaat_tpu_torch.utils.profiling``) on the CPU: their nesting on the
golden paired-end fixture, on the one-device path at its own size, with
the big-graph branches forced (the path of a full-size sample) and on
the sharded path; counters against independent counts; the ranges on a
``torch.profiler`` trace; no active profiler; the stage records left as
they were."""

import json
import os

import pytest
import torch

import mcaat_tpu_torch.cycles.finder as tfinder
import mcaat_tpu_torch.pipeline as tpipeline
import mcaat_tpu_torch.report.analyzer as tanalyzer
from mcaat_tpu_torch import native as tnative
from mcaat_tpu_torch.io.fastq import read_encoded_batch
from mcaat_tpu_torch.settings import Settings
from mcaat_tpu_torch.utils import profiling as tprof

DATA = os.path.join(os.path.dirname(__file__), "data")
STAGES = ("graph_build", "cycle_search", "read_mapping", "spacer_ordering", "report")
PE = [os.path.join(DATA, "golden_pe_1.fq"), os.path.join(DATA, "golden_pe_2.fq")]
# the spans each path must give on the paired-end fixture
SPANS = {
    "one_device": [
        "graph_build/parse", "graph_build/concat", "graph_build/build",
        "graph_build/build/upload_count", "graph_build/build/upload_count/final_merge",
        "graph_build/build/last_window_count", "graph_build/build/derive_nodes",
        "graph_build/build/adjacency", "graph_build/endpoints",
        "cycle_search/prune", "cycle_search/prune/mult_filter", "cycle_search/prune/clip_tips",
        "cycle_search/start_nodes", "cycle_search/enumeration",
        "read_mapping/cycle_table", "read_mapping/keep", "read_mapping/mate2_revcomp",
        "read_mapping/keep_mate2", "read_mapping/map",
        "spacer_ordering/region_split", "spacer_ordering/region_split/growth",
        "spacer_ordering/region_split/adjacency_download",
        "spacer_ordering/region_split/scc_split", "spacer_ordering/subproblem_filter",
        "spacer_ordering/solve", "spacer_ordering/collect",
    ],
    "forced": [
        "graph_build/parse", "graph_build/build/upload_count", "graph_build/build/adjacency",
        "cycle_search/mult_filter", "cycle_search/candidate_scan", "cycle_search/touched_mask",
        "cycle_search/extraction", "cycle_search/neighborhood_clip", "cycle_search/self_reach",
        "cycle_search/enumeration",
        "read_mapping/mate2_revcomp", "read_mapping/region_table",
        "read_mapping/region_table/region_mask", "read_mapping/map",
        "spacer_ordering/seed_set", "spacer_ordering/region_mask",
        "spacer_ordering/region_extract", "spacer_ordering/chain_remap",
        "spacer_ordering/region_condense", "spacer_ordering/region_split",
        "spacer_ordering/subproblem_filter", "spacer_ordering/solve",
    ],
    "sharded": [
        "graph_build/parse", "graph_build/concat", "graph_build/build",
        "graph_build/build/count", "graph_build/build/node_table", "graph_build/build/adjacency",
        "map_sources/mate2_revcomp", "spacer_ordering/region_split", "spacer_ordering/solve",
    ],
}


def _run(path, tmp_path, monkeypatch, verbose=False):
    from mcaat_tpu_torch.native import umap_order

    if umap_order(["A", "B"]) is None:
        pytest.skip("the golden fixtures pin the native repeat-candidate order; build native/")
    if path == "forced":
        monkeypatch.setattr(tfinder, "NEIGHBORHOOD_MIN_NODES", 0)
        monkeypatch.setattr(tfinder, "LAZY_CLIP_MIN_NODES", 0)
        monkeypatch.setattr(tpipeline, "REGION_CONDENSE_MIN_NODES", 0)
    if path == "sharded":
        monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("MCAAT_TORCH_SHARDS", "4")
    s = Settings(input_files=" ".join(PE), output_file=str(tmp_path / "CRISPR_Arrays.txt"))
    result = tpipeline.run_pipeline(s, verbose=verbose, device="cpu")
    with open(os.path.join(DATA, "golden_pe_CRISPR_Arrays.txt")) as fh:
        assert result.report_text == fh.read()
    return result


def _self_s(records, stage):
    """The stage's seconds not covered by its direct children or timers."""
    st = next(r for r in records if r["name"] == stage)
    kids = sorted((r["start_ns"], r["end_ns"]) for r in records if r["parent"] == stage)
    covered, last = 0, st["start_ns"]
    for s, e in kids:
        s = max(s, last)
        if e > s:
            covered += e - s
            last = e
    timers = sum(t["seconds"] for t in st["timers"].values())
    return (st["end_ns"] - st["start_ns"] - covered) / 1e9 - timers


@pytest.mark.parametrize("path", sorted(SPANS))
def test_spans_nest_inside_their_stages(path, tmp_path, monkeypatch):
    result = _run(path, tmp_path, monkeypatch)
    records = result.profile.span_records()
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
    missing = [n for n in SPANS[path] if n not in by_name]
    assert not missing, sorted(by_name)
    stages = [r["name"] for r in records if r["parent"] is None]
    assert stages == [s.name for s in result.profile.stages if s.seconds > 0]
    assert {r["sample"] for r in records} == {result.profile.sample}
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is None:
            continue
        assert r["name"].startswith(r["parent"] + "/")
        parents = [p for p in by_name[r["parent"]]
                   if p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]]
        assert parents, r
    if path != "sharded":
        total = sum(s.seconds for s in result.profile.stages if s.name in STAGES)
        self_s = sum(_self_s(records, st) for st in STAGES)
        assert -1e-3 < self_s < 0.1 * total, (self_s, total)


def test_counters_equal_independent_counts(tmp_path, monkeypatch):
    calls = {"n": 0}

    def counted(scorer):
        def call(a, b):
            calls["n"] += 1
            return scorer(a, b)

        return call

    # the report's Python route, whose calls are counted here (the
    # compiled route's counts are held to it in test_torch_fuzz_host.py)
    monkeypatch.setattr(tnative, "_fuzz", None)
    monkeypatch.setattr(tnative, "_fuzz_tried", True)
    monkeypatch.setattr(tanalyzer, "ratio", counted(tanalyzer.ratio))
    monkeypatch.setattr(tanalyzer, "partial_ratio", counted(tanalyzer.partial_ratio))
    records = _run("forced", tmp_path, monkeypatch).profile.span_records()

    def total(name, stage=None):
        return sum(r["counters"].get(name, 0) for r in records
                   if stage is None or r["name"].split("/")[0] == stage)

    assert calls["n"] > 0
    assert total("host_route_pairs", "report") == calls["n"]
    assert total("host_route_compiled_pairs", "report") == 0
    report = next(r for r in records if r["name"] == "report")
    assert report["timers"]["host_route"]["calls"] > 0
    assert total("revcomp_mates") == read_encoded_batch(PE[1]).num_reads
    assert total("reads", "graph_build") == sum(read_encoded_batch(p).num_reads for p in PE)
    assert total("bfs_levels", "cycle_search") > 0 and total("bfs_levels", "read_mapping") > 0
    assert total("subproblems") >= 1 and total("workers") == 0  # below the pool's minimum
    assert total("systems", "report") == 1


def test_spans_are_ranges_on_the_trace_clock(tmp_path, monkeypatch):
    """Every span is a ``mcaat/<path>`` range opened with the sample id as
    its args, within 1 ms of its record at both ends. (The trace of this
    torch keeps a range's name and times but not a string argument: the
    args are read where the range is opened.)"""
    opened = []

    class Spy(torch.profiler.record_function):
        def __init__(self, name, args=None):
            opened.append((name, args))
            super().__init__(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = _run("one_device", tmp_path, monkeypatch)
    records = result.profile.span_records()
    assert opened == [(f"mcaat/{r['name']}", result.profile.sample) for r in records]
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("mcaat/"):
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    seen = {}
    for r in records:
        k = seen[r["name"]] = seen.get(r["name"], -1) + 1
        start, end = sorted(ranges[f"mcaat/{r['name']}"])[k]
        assert abs(start - r["start_ns"]) < 1_000_000, r
        assert abs(end - r["end_ns"]) < 1_000_000, r


def test_without_an_active_profiler_nothing_is_recorded():
    with tprof.span("x", device="cpu"):
        with tprof.timer("t"):
            tprof.count(n=1)
    prof = tprof.Profiler()
    with tprof.span("outside"):
        pass
    with prof.stage("s"):
        pass
    with tprof.span("after"):
        tprof.count(n=1)
    assert [r["name"] for r in prof.span_records()] == ["s"]
    assert prof.span_records()[0]["counters"] == {}
    with pytest.raises(KeyError):  # a span lets an error through
        with prof.stage("t"):
            with tprof.span("x"):
                raise KeyError("x")
    assert [r["name"] for r in prof.span_records()] == ["s", "t", "t/x"]
    assert [s.name for s in prof.stages] == ["s", "t"]


def test_spans_leave_the_stage_records_as_they_were():
    def run(with_spans):
        prof = tprof.Profiler()
        with prof.stage("graph_build", nodes=7):
            if with_spans:
                with tprof.span("parse"):
                    tprof.count(reads=3)
                    with tprof.timer("t"):
                        pass
        with prof.stage("report") as st:
            st.counters["systems"] = 2
            if with_spans:
                tprof.count(host_route_pairs=5)
        prof.count("late", x=1)
        return prof

    plain, spanned = run(False), run(True)
    assert plain.spans and spanned.spans
    for a, b in zip(json.loads(plain.to_json()), json.loads(spanned.to_json())):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in ("seconds", "rss_mb")} == \
            {k: v for k, v in b.items() if k not in ("seconds", "rss_mb")}
    lines = spanned.report().splitlines()
    assert [ln.split()[0] for ln in lines if not ln.startswith("    ")] == \
        [ln.split()[0] for ln in plain.report().splitlines() if not ln.startswith("    ")]
    assert any(ln.split()[0] == "parse" for ln in lines)


def test_a_verbose_span_prints_its_line(capsys):
    for verbose in (False, True):
        prof = tprof.Profiler("cpu", verbose=verbose)
        with prof.stage("read_mapping"):
            with tprof.span("mate2_revcomp"):
                tprof.count(revcomp_mates=4)
        out = capsys.readouterr().out
        assert ("[read_mapping/mate2_revcomp]" in out and "revcomp_mates=4" in out) == verbose


@pytest.mark.cuda
def test_spans_allocate_nothing_and_keep_the_peak():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the allocator's figures exist only there")
    prof = tprof.Profiler("cuda", verbose=True)
    with prof.stage("graph_build"):
        x = torch.zeros(1 << 24, device="cuda")
        del x
        peak, used = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        for _ in range(100):
            with tprof.span("build", device="cuda"):
                with tprof.timer("t"):
                    tprof.count(n=1)
        assert torch.cuda.max_memory_allocated() == peak
        assert torch.cuda.memory_allocated() == used
    assert prof.stages[0].device_peak_mb >= (4 << 24) / 2**20
