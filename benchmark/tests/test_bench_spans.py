"""The readers of the program's spans, timers and counters
(``benchmark/spans.py`` and its seven metrics) on made-up records, the
hook against a program with spans and one without, and the traced line
of a small cell on the CPU."""

import time
from types import SimpleNamespace

import pytest
from conftest import TINY

from benchmark import harness, spans
from benchmark.harness import Run
from test_bench_metrics import BENCH

NEW = ["graph_build.parse_s", "read_mapping.mate2_revcomp_s", "spacer_ordering.solve_s",
       "report.host_route_s", "report.host_route_pairs", "cycle_search.bfs_levels",
       "pipeline.stage_self_s"]
S = 1_000_000_000


def _rec(name, start, end, counters=None, timers=None):
    parent = name.rsplit("/", 1)[0] if "/" in name else None
    return {"name": name, "parent": parent, "sample": "1-1", "start_ns": int(start * S),
            "end_ns": int(end * S), "counters": counters or {},
            "timers": {k: {"seconds": v, "calls": 3} for k, v in (timers or {}).items()}}


def _sample(scale):
    """One sample's records: five stages, each with children that leave
    some of it uncovered."""
    return [
        _rec("graph_build", 0, 10 * scale),
        _rec("graph_build/parse", 0, 4 * scale, {"reads": 100}),
        _rec("graph_build/build", 4 * scale, 9 * scale),
        _rec("graph_build/build/adjacency", 8 * scale, 9 * scale),
        _rec("cycle_search", 10 * scale, 12 * scale, {}),
        _rec("cycle_search/self_reach", 10 * scale, 11 * scale, {"bfs_levels": 7}),
        _rec("read_mapping", 12 * scale, 15 * scale),
        _rec("read_mapping/mate2_revcomp", 12 * scale, 14 * scale, {"revcomp_mates": 50}),
        _rec("read_mapping/region_table", 14 * scale, 15 * scale),
        _rec("read_mapping/region_table/region_mask", 14 * scale, 15 * scale,
             {"bfs_levels": 3}),
        _rec("spacer_ordering", 15 * scale, 18 * scale),
        _rec("spacer_ordering/solve", 16 * scale, 18 * scale, {"workers": 8}),
        _rec("report", 18 * scale, 20 * scale, {"host_route_pairs": 40},
             {"host_route": 1.5 * scale, "batched_route": 0.25 * scale}),
    ]


def _run(*scales):
    run = Run()
    run.samples = [{"wall_s": 20.0 * s, "stages": []} for s in scales]
    run.probes["spans"] = [_sample(s) for s in scales]
    return run


def read(name, run):
    return harness.load_metric(name, BENCH).read(run)


def test_each_reader_is_a_total_over_samples():
    run = _run(1, 2)  # the second sample takes twice as long
    assert read("graph_build.parse_s", run) == pytest.approx((4 + 8) / 2)
    assert read("read_mapping.mate2_revcomp_s", run) == pytest.approx((2 + 4) / 2)
    assert read("spacer_ordering.solve_s", run) == pytest.approx((2 + 4) / 2)
    assert read("report.host_route_s", run) == pytest.approx((1.5 + 3.0) / 2)
    assert read("report.host_route_pairs", run) == pytest.approx(40)
    # the region growth's levels count beside cycle_search's own
    assert read("cycle_search.bfs_levels", run) == pytest.approx(10)
    # self time: graph_build 1 (9..10), cycle_search 1, read_mapping 0,
    # spacer_ordering 1 (15..16), report 2 less its timers 1.75
    assert read("pipeline.stage_self_s", run) == pytest.approx((3.25 + 6.5) / 2)


def test_a_program_without_spans_reads_nothing():
    run = Run()
    run.samples = [{"wall_s": 1.0, "stages": []}]
    for name in NEW:
        assert read(name, run) is None
    run.probes["spans"] = []
    for name in NEW:
        assert read(name, run) is None


def test_a_stage_that_ran_without_the_work_reads_zero():
    run = _run(1)
    run.probes["spans"][0] = [r for r in run.probes["spans"][0]
                              if "mate2" not in r["name"] and r["name"] != "report"]
    assert read("read_mapping.mate2_revcomp_s", run) == 0.0
    assert read("report.host_route_s", run) == 0.0
    assert read("report.host_route_pairs", run) == 0.0


def test_self_time_takes_the_union_of_children_and_clips_them():
    recs = [_rec("report", 0, 10, timers={"host_route": 2.0}),
            _rec("report/a", 1, 4), _rec("report/b", 3, 5), _rec("report/a/c", 0, 9),
            _rec("report/late", 9, 12), _rec("other", 0, 100)]
    # children cover 1..5 and 9..10 of 0..10: 5 s, less the 2 s timer
    assert spans.self_s(recs) == pytest.approx(3.0)


def test_every_reader_shares_one_hook():
    hooks = {harness.load_metric(n, BENCH).hook for n in NEW}
    assert hooks == {spans.hook}


def test_the_hook_keeps_each_samples_records(monkeypatch):
    from mcaat_tpu_torch import pipeline

    got = iter([SimpleNamespace(profile=SimpleNamespace(span_records=lambda: ["a"])),
                SimpleNamespace(profile=SimpleNamespace()),  # a program without spans
                SimpleNamespace(profile=None)])
    monkeypatch.setattr(pipeline, "run_pipeline", lambda *a, **k: next(got))
    fake = pipeline.run_pipeline
    run = Run()
    with spans.hook(run):
        for _ in range(3):
            pipeline.run_pipeline(None)
    assert run.probes["spans"] == [["a"]]
    assert pipeline.run_pipeline is fake  # put back


def test_the_traced_line_reports_the_new_metrics(bench_copy, cpu_program):
    root, bench = bench_copy
    spec = harness.load_spec(root)
    cell = harness.load_cell(spec, TINY, root=root, bench_dir=bench)
    for name in NEW:  # the tiny cell reports what the committed cells report
        assert name in [m["name"] for m in cell.per_layer]
    line = harness.execute(cell, 2**33 + 5, 1.0, True, time.perf_counter(), device="cpu",
                           bench_dir=bench)
    assert line["correct"] is True, line["checks"]
    got = {n: line["metrics"][n]["value"] for n in NEW}
    assert got["report.host_route_pairs"] > 0 and got["cycle_search.bfs_levels"] > 0
    assert got["graph_build.parse_s"] > 0 and got["read_mapping.mate2_revcomp_s"] > 0
    stages = sum(line["metrics"][f"{s}.s"]["value"] for s in spans.STAGES)
    print({**got, "stages_s": stages})
    assert 0 <= got["pipeline.stage_self_s"] < 0.1 * stages
