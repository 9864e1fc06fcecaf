"""The readers of the graph build's parts and chunks
(``graph_build.count_parts_s``, ``graph_build.merge_s``,
``graph_build.adjacency_s``, ``graph_build.adjacency_chunks``) on made-up
span records: a program with no such span, a single pass and a build in
several parts; and their entries in ``BENCHMARK.json``."""

import pytest

from benchmark import harness, spans
from benchmark.harness import Run
from test_bench_metrics import BENCH
from test_bench_spans import _rec

NEW = ["graph_build.count_parts_s", "graph_build.merge_s", "graph_build.adjacency_s",
       "graph_build.adjacency_chunks"]
OLD_CELLS = ["pe150-56mbp.long-arrays", "pe150-56mbp.short-arrays"]
CELLS = ["pe150-56mbp.short-arrays-40", "pe150-parted.short-arrays-40"]
PARTED = "pe150-parted.short-arrays-40"
UC = "graph_build/build/upload_count"
ADJ = "graph_build/build/adjacency"


def _build(parts, chunks, scale=1.0, merge=0.5):
    """One sample's graph-build records: ``parts`` count_part spans of 2 s,
    a push of ``merge`` s a part, a final merge of 1 s and ``chunks``
    adjacency passes of 0.75 s, every time times ``scale``."""
    t = 0.0
    recs = [_rec("graph_build", 0, 100 * scale), _rec("graph_build/build", 0, 90 * scale)]
    recs.append(_rec(UC, 0, 50 * scale, {"parts": parts},
                     {"part_merge": merge * parts * scale}))
    for _ in range(parts):
        recs.append(_rec(f"{UC}/count_part", t, t + 2 * scale))
        t += 2 * scale
    recs.append(_rec(f"{UC}/final_merge", t, t + 1 * scale))
    recs.append(_rec(ADJ, 60 * scale, 80 * scale))
    for i in range(chunks):
        recs.append(_rec(f"{ADJ}/adjacency_chunk", (60 + i) * scale, (60.75 + i) * scale))
    return recs


def _run(*samples):
    run = Run()
    run.samples = [{"wall_s": 100.0, "stages": []} for _ in samples]
    run.probes["spans"] = list(samples)
    return run


def read(name, run):
    return harness.load_metric(name, BENCH).read(run)


def test_several_parts_sum_over_parts_and_chunks():
    run = _run(_build(2, 5), _build(3, 4, scale=2.0))
    assert read("graph_build.count_parts_s", run) == pytest.approx((2 * 2 + 3 * 4) / 2)
    assert read("graph_build.merge_s", run) == pytest.approx(((1.0 + 1) + (3.0 + 2)) / 2)
    assert read("graph_build.adjacency_s", run) == pytest.approx((5 * 0.75 + 4 * 1.5) / 2)
    assert read("graph_build.adjacency_chunks", run) == pytest.approx(4.5)


def test_a_single_pass_reads_its_one_part():
    run = _run(_build(1, 3, merge=0.0))
    assert read("graph_build.count_parts_s", run) == pytest.approx(2.0)
    assert read("graph_build.merge_s", run) == pytest.approx(1.0)
    assert read("graph_build.adjacency_chunks", run) == pytest.approx(3)


def test_a_program_without_the_spans_reads_nothing():
    """The parent's records: the merge's timer and span, no part or
    chunk span."""
    old = [r for r in _build(2, 5)
           if not r["name"].endswith(("count_part", "adjacency_chunk"))]
    run = _run(old)
    assert read("graph_build.count_parts_s", run) is None
    assert read("graph_build.adjacency_s", run) is None
    assert read("graph_build.adjacency_chunks", run) is None
    assert read("graph_build.merge_s", run) == pytest.approx(2.0)
    bare = [r for r in old if not r["name"].endswith("final_merge")]
    for r in bare:
        r["timers"].clear()
    assert read("graph_build.merge_s", _run(bare)) is None
    for name in NEW:  # no records at all, or no sample
        assert read(name, Run()) is None
        assert read(name, _run()) is None


def test_the_readers_share_one_hook_and_their_entries():
    assert {harness.load_metric(n, BENCH).hook for n in NEW} == {spans.hook}
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        cells = [PARTED] if name == "graph_build.merge_s" else OLD_CELLS + CELLS
        assert (m["layer"], m["moves"], m["workloads"]) == ("graph_build", "sample_s", cells)
    for cell in CELLS:
        got = harness.load_cell(spec, cell)
        assert got.chips == 1
    assert set(NEW) <= {m["name"] for m in harness.load_cell(spec, PARTED).per_layer}


def test_the_new_cells_report_the_accepted_per_layer_metrics():
    """Every accepted per-layer metric of cells 1-2 is read in the new
    cells too, but the two kernels' rooflines (no batched call there)."""
    spec = harness.load_spec()
    accepted = {m["name"] for m in harness.load_cell(spec, OLD_CELLS[1]).per_layer}
    for cell in CELLS:
        got = {m["name"] for m in harness.load_cell(spec, cell).per_layer}
        assert accepted <= got
        assert not {"partial_ratio_roofline", "ratio_matrix_roofline"} & got
