"""The reader of ``spacer_ordering.split_compiled_nodes`` on made-up span
records: the counter's mean over samples where the program has it, 0 on
the Python split, None on a program without the counter."""

import pytest

from benchmark import harness, spans
from test_bench_metrics import BENCH
from test_bench_spans import _rec, _run

NAME = "spacer_ordering.split_compiled_nodes"


def read(run):
    return harness.load_metric(NAME, BENCH).read(run)


def test_split_compiled_nodes_reads_the_counter_or_nothing():
    run = _run(1, 2)
    assert read(run) is None  # a program without the counter
    for recs, nodes in zip(run.probes["spans"], (300, 500)):
        recs.append(_rec("spacer_ordering/region_split/scc_split", 15, 15.5,
                         {"split_compiled_nodes": nodes}))
    assert read(run) == pytest.approx((300 + 500) / 2)
    for recs in run.probes["spans"]:  # the Python split counts 0
        recs[-1]["counters"]["split_compiled_nodes"] = 0
    assert read(run) == 0.0
    assert harness.load_metric(NAME, BENCH).hook is spans.hook
