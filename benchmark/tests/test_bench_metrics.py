"""The metric arithmetic on made-up records: stage totals over samples,
the unstaged seconds, the union idle share against a double-counting
sum, the kernels' counts and the roofline share."""

import math
import os

import numpy as np
import pytest

from benchmark import devtrace, harness, kernels
from benchmark.harness import Run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage(name, seconds, peak=None, reserved=None):
    return {"name": name, "seconds": seconds, "device_peak_mb": peak,
            "device_reserved_mb": reserved}


def _run():
    run = Run()
    run.samples = [
        {"wall_s": 5.0, "stages": [_stage("graph_build", 1.0, 6000, 9000),
                                   _stage("report", 0.5, 100, 9000)]},
        {"wall_s": 4.0, "stages": [_stage("graph_build", 2.0, 6500, 9600),
                                   _stage("report", 0.3, 120, 9600)]},
    ]
    run.window_s = 9.5
    return run


def read(name, run):
    return harness.load_metric(name, BENCH).read(run)


def test_stage_seconds_are_totals_over_samples():
    run = _run()
    assert read("graph_build.s", run) == pytest.approx(1.5)
    assert read("report.s", run) == pytest.approx(0.4)
    assert read("cycle_search.s", run) is None
    assert read("pipeline.unstaged_s", run) == pytest.approx(((5 - 1.5) + (4 - 2.3)) / 2)
    assert read("sample_s", run) == pytest.approx(9.5 / 2)


def test_peak_stage_memory():
    run = _run()
    assert read("graph_build.alloc_peak_gib", run) == pytest.approx(6500 / 1024)
    assert read("allocator.unused_gib", run) == pytest.approx((9600 - 6500) / 1024)
    run.reserved_peak_bytes = 3 * 2**30
    assert read("device_peak_gib", run) == pytest.approx(3.0)


def test_idle_share_is_a_union_not_a_sum():
    s = 1_000_000_000
    dev = [("k1", 0, s), ("k2", s // 2, 2 * s), ("memcpy", 3 * s, 4 * s), ("late", 9 * s, 11 * s)]
    host = [("bench.window", 0, 10 * s), ("stage.graph_build", 0, 3 * s),
            ("stage.report", 3 * s, 10 * s)]
    tr = devtrace.reduce(dev, host)
    assert tr["busy_s"] == pytest.approx(2.0 + 1.0 + 1.0)  # a sum would give 1 + 1.5 + 1 + 1
    run = Run()
    run.trace = tr
    assert read("device.idle_share", run) == pytest.approx(60.0)
    assert tr["idle_gaps"][0] == ["report", pytest.approx(5.0)]
    assert tr["idle_by_stage"] == {"graph_build": pytest.approx(1.0),
                                   "report": pytest.approx(5.0)}
    # a gap across two stages and past their end is split between them
    host = [("bench.window", 0, 10 * s), ("stage.graph_build", 0, 3 * s),
            ("stage.report", 3 * s, 5 * s)]
    tr = devtrace.reduce([("k", 0, 2 * s)], host)
    assert tr["idle_gaps"] == [["outside stages", pytest.approx(8.0)]]
    assert tr["idle_by_stage"] == {"graph_build": pytest.approx(1.0), "report": pytest.approx(2.0),
                                   "outside stages": pytest.approx(5.0)}


def test_host_ranges_on_the_device_are_no_device_work():
    """The device's copies of host ranges (the program's own
    ``record_function`` ranges among them) do not count as busy time."""
    s = 1_000_000_000
    dev = [("void sort_kernel<long>(long*)", 0, s, None),
           ("graph_build.parse", 0, 8 * s, None),  # a program range, copied to the device
           ("stage.report", 8 * s, 10 * s, None),
           ("Memcpy DtoH (Device -> Pageable)", 2 * s, 3 * s, "gpu_memcpy"),
           ("spans everything", 0, 10 * s, "gpu_user_annotation")]
    host_names = {"graph_build.parse", "stage.report", "bench.window", "aten::sort",
                  "cudaLaunchKernel"}
    work = devtrace.device_work(dev, host_names)
    assert [n for n, _s, _e in work] == ["void sort_kernel<long>(long*)",
                                         "Memcpy DtoH (Device -> Pageable)"]
    tr = devtrace.reduce(work, [("bench.window", 0, 10 * s)])
    assert tr["busy_s"] == pytest.approx(2.0)


def test_partial_ratio_counts():
    # strings of 3 and 5 bases: 3 - 1 + 5 = 7 windows, of 1, 2, 3, 3, 3, 2, 1 bases;
    # the pair counts once whichever side is the shorter, each string once in the table
    for pair in (("ACG", "ACGTA"), ("ACGTA", "ACG")):
        n_bytes, ops = kernels.partial_ratio_counts([pair[0]], [pair[1]])
        assert n_bytes == 68 * 2 + 12
        assert ops == 20 * 15 + 8 * 3
    n_bytes, _ops = kernels.partial_ratio_counts(["ACG", "ACG"], ["ACGTA", "TT"])
    assert n_bytes == 68 * 3 + 12 * 2


def test_ratio_matrix_counts():
    n_bytes, ops = kernels.ratio_matrix_counts(["A" * 10, "C" * 20, "G" * 30])
    assert n_bytes == 68 * 3 + 4 * 9
    assert ops == 20 * 4 * 60 / 2 + 8 * 60


def test_roofline_share_and_peak():
    assert kernels.PEAK_INT_OPS_S == pytest.approx(132 * 64 * 1.98e9)
    calls = [("partial_ratio", ["ACG"], ["ACGTA"], np.array([100.0])),
             ("ratio_matrix", ["ACG", "ACGTA"], np.zeros((2, 2)))]
    least = kernels.least_seconds(*kernels.partial_ratio_counts(["ACG"], ["ACGTA"]))
    assert kernels.roofline_pct("partial_ratio", calls, 4 * least) == pytest.approx(25.0)
    assert kernels.roofline_pct("partial_ratio", [], 1.0) is None
    run = Run()
    run.trace = {"device_s": {"void partial_ratio_kernel(unsigned char const*)": 4 * least,
                              "at::native::sort": 1.0}}
    run.probes = {"batched": calls}
    assert read("partial_ratio_roofline", run) == pytest.approx(25.0)
    assert read("ratio_matrix_roofline", run) is None  # launched, but not timed
    assert not math.isnan(kernels.least_seconds(0, 0))
