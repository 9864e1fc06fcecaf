"""A run of the harness on the CPU at a small size (its look for a card
skipped), the result line's keys, a cell, mix and metric added from files
alone, a card-less host, and what the runs import."""

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import ROOT, TINY

from benchmark import harness

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(bench_copy, traced, seed=2**31 + 11):
    root, bench = bench_copy
    spec = harness.load_spec(root)
    cell = harness.load_cell(spec, TINY, root=root, bench_dir=bench)
    return harness.execute(cell, seed, 1.0, traced, time.perf_counter(), device="cpu",
                           bench_dir=bench)


def test_a_cell_mix_and_metric_from_files_alone(bench_copy):
    root, bench = bench_copy
    spec = harness.load_spec(root)
    cell = harness.load_cell(spec, TINY, root=root, bench_dir=bench)
    assert cell.params()["n_arrays"] == 8 and cell.params()["shape_seed"] == 7
    assert "dummy.samples" in [m["name"] for m in cell.per_layer]
    assert harness.load_metric("dummy.samples", bench).read(harness.Run()) is None  # no hook
    # the committed cells keep their own metric lists
    real = harness.load_cell(spec, "pe150-56mbp.short-arrays", root=root, bench_dir=bench)
    assert "partial_ratio_roofline" not in [m["name"] for m in real.per_layer]
    assert "dummy.samples" not in [m["name"] for m in real.per_layer]
    with pytest.raises(harness.CellError):
        harness.load_cell(spec, "no-such.cell", root=root, bench_dir=bench)


def test_untraced_line(bench_copy, cpu_program):
    line = _run(bench_copy, traced=False)
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"sample_s", "setup_s"}  # no card, no peak
    assert line["attempted"] >= 1 and line["failed"] == 0
    with open(os.path.join(bench_copy[1], "checks", f"{TINY}.json")) as fh:
        assert set(line["checks"]) == set(json.load(fh)["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line(bench_copy, cpu_program):
    line = _run(bench_copy, traced=True, seed=12)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"graph_build.s", "spacer_ordering.s", "report.s", "pipeline.unstaged_s",
            "cold_sample_s", "device.idle_share", "dummy.samples"} <= set(line["metrics"])
    assert line["metrics"]["dummy.samples"]["value"] == line["attempted"]
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0  # no device here
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_host_without_a_card_gets_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    env.update(CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "pe150-56mbp.long-arrays", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness, compare, devtrace, kernels, probes, stages
from benchmark import reference
ref_mods = sorted(m for m in sys.modules if m.split('.')[0] == 'mcaat_tpu_torch')
for m in harness.load_spec()['per_layer'] + harness.load_spec()['end_to_end']:
    harness.load_metric(m['name'])
import mcaat_tpu_torch.cli, mcaat_tpu_torch.pipeline
print(json.dumps({{"top": sorted({{m.split('.')[0] for m in sys.modules}}), "ref": ref_mods}}))
"""


def test_nothing_imported_is_jax_or_the_jax_package():
    """What the runs import (the harness, the reference, every metric's
    reader, the program's CLI), by whole top-level names; the reference
    and the rest of the yardstick load nothing of the program."""
    proc = subprocess.run([sys.executable, "-c", IMPORTS.format(root=ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(got["top"]) & set(harness.BANNED)
    assert got["ref"] == []
    assert "mcaat_tpu_torch" in got["top"]
