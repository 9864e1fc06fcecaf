"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
folder with a small cell of its own, made from files alone.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = "tiny.tiny-mix"


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory):
    """``(root, bench_dir)``: a BENCHMARK.json naming one dummy cell on a
    small configuration (8 arrays in 300 kbp, mixed-pe150-small's sizes, with
    the committed configuration's read shape),
    a dummy traffic mix and a dummy per-layer metric, each added as a file
    beside copies of the benchmark's own."""
    root = tmp_path_factory.mktemp("bench")
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    config = json.loads((bench / "configs" / "pe150-56mbp.json").read_text())
    config.update(name="tiny", params=dict(config["params"], background_len=300_000))
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"name": "tiny-mix", "why": "a dummy mix",
         "params": {"n_arrays": 8, "spacer_counts": [4, 8, 16, 30, 45, 60], "shape_seed": 7}}))
    (bench / "metrics" / "dummy.samples.py").write_text(
        '"""Samples the window finished, read where its hook was open around the\n'
        'window (a dummy metric)."""\n\nimport contextlib\n\n\n'
        "@contextlib.contextmanager\ndef hook(run):\n"
        "    run.probes['dummy'] = True\n    yield\n\n\n"
        "def read(run):\n    return len(run.samples) if run.probes.get('dummy') else None\n")
    limits = json.loads((bench / "checks" / "pe150-56mbp.long-arrays.json").read_text())
    (bench / "checks" / f"{TINY}.json").write_text(json.dumps(limits))
    spec["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "tiny", "traffic": "tiny-mix", "chips": 1,
                              "why": "test"})
    for m in spec["per_layer"]:  # the tiny cell reports what the first cell reports
        if "pe150-56mbp.long-arrays" in m.get("workloads", []):
            m["workloads"].append(TINY)
    spec["per_layer"].append({"name": "dummy.samples", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "cli and pipeline",
                              "moves": "sample_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root), str(bench)


@pytest.fixture
def cpu_program(monkeypatch):
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MCAAT_ORDERING_PROCS", "2")
