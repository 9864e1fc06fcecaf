"""``bench_torch.py`` against ``bench.py``, on the CPU.

The port's benchmark must compute ``bench.py``'s metrics by the same
definitions: the same build counts for the same reads, the same report
and spacer recovery on a planted metagenome as the JAX pipeline, and a
sharded node table whose digest at kp 1 and kp 8 is the JAX package's.
Its own gate must refuse a report that differs between runs or from the
committed one, and it must import neither jax nor ``mcaat_tpu``.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
import torch_probes
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jbuild_dbg_from_reads
from mcaat_tpu.io.fastq import read_encoded_batch as jread_encoded_batch
from mcaat_tpu.io.fastq import reverse_complement as jreverse_complement
from mcaat_tpu.kmer.count import SENTINEL as JSENTINEL
from mcaat_tpu.pipeline import run_pipeline as jrun_pipeline
from mcaat_tpu.settings import Settings as JSettings
from tests.synthetic import make_metagenome, write_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _require_native_umap():
    from mcaat_tpu_torch.native import umap_order

    if umap_order(["A", "B"]) is None:
        pytest.skip(
            "the golden fixtures pin the native (libstdc++ unordered_map) "
            "repeat-candidate order; build native/ to run this"
        )


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """The tiny planted metagenome of ``--quick`` as FASTQ: ``(meta, path)``."""
    meta = make_metagenome(**bench_torch.PLANTED_TINY)
    path = str(tmp_path_factory.mktemp("planted") / "reads.fq")
    write_fastq(path, meta.pop("reads"))
    return meta, path


def _main(argv):
    """``bench_torch.main(argv)``: ``(exit code, its last stdout line as JSON)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def quick():
    _require_native_umap()
    return _main(["--device", "cpu", "--quick"])


@pytest.mark.parametrize("n_reads,length", [(2_000, 100), (500, 60)])
def test_build_step_counts_equal_bench_py(n_reads, length):
    jcodes, jlengths = bench.synth_reads(n_reads, length)
    want = tuple(int(x) for x in bench.build_step(jcodes, jlengths))
    codes, lengths = bench_torch.synth_reads(n_reads, length, CPU)
    assert torch.equal(codes, torch.as_tensor(np.array(jcodes)))
    assert bench_torch.build_step(codes, lengths) == want


def test_planted_report_and_recovery_equal_the_jax_pipeline(quick, planted, tmp_path):
    """Part 1's planted figures of the ``--quick`` run (``bench_planted`` on
    the same tiny metagenome) against the JAX pipeline on that input."""
    _rc, line = quick
    figures = line["extra"]
    meta, fq = planted
    jresult = jrun_pipeline(
        JSettings(input_files=fq, output_file=str(tmp_path / "jax.txt")), verbose=False
    )
    # the report byte for byte, through its digest
    assert figures["report_sha1"] == hashlib.sha1(jresult.report_text.encode()).hexdigest()
    # bench.py's rule (bench.py::bench_planted) on the JAX report
    hits = total = 0
    for arr in meta["arrays"]:
        for sp in arr["spacers"]:
            total += 1
            core = sp[6:-6]
            if core in jresult.report_text or jreverse_complement(core) in jresult.report_text:
                hits += 1
    assert figures["spacer_recovery"] == f"{hits}/{total}"
    # live nodes, where the JAX graph's size is its padded bucket
    b = jread_encoded_batch(fq)
    km = np.asarray(jbuild_dbg_from_reads(b.codes, b.lengths, k=23).kmers)
    assert figures["graph_nodes"] == int((km != int(JSENTINEL)).sum()) < km.size
    for name in ("planted_build_kmers_per_s", "cycle_search_nodes_per_s", "e2e_reads_per_s_warm"):
        assert figures[name] > 0


def test_quick_run_prints_every_metric(quick):
    rc, line = quick
    assert rc == 0, line["extra"].get("failed")
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= set(line)
    extra = line["extra"]
    for name in bench_torch.PART1_METRICS:
        assert name in extra
    assert extra["graph_build_kmers_per_s"] == line["value"] > 0
    assert set(extra["cells"]) == set(bench_torch.QUICK_CELLS)
    for name, cell in extra["cells"].items():
        for metric in bench_torch.CELL_METRICS:
            assert metric in cell, (name, metric)
        assert cell["gate"] == "passed"
        assert cell["wall_s"]["n"] == 2 and cell["cold_s"] > 0
        assert cell["wall_s"]["q1"] <= cell["wall_s"]["median"] <= cell["wall_s"]["q3"]
        assert {"graph_build", "cycle_search", "report"} <= set(cell["stages_s"])
        assert cell["device_peak_bytes"] is None  # no device figure from a CPU run
        assert cell["reserved_unused_at_peak_bytes"] is None
        assert cell["launches"] == {"lcs_ratio": 0, "partial_ratio": 0, "ratio_matrix": 0}
    assert extra["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert extra["cells"]["planted-tiny"]["spacer_recovery"] == extra["spacer_recovery"]
    assert extra["cells"]["planted-tiny"]["report_sha1"] == extra["report_sha1"]


def test_scaling_node_table_equals_jax_at_kp_1_and_8(quick, planted):
    _rc, line = quick
    sc = line["extra"]["scaling"]
    _meta, fq = planted
    b = jread_encoded_batch(fq)
    km = np.asarray(jbuild_dbg_from_reads(b.codes, b.lengths, k=23).kmers)
    live = km[km != int(JSENTINEL)]
    # bench.py's digest: sha1(sorted live kmers).hexdigest()[:16]
    want = hashlib.sha1(np.sort(live.ravel()).tobytes()).hexdigest()[:16]
    assert sc["kp1"]["node_table_sha1"] == sc["kp8"]["node_table_sha1"] == want
    assert sc["node_table_parity"] is True
    assert sc["kp1"]["nodes"] == sc["kp8"]["nodes"] == live.size
    assert sc["kp8"]["live_rows_max_per_shard"] < live.size
    assert sc["kp1"]["a2a_wire_mb_per_device"] == 0.0 < sc["kp8"]["a2a_wire_mb_per_device"]
    # the count budget's probe saw every shard's count input
    assert sc["kp1"]["count_rows_max"] > sc["kp8"]["count_rows_max"] > 0
    assert sc["count_budget"]["bytes_per_count_row_kp1"] is None  # a card's figure


@pytest.mark.parametrize("corrupt", ["run0", "run1"])
def test_a_corrupted_report_fails_the_gate(corrupt, monkeypatch):
    """A stand-in for a wrong report: run 0's (against the committed
    golden report) or run 1's (against run 0's) bytes changed on read."""
    _require_native_umap()
    monkeypatch.setattr(bench_torch, "bench_uniform_build", lambda device, n_reads: 1.0)
    monkeypatch.setattr(bench_torch, "bench_planted",
                        lambda meta, fq, device, work: ({"spacer_recovery": "0/0"}, ""))
    monkeypatch.setattr(bench_torch, "bench_scaling",
                        lambda fq, device, work: {"node_table_parity": True})
    read = bench_torch.read_report

    def corrupted(folder):
        data = read(folder)
        return data.replace(b"A", b"C", 1) if os.path.basename(folder) == corrupt else data

    monkeypatch.setattr(bench_torch, "read_report", corrupted)
    rc, line = _main(["--device", "cpu", "--quick", "--cell", "golden", "--runs", "1"])
    assert rc != 0
    cell = line["extra"]["cells"]["golden"]
    assert line["extra"]["failed"] == ["golden"]
    assert cell["gate"] != "passed" and any(corrupt[-1] in g for g in cell["gate"])
    # a failed run is never averaged in
    assert cell["wall_s"] is None if corrupt == "run1" else cell["cold_s"] is None


def test_gate_rules_exact_repeat_and_shared_23mer():
    repeat = "GTTTTAGAGCTATGCTGTTTTGAATGGTCCCAAAAC"
    arrays = [{"repeat": repeat, "spacers": ["ACGTACGTACGTACGTACGTACGTACGTAC"]}]
    dash = "-" * 50

    def report(r):
        return "\n".join(["x", dash, r, dash, arrays[0]["spacers"][0]]) + "\n"

    exact = report(repeat[:-1])
    shifted = report("T" + repeat[:-2])  # the ends a base off, as errors make them
    assert torch_probes.arrays_found(arrays, exact, errors=False) == 1
    assert torch_probes.arrays_found(arrays, shifted, errors=False) == 0
    assert torch_probes.arrays_found(arrays, shifted, errors=True) == 1
    assert torch_probes.reported_repeats(shifted) == ["T" + repeat[:-2]]
    inp = bench_torch.CellInput(["x"], 1, arrays, errors=False)
    assert bench_torch.truth_failures(inp, exact.encode()) == []
    assert bench_torch.truth_failures(inp, shifted.encode())


def test_gate_holds_every_run_to_the_cells_launches():
    """On the card a run must launch each report kernel once per system
    of more than 24 spacers; a run that launched other counts fails the
    gate and stays out of the medians, even when run 0 launched the same."""
    cells = bench_torch._cells()
    cuda = torch.device("cuda")
    want = {n: bench_torch.want_launches(c, cuda)["ratio_matrix"] for n, c in cells.items()}
    assert want == {"planted-20x30": 20, "planted-20x30-err-pe": 20, "planted-20x30-40M": 20,
                    "sample-1.03B": 0, "sample-1.03B-err-pe": 0, "array-250": 1,
                    "mixed-pe150": 14, "sample-pe150": 0, "planted-20x30-500M": 20,
                    "golden": 0, "planted-tiny": 0}
    for name, c in cells.items():
        got = bench_torch.want_launches(c, cuda)
        # one system of mixed-pe150 enters the substring filter with more than 24 spacers
        # and leaves it with fewer: it launches partial_ratio and not ratio_matrix
        extra = 1 if name == "mixed-pe150" else 0
        assert got["partial_ratio"] == got["ratio_matrix"] + extra and got["lcs_ratio"] == 0
        assert set(bench_torch.want_launches(c, CPU).values()) == {0}

    inp = bench_torch.CellInput(["x"], 10, None, expected=b"report")
    twenty = bench_torch.want_launches(cells["planted-20x30"], cuda)

    def run(i, **launches):
        return {"run": i, "wall_s": 1.0 + i, "stages_s": {"report": 0.1}, "launches":
                dict(twenty, **launches), "device_peak_bytes": None,
                "reserved_unused_at_peak_bytes": None, "nodes": 1, "unique_kp1_mers": 1,
                "adjacency_chunks": 1, "count_parts": 1, "systems": 20}

    good = bench_torch.summarise(inp, [run(0), run(1), run(2)], [b"report"] * 3, twenty)
    assert good["gate"] == "passed" and good["wall_s"]["n"] == 2
    # every run fell back to the plain versions: run 0 agrees with the rest, the gate does not
    plain = dict(ratio_matrix=0, partial_ratio=0)
    none = bench_torch.summarise(inp, [run(i, **plain) for i in range(3)], [b"report"] * 3,
                                 twenty)
    assert len(none["gate"]) == 3 and none["cold_s"] is None and none["wall_s"] is None
    one = bench_torch.summarise(inp, [run(0), run(1, partial_ratio=19), run(2)],
                                [b"report"] * 3, twenty)
    assert one["gate"] == [f"run 1: launched {dict(twenty, partial_ratio=19)}, not {twenty}"]
    assert one["wall_s"]["n"] == 1 and one["cold_s"] == 1.0


def test_fragment_cells_follow_the_others_on_one_card():
    """mixed-pe150 and sample-pe150 (``tests/torch_fragments.py``) come
    after the cells that were there, take one card, and hold every run to
    the launches of their systems of more than 24 spacers (14 of
    mixed-pe150's reported systems, and one more that the substring filter
    cuts below 25 after ``partial_ratio`` scored it; none of sample-pe150's
    3-12-spacer arrays) and their truth to what the JAX package reports on
    the same arrays."""
    from torch_fragments import INPUTS, truth_floor

    assert bench_torch.ONE_CARD_CELLS == (
        "planted-20x30", "planted-20x30-err-pe", "planted-20x30-40M", "sample-1.03B",
        "sample-1.03B-err-pe", "array-250", "mixed-pe150", "sample-pe150")
    cells = bench_torch._cells()
    cuda = torch.device("cuda")
    for name, filtered, over in (("mixed-pe150", 15, 14), ("sample-pe150", 0, 0)):
        assert cells[name].cards == 1 and cells[name].systems_over_24 == over
        assert bench_torch.want_launches(cells[name], cuda) == {
            "lcs_ratio": 0, "partial_ratio": filtered, "ratio_matrix": over}
    # the floor of these inputs: the JAX package's arrays and its share of spacers less 2 points
    rng = np.random.default_rng(0)
    repeats = ["".join("ACGT"[b] for b in rng.integers(0, 4, 30)) for _ in range(2)]
    spacers = ["".join("ACGT"[b] for b in rng.integers(0, 4, 34)) for _ in range(100)]
    arrays = [{"repeat": r, "spacers": spacers[50 * i : 50 * i + 50]}
              for i, r in enumerate(repeats)]
    dash = "-" * 50

    def report(n_arrays, n_spacers):
        lines = ["x"]
        for r in repeats[:n_arrays]:
            lines += [dash, r[:-1], dash]
        return "\n".join(lines + spacers[:n_spacers]).encode()

    for floor in ((2, 0.9), (1, 0.9)):
        inp = bench_torch.CellInput(["x"], 1, arrays, errors=True, floor=floor)
        assert bench_torch.truth_failures(inp, report(2, 90)) == []
        assert bench_torch.truth_failures(inp, report(2, 89))
        assert bool(bench_torch.truth_failures(inp, report(1, 90))) == (floor[0] == 2)
    plain = bench_torch.CellInput(["x"], 1, arrays, errors=True)
    assert bench_torch.truth_failures(plain, report(2, 95)) == []
    assert bench_torch.truth_failures(plain, report(2, 94))
    for name in ("mixed-pe150", "sample-pe150"):
        arrays_floor, share = truth_floor(name)
        assert 0 < arrays_floor <= INPUTS[name]["n_arrays"] and 0.85 < share < 0.98


def test_spread_is_median_and_quartiles():
    got = bench_torch.spread([4.0, 1.0, 3.0, 2.0, 5.0])
    assert got == {"median": 3.0, "q1": 2.0, "q3": 4.0, "n": 5, "iqr_over_median": 2.0 / 3.0}
    assert bench_torch.spread([]) is None


def test_child_env_leaks_no_mcaat_variable(monkeypatch):
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "8")
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cuda")
    env = bench_torch.child_env(CPU, MCAAT_TORCH_SHARDS=4)
    assert env["MCAAT_TORCH_SHARDS"] == "4" and env["MCAAT_TORCH_DEVICE"] == "cpu"
    env = bench_torch.child_env(CPU)
    assert "MCAAT_TORCH_SHARDS" not in env and env["MCAAT_TORCH_DEVICE"] == "cpu"
    assert "CUDA_VISIBLE_DEVICES" not in env or env["CUDA_VISIBLE_DEVICES"] == os.environ[
        "CUDA_VISIBLE_DEVICES"]
    # on the card a cell sees the first cards of its caller's, one unless it asks for more
    cuda = torch.device("cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3,5,7")
    assert bench_torch.child_env(cuda)["CUDA_VISIBLE_DEVICES"] == "2"
    assert bench_torch.child_env(cuda, 4)["CUDA_VISIBLE_DEVICES"] == "2,3,5,7"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert bench_torch.child_env(cuda, 4)["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    assert bench_torch.child_env(cuda)["MCAAT_TORCH_DEVICE"] == "cuda"


def test_cuda_is_the_default_device():
    assert bench_torch.parse_args([]).device == "cuda"
    # the four-card cell runs only when named; its cards come from the cell
    assert "planted-20x30-500M" not in bench_torch.ONE_CARD_CELLS
    assert bench_torch._cells()["planted-20x30-500M"].cards == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MCAAT_TORCH_DEVICE=cpu"):
            bench_torch.main(["--quick"])


def test_bench_torch_imports_neither_jax_nor_mcaat_tpu():
    code = (
        "import sys, bench_torch\n"
        "bench_torch._cells()\n"
        "import torch_probes, torch_big_array, torch_sharded_past_ceiling, torch_fragments\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'mcaat_tpu' or n.startswith('mcaat_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
