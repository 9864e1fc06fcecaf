#!/usr/bin/env python3
"""Benchmark of the PyTorch port (``mcaat_tpu_torch``): ``bench.py``'s
metric set, then named inputs end to end with medians of warm runs.

Usage (from the repository root):

    python3 bench_torch.py [--cell NAME ...] [--runs N] [--device cuda|cpu]
                           [--quick] [--json PATH]

Prints progress to standard error and ONE JSON line last on standard
output, in ``bench.py``'s shape: ``{"metric", "value", "unit",
"vs_baseline", "extra"}``. The run is on ``cuda`` unless ``--device cpu``
is given; without a card it raises. It imports torch, numpy and
``mcaat_tpu_torch`` (and the input generators of ``tests/``), never jax.

Part 1, ``bench.py``'s metrics under their names (``extra``):

* graph_build_kmers_per_s   -- uniform random reads through
                               :func:`build_step` (one strand; also the
                               top-level ``value``)
* planted_build_kmers_per_s -- ``build_dbg_from_reads`` on a planted
                               metagenome, both strands
* cycle_search_nodes_per_s  -- ``find_cycles`` over that graph, live
                               nodes a second (the JAX figure divides by
                               the padded bucket size)
* e2e_reads_per_s_warm      -- the second of two ``run_pipeline`` calls
* spacer_recovery           -- planted spacer cores (``sp[6:-6]``) found in
                               that run's report
* scaling                   -- the sharded build at kp 1 and kp 8
                               (``MCAAT_TORCH_SHARDS``, a process each):
                               live rows per shard, store bytes, bytes
                               exchanged (``utils/wire``), the node table's
                               SHA-1 and the bytes a count row

Part 2, ``extra["cells"]``: each named input (``CELLS``) through the
CLI's ``run_cli`` in a process of its own: one cold run, then ``--runs``
warm runs in the same process. Per cell: ``cold_s``; median and
quartiles of wall seconds and reads/s over the warm runs that passed the
gate; median seconds of each profiled stage; device peak and the bytes
reserved but unused in the peak stage; nodes, unique (k+1)-mers,
adjacency chunks; launches of the report kernels; the report's SHA-1 and
the gate. The gate: every run's report has the same bytes (and the
committed report where one exists), every run launched the report
kernels as often as the cell's systems of more than 24 spacers ask (on
the card; the CPU runs their plain versions), every planted array has a
system (on error-free reads its repeat less the last base is reported;
on error-bearing ones a reported repeat shares a 23-mer with it) and at
least 98% (error-free) or 95% (error-bearing) of the planted spacer
cores are found (on the inputs of ``tests/torch_fragments.py``, the
shares of arrays and spacers that the JAX package reports on the same
arrays, less 2 points: ``truth_floor``). A run that fails it is left out of
the medians, and the command exits non-zero.

The one-card cells (the default) are ``planted-20x30``,
``planted-20x30-err-pe``, ``planted-20x30-40M``, ``sample-1.03B``,
``sample-1.03B-err-pe``, ``array-250``, ``mixed-pe150`` and
``sample-pe150`` (2x150-bp fragment pairs with trimmed mates, N bases
and errors rising along a mate); ``planted-20x30-500M`` runs
only when named, on four cards, one shard a card. ``--quick`` shrinks Part 1 and
runs the small ``golden`` and ``planted-tiny`` cells (two warm runs) for a
check on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
for _p in (ROOT, TESTS, os.path.join(ROOT, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from torch_probes import (  # noqa: E402
    arrays_found,
    probe_pipeline,
    probe_sharded_count,
    spacer_recovery,
)

K = 23
BASELINE_NODES_PER_S = 100_000.0  # the reference's optimised start-node scan (BASELINE.md)
RUN_STATS = "runs.json"  # what a cell's process writes into its folder

PART1_METRICS = (
    "graph_build_kmers_per_s",
    "planted_build_kmers_per_s",
    "cycle_search_nodes_per_s",
    "e2e_reads_per_s_warm",
    "spacer_recovery",
    "scaling",
)
CELL_METRICS = (
    "cold_s",
    "wall_s",
    "reads_per_s",
    "stages_s",
    "device_peak_bytes",
    "reserved_unused_at_peak_bytes",
    "nodes",
    "unique_kp1_mers",
    "adjacency_chunks",
    "launches",
    "report_sha1",
    "gate",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Part 1: bench.py's metrics
# ---------------------------------------------------------------------------


def synth_reads(n_reads: int, length: int, device, seed: int = 0):
    """``bench.py::synth_reads``: uniform random codes from ``default_rng(seed)``."""
    import torch

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_reads, length)).astype(np.uint8)
    lengths = np.full(n_reads, length, dtype=np.int32)
    return torch.as_tensor(codes, device=device), torch.as_tensor(lengths, device=device)


def build_step(codes, lengths) -> tuple[int, int, int]:
    """The build chain of ``bench.py::build_step`` on one strand: the
    (k+1)-mers counted, the last k-mers counted, the node table and each
    edge's source id derived from the edge table, and the adjacency in one
    pass. Returns ``(n23, n24, present out-slots)``."""
    from mcaat_tpu_torch.graph.dbg import build_adjacency_chunked
    from mcaat_tpu_torch.kmer.count import (
        count_unique,
        derive_nodes_from_edges,
        extract_kmers,
        extract_last_kmer,
    )

    km1 = extract_kmers(codes, lengths, K + 1).reshape(-1)
    u24, c24, n24 = count_unique(km1)
    del km1
    last = extract_last_kmer(codes, lengths, K)
    u_l, c_l, _n_l = count_unique(last)
    u23, _c23, n23, u_id = derive_nodes_from_edges(u24, c24, u_l, c_l)
    out, _in = build_adjacency_chunked(u23, u24, u_id=u_id, chunk_edges=max(n24, 1))
    return n23, n24, int((out >= 0).sum())


def bench_uniform_build(device, n_reads: int = 100_000, length: int = 100, iters: int = 3):
    """k-mers a second of :func:`build_step` on uniform reads: one warm-up,
    then ``iters`` timed calls (``n_reads * (length - K + 1)`` windows each)."""
    from mcaat_tpu_torch.utils.profiling import sync

    codes, lengths = synth_reads(n_reads, length, device)
    n_windows = n_reads * (length - K + 1)
    build_step(codes, lengths)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        build_step(codes, lengths)
    sync(device)
    return n_windows / ((time.perf_counter() - t0) / iters)


def bench_planted(meta, fq_path: str, device, work: str):
    """The planted-metagenome build, cycle-search and warm end-to-end
    rates of ``bench.py::bench_planted``. Returns ``(figures, report
    text)``; the cycle-search rate and ``graph_nodes`` count live nodes."""
    from mcaat_tpu_torch.cycles.finder import find_cycles
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads
    from mcaat_tpu_torch.io.fastq import read_encoded_batch
    from mcaat_tpu_torch.pipeline import run_pipeline
    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils.profiling import sync

    batch = read_encoded_batch(fq_path)
    n_windows = 2 * int(np.maximum(batch.lengths - K + 1, 0).sum())  # + the reverse strand

    def build():
        g = build_dbg_from_reads(batch.codes, batch.lengths, k=K, device=device)
        sync(device)
        return g

    build()
    t0 = time.perf_counter()
    g = build()
    build_dt = time.perf_counter() - t0

    def search():
        out = find_cycles(g, verbose=False)
        sync(device)
        return out

    search()
    t0 = time.perf_counter()
    _g2, cycles_map = search()
    search_dt = time.perf_counter() - t0

    s = Settings(input_files=fq_path, output_file=os.path.join(work, "CRISPR_Arrays.txt"))
    with contextlib.redirect_stdout(sys.stderr):
        run_pipeline(s, verbose=False, device=device)
        t0 = time.perf_counter()
        result = run_pipeline(s, verbose=False, device=device)
        sync(device)
        e2e_dt = time.perf_counter() - t0
    found, planted = spacer_recovery(meta["arrays"], result.report_text)
    return {
        "planted_build_kmers_per_s": n_windows / build_dt,
        "cycle_search_nodes_per_s": g.size / search_dt,
        "graph_nodes": int(g.size),
        "n_cycles": sum(len(v) for v in cycles_map.values()),
        "e2e_reads_per_s_warm": batch.num_reads / e2e_dt,
        "e2e_seconds_warm": e2e_dt,
        "n_reads": batch.num_reads,
        "spacer_recovery": f"{found}/{planted}",
        "report_sha1": hashlib.sha1(result.report_text.encode()).hexdigest(),
    }, result.report_text


def node_table_sha1(kmers: np.ndarray) -> str:
    """``bench.py``'s digest of a node table: SHA-1 of the sorted live
    k-mers as int64, 16 hex digits."""
    flat = np.sort(np.asarray(kmers, dtype=np.int64).ravel())
    return hashlib.sha1(flat.tobytes()).hexdigest()[:16]


def scaling_child(fq_path: str, device) -> dict:
    """One kp of :func:`bench_scaling`, in its own process (the shard
    count is ``MCAAT_TORCH_SHARDS``): a warm-up build, then a timed one
    with the bytes it exchanged and its count parts' peak."""
    import torch

    from mcaat_tpu_torch.io.fastq import read_encoded_batch
    from mcaat_tpu_torch.parallel.sharded_pipeline import build_sharded_graph_for_pipeline
    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils import wire
    from mcaat_tpu_torch.utils.profiling import sync

    b = read_encoded_batch(fq_path)
    s = Settings()
    cuda = device.type == "cuda"
    build_sharded_graph_for_pipeline(b.codes, b.lengths, s, device=device)  # warm-up
    sync(device)
    wire.reset()
    with probe_sharded_count(device) as probe:
        t0 = time.perf_counter()
        sg = build_sharded_graph_for_pipeline(b.codes, b.lengths, s, device=device)
        sync(device)
        dt = time.perf_counter() - t0
    rows, peaks = probe["rows"], probe["peaks"]
    mesh = sg.mesh
    kp = mesh.kp
    shards = sorted(mesh.primary, key=lambda i: mesh.local_kp[i])
    table = np.concatenate([sg.kmers[i].cpu().numpy() for i in shards])
    live = np.asarray(sg.n_live, dtype=np.int64)
    moved = wire.snapshot()
    wire_b = sum(v["bytes"] for v in moved.values())
    return {
        "kp": kp,
        "live_rows_max_per_shard": int(live.max()),
        "live_rows_min_per_shard": int(live.min()),
        "shard_capacity": int(sg.T),
        "capacity_over_max_live": int(sg.T) / max(int(live.max()), 1),
        # kmers 8 B + mult 4 B + out and in 4 x 4 B each, a live row
        "store_mb_per_shard": int(live.max()) * 44 / 2**20,
        "a2a_wire_mb_per_device": wire_b / kp / 2**20,
        "wire": moved,
        "build_wall_s": dt,
        "wall_note": (f"{kp} shard(s) on one {torch.cuda.get_device_name(device)}: the wall "
                      "holds the exchanges between shards on that card, not between cards"
                      if cuda else f"{kp} shard(s) on the CPU"),
        "node_table_sha1": node_table_sha1(table),
        "nodes": int(live.sum()),
        "count_parts": int(sg.n_parts),
        "count_rows_max": max(rows) if rows else 0,
        "bytes_per_count_row": peaks["count"] / max(rows) if "count" in peaks and rows else None,
        "device_peak_bytes": probe["peak_bytes"] if cuda else -1,
    }


def child_env(device, cards: int = 1, **extra) -> dict:
    """The environment of a benchmark process: no ``MCAAT_*`` variable of
    this one leaks into it; ``MCAAT_TORCH_DEVICE`` names the device and,
    on the card, ``CUDA_VISIBLE_DEVICES`` the first ``cards`` cards this
    process sees (so a one-card cell stays on one card on a larger host)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    env["MCAAT_TORCH_DEVICE"] = device.type
    if device.type == "cuda":
        visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if c]
        env["CUDA_VISIBLE_DEVICES"] = ",".join(visible[:cards] or map(str, range(cards)))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_child(args: list, env: dict, log_path: str, timeout: float) -> int:
    """Run ``bench_torch.py --child ...`` with its output in ``log_path``."""
    with open(log_path, "w") as fh:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args], env=env,
                              stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT, timeout=timeout)
    return proc.returncode


def bench_scaling(fq_path: str, device, work: str) -> dict:
    """The sharded build at kp 1 and kp 8 (``MCAAT_TORCH_SHARDS``; on a
    card every shard is on that card), a process each: per-shard live
    rows and store bytes, the bytes exchanged, the node table's SHA-1 (kp
    8 must equal kp 1) and the bytes a count row of the sharded count
    (the unit of ``SHARDED_COUNT_SHARD_ROWS``)."""
    from mcaat_tpu_torch.parallel.sharded_graph import SHARDED_COUNT_SHARD_ROWS

    out: dict = {}
    for kp in (1, 8):
        stats = os.path.join(work, f"scaling_kp{kp}.json")
        rc = run_child(["--child", "scaling", "--device", device.type, "--inputs", fq_path,
                        "--out", stats], child_env(device, MCAAT_TORCH_SHARDS=kp),
                       os.path.join(work, f"scaling_kp{kp}.log"), timeout=900)
        if rc != 0 or not os.path.exists(stats):
            with open(os.path.join(work, f"scaling_kp{kp}.log")) as fh:
                log(fh.read()[-4000:])
            out[f"kp{kp}"] = None
            continue
        with open(stats) as fh:
            out[f"kp{kp}"] = json.load(fh)
    k1, k8 = out.get("kp1"), out.get("kp8")
    out["node_table_parity"] = bool(
        k1 and k8 and k1["node_table_sha1"] == k8["node_table_sha1"]
    )
    per_row = k1 and k1["bytes_per_count_row"]
    out["count_budget"] = {
        "shard_rows": SHARDED_COUNT_SHARD_ROWS,
        "bytes_per_count_row_kp1": per_row,
        "gib_a_shard_at_budget": per_row * SHARDED_COUNT_SHARD_ROWS / 2**30 if per_row else None,
    }
    return out


# ---------------------------------------------------------------------------
# Part 2: the cells
# ---------------------------------------------------------------------------


@dataclass
class CellInput:
    files: list
    n_reads: int
    arrays: list | None = None  # the planted truth, when there is one
    errors: bool = False  # substitutions in the reads
    expected: bytes | None = None  # the committed report, when there is one
    # (arrays with a system, share of the spacers) to reach, when not every
    # array and 98% / 95%
    floor: tuple[int, float] | None = None


@dataclass
class Cell:
    source: str
    make: Callable[[str], CellInput]  # writes the input into a folder
    cards: int = 1
    systems_over_24: int = 0  # systems that launch each report kernel once on the card
    # partial_ratio's launches where the substring filter cuts systems to 24
    # spacers or fewer (it runs first); systems_over_24 where it is None
    filtered_over_24: int | None = None


def want_launches(cell: Cell, device) -> dict:
    """The launches of each report kernel a run of the cell must count:
    ``ratio_matrix`` and ``partial_ratio`` once a system of more than 24
    spacers on the card (``CRISPRAnalyzer.BATCH_THRESHOLD``; ``partial_ratio``
    also for a system its substring filter then cuts to 24 or fewer), the
    per-pair kernel never; none on the CPU, which runs their plain versions."""
    if device.type != "cuda":
        return {"lcs_ratio": 0, "partial_ratio": 0, "ratio_matrix": 0}
    n = cell.systems_over_24
    return {"lcs_ratio": 0, "partial_ratio": n if cell.filtered_over_24 is None
            else cell.filtered_over_24, "ratio_matrix": n}


def _matrix_cell(**call) -> Callable[[str], CellInput]:
    def make(folder: str) -> CellInput:
        from torch_reads import metagenome_matrix, write_fastq_matrix

        arrays, reads = metagenome_matrix(**call)
        path = os.path.join(folder, "reads.fq")
        write_fastq_matrix(path, reads)
        return CellInput([path], int(reads.shape[0]), arrays)

    return make


def _named_cell(name: str) -> Callable[[str], CellInput]:
    def make(folder: str) -> CellInput:
        from torch_reads import make_named

        got = make_named(name, folder)
        return CellInput(got["files"], got["n_reads"], got["arrays"], errors=True)

    return make


def _fragment_cell(name: str) -> Callable[[str], CellInput]:
    def make(folder: str) -> CellInput:
        from torch_fragments import make_named, truth_floor

        got = make_named(name, folder)
        return CellInput(got["files"], got["n_reads"], got["arrays"], errors=True,
                         floor=truth_floor(name))

    return make


def fastq_reads(path: str) -> int:
    with open(path, "rb") as fh:
        return sum(1 for _ in fh) // 4


def _array_250(folder: str) -> CellInput:
    import torch_big_array

    path, meta = torch_big_array.make_input(folder)
    return CellInput([path], fastq_reads(path), meta["arrays"],
                     expected=torch_big_array.expected_report())


def _golden(folder: str) -> CellInput:
    data = os.path.join(TESTS, "data")
    with open(os.path.join(data, "golden_CRISPR_Arrays.txt"), "rb") as fh:
        expected = fh.read()
    path = os.path.join(data, "golden_reads.fq")
    return CellInput([path], fastq_reads(path), expected=expected)


def _planted_500m(folder: str) -> CellInput:
    from torch_reads import PLANTED_20X30
    from torch_sharded_past_ceiling import write_planted_fastq

    path = os.path.join(folder, "reads.fq")
    arrays, n_reads = write_planted_fastq(path, **dict(PLANTED_20X30, background_len=500_000_000))
    return CellInput([path], n_reads, arrays)


PLANTED_TINY = dict(seed=123, n_arrays=2, n_spacers=6, background_len=20_000,
                    background_coverage=8.0, coverage=35.0)
_MAKE_METAGENOME = "tests/synthetic.make_metagenome"


def _cells() -> dict:
    from torch_reads import PLANTED_20X30, SAMPLE_1B

    return {
        "planted-20x30": Cell(f"{_MAKE_METAGENOME}(seed=7, n_arrays=20, n_spacers=30, "
                              "background_len=10_000_000, background_coverage=8.0, coverage=35.0)",
                              _matrix_cell(**PLANTED_20X30), systems_over_24=20),
        "planted-20x30-err-pe": Cell("tests/torch_reads.py planted-20x30-err-pe (0.5% "
                                     "substitutions, seed 1, two mates)",
                                     _named_cell("planted-20x30-err-pe"), systems_over_24=20),
        "planted-20x30-40M": Cell("planted-20x30 with background_len=40_000_000, one pass",
                                  _matrix_cell(**dict(PLANTED_20X30, background_len=40_000_000)),
                                  systems_over_24=20),
        "sample-1.03B": Cell("scripts/torch_e2e_big.py 400 62000000 10.4 "
                             "(tests/torch_reads.py SAMPLE_1B)", _matrix_cell(**SAMPLE_1B)),
        "sample-1.03B-err-pe": Cell("tests/torch_reads.py sample-1.03B-err-pe (0.5% "
                                    "substitutions, seed 1, two mates)",
                                    _named_cell("sample-1.03B-err-pe")),
        "array-250": Cell("tests/torch_big_array.py (one array of 250 spacers)", _array_250,
                          systems_over_24=1),
        "mixed-pe150": Cell("tests/torch_fragments.py mixed-pe150 (2x150-bp fragment pairs, "
                            "trimmed mates, N bases, 3'-rising substitutions; 40 arrays of 4-60 "
                            "spacers in 10 Mbp)", _fragment_cell("mixed-pe150"),
                            systems_over_24=14, filtered_over_24=15),
        "sample-pe150": Cell("tests/torch_fragments.py sample-pe150 (the same reads; 400 arrays "
                             "of 3-12 spacers, about 1.03B padded windows)",
                             _fragment_cell("sample-pe150")),
        "planted-20x30-500M": Cell("scripts/torch_sharded_past_ceiling.py 500000000 --cards 4 "
                                   "(one process, --mesh auto, one shard a card)",
                                   _planted_500m, cards=4, systems_over_24=20),
        "golden": Cell("tests/data/golden_reads.fq", _golden),
        "planted-tiny": Cell(f"{_MAKE_METAGENOME}(seed=123, n_arrays=2, n_spacers=6, "
                             "background_len=20_000, background_coverage=8.0, coverage=35.0)",
                             _matrix_cell(**PLANTED_TINY)),
    }


ONE_CARD_CELLS = ("planted-20x30", "planted-20x30-err-pe", "planted-20x30-40M", "sample-1.03B",
                  "sample-1.03B-err-pe", "array-250", "mixed-pe150", "sample-pe150")
QUICK_CELLS = ("golden", "planted-tiny")


def one_run(argv: list, console) -> dict:
    """One ``run_cli(argv)`` with its console in ``console``: wall seconds,
    stage seconds, the device peak and the bytes reserved but unused in
    the peak stage, the build's counts and the report kernels' launches."""
    import torch

    from mcaat_tpu_torch.cli import run_cli
    from mcaat_tpu_torch.report import lcs_cuda

    lcs_cuda.reset_launch_counts()
    with probe_pipeline() as probe, contextlib.redirect_stdout(console):
        t0 = time.perf_counter()
        result = run_cli(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if result is None:
        raise RuntimeError(f"the CLI refused {argv}")
    stages = {s.name: s.seconds for s in result.profile.stages}
    peak = unused = None
    for s in result.profile.stages:  # the peak stage and what the allocator held unused then
        if s.device_peak_mb is not None and (peak is None or s.device_peak_mb * 2**20 > peak):
            peak = int(s.device_peak_mb * 2**20)
            unused = int(s.device_reserved_mb * 2**20) - peak
    nodes = next((s.counters.get("nodes") for s in result.profile.stages
                  if s.name == "graph_build"), None)
    return {
        "wall_s": wall,
        "stages_s": stages,
        "device_peak_bytes": peak,
        "reserved_unused_at_peak_bytes": unused,
        "nodes": nodes,
        "unique_kp1_mers": probe["unique_edges"] or None,
        "adjacency_chunks": probe["adjacency_chunks"] or None,
        "count_parts": probe["count_parts"] or None,
        "launches": lcs_cuda.launch_counts(),
        "systems": len(result.found_systems),
    }


def cell_child(files: list, out: str, runs: int, device) -> int:
    """A cell's process: run 0 is cold (the process's first), runs 1 ...
    ``runs`` warm. Each run's report goes to ``out/run<i>/``; the figures
    to ``out/runs.json`` after every run. A run that runs out of device
    memory ends the cell, with the allocator's figures."""
    import torch

    from mcaat_tpu_torch.utils.profiling import device_memory_stats

    done: list = []
    stats_path = os.path.join(out, RUN_STATS)
    with open(os.path.join(out, "console.log"), "w") as console:
        for i in range(runs + 1):
            folder = os.path.join(out, f"run{i}")
            try:
                st = one_run(["--input-files", *files, "--output-folder", folder], console)
            except torch.OutOfMemoryError as e:
                cards = range(torch.cuda.device_count()) if device.type == "cuda" else []
                done.append({"run": i, "error": "out_of_memory", "message": str(e)[:2000],
                             "memory": [device_memory_stats(torch.device("cuda", c))
                                        for c in cards]})
                break
            finally:
                console.flush()
            st["run"] = i
            done.append(st)
            with open(stats_path, "w") as fh:
                json.dump(done, fh)
            log(f"  run {i}: {st['wall_s']:.2f}s")
    with open(stats_path, "w") as fh:
        json.dump(done, fh)
    return 0 if all("error" not in r for r in done) else 1


def read_report(folder: str) -> bytes:
    with open(os.path.join(folder, "CRISPR_Arrays.txt"), "rb") as fh:
        return fh.read()


def truth_failures(inp: CellInput, report: bytes) -> list:
    """What a report misses of the planted truth (empty when it passes)."""
    if inp.arrays is None:
        return []
    text = report.decode()
    n = arrays_found(inp.arrays, text, inp.errors)
    found, planted = spacer_recovery(inp.arrays, text)
    arrays, need = inp.floor or (len(inp.arrays), 0.95 if inp.errors else 0.98)
    bad = []
    if n < arrays:
        bad.append(f"{n}/{len(inp.arrays)} planted arrays have a system, under {arrays}")
    if found < need * planted:
        bad.append(f"{found}/{planted} spacers found, under {need:.0%}")
    return bad


def spread(values: list) -> dict | None:
    """Median and quartiles (linear interpolation) with the sample count."""
    if not values:
        return None
    q1, med, q3 = (float(x) for x in np.percentile(values, [25, 50, 75]))
    return {"median": med, "q1": q1, "q3": q3, "n": len(values),
            "iqr_over_median": (q3 - q1) / med if med else None}


def _most(values):
    """The largest of the values that were measured (None on the CPU)."""
    return max((v for v in values if v is not None), default=None)


def summarise(inp: CellInput, runs: list, reports: list, launches: dict) -> dict:
    """A cell's figures from its runs and their reports; ``gate`` is
    ``"passed"`` or the list of what failed. ``launches`` is what every
    run must count (:func:`want_launches`)."""
    fails = [f"run {r['run']}: {r['error']}" for r in runs if "error" in r]
    runs = [r for r in runs if "error" not in r]
    if not runs:
        return {"gate": fails or ["no run finished"]}
    ref = inp.expected if inp.expected is not None else reports[0]
    whose = "the committed one" if inp.expected is not None else "run 0's"
    fails += [f"run 0: {f}" for f in truth_failures(inp, ref)]
    for r, rep in zip(runs, reports):
        if rep != ref:
            fails.append(f"run {r['run']}: its report differs from {whose}")
        if r["launches"] != launches:
            fails.append(f"run {r['run']}: launched {r['launches']}, not {launches}")
    ok = [r for r, rep in zip(runs, reports) if rep == ref and r["launches"] == launches]
    warm = [r for r in ok if r["run"] > 0]
    stage_names = list(dict.fromkeys(n for r in warm for n in r["stages_s"]))
    text = ref.decode()
    out = {
        "cold_s": runs[0]["wall_s"] if runs[0]["run"] == 0 and runs[0] in ok else None,
        "wall_s": spread([r["wall_s"] for r in warm]),
        "reads_per_s": spread([inp.n_reads / r["wall_s"] for r in warm]),
        "stages_s": {n: float(np.median([r["stages_s"][n] for r in warm if n in r["stages_s"]]))
                     for n in stage_names},
        "device_peak_bytes": _most(r["device_peak_bytes"] for r in ok),
        "reserved_unused_at_peak_bytes": _most(r["reserved_unused_at_peak_bytes"] for r in ok),
        "nodes": runs[0]["nodes"],
        "unique_kp1_mers": runs[0]["unique_kp1_mers"],
        "adjacency_chunks": runs[0]["adjacency_chunks"],
        "count_parts": runs[0]["count_parts"],
        "launches": runs[0]["launches"],
        "systems": runs[0]["systems"],
        "report_sha1": hashlib.sha1(ref).hexdigest(),
        "report_bytes": len(ref),
        "n_reads": inp.n_reads,
        "gate": fails or "passed",
        "per_run": runs,
    }
    if inp.arrays is not None:
        found, planted = spacer_recovery(inp.arrays, text)
        out["arrays"] = f"{arrays_found(inp.arrays, text, inp.errors)}/{len(inp.arrays)}"
        out["spacer_recovery"] = f"{found}/{planted}"
    return out


def bench_cell(name: str, cell: Cell, runs: int, device, work: str, timeout: float) -> dict:
    """Write the cell's input, run it in a process of its own (one cold
    run, ``runs`` warm ones) and summarise."""
    folder = os.path.join(work, name)
    os.makedirs(folder, exist_ok=True)
    t0 = time.perf_counter()
    inp = cell.make(folder)
    gen_s = time.perf_counter() - t0
    log(f"bench: cell {name}: {inp.n_reads} reads written in {gen_s:.1f}s")
    out = os.path.join(folder, "out")
    os.makedirs(out, exist_ok=True)
    extra = {"MCAAT_TORCH_SHARDS": cell.cards} if device.type == "cpu" and cell.cards > 1 else {}
    t0 = time.perf_counter()
    rc = run_child(["--child", "cell", "--device", device.type, "--runs", str(runs),
                    "--out", out, "--inputs", *inp.files], child_env(device, cell.cards, **extra),
                   os.path.join(folder, "child.log"), timeout)
    child_s = time.perf_counter() - t0
    runs_done = []
    if os.path.exists(os.path.join(out, RUN_STATS)):
        with open(os.path.join(out, RUN_STATS)) as fh:
            runs_done = json.load(fh)
    reports = [read_report(os.path.join(out, f"run{r['run']}")) for r in runs_done
               if "error" not in r]
    summary = summarise(inp, runs_done, reports, want_launches(cell, device))
    if rc != 0 and summary["gate"] == "passed":
        summary["gate"] = [f"the cell's process exited with {rc}"]
    if summary["gate"] != "passed":
        with open(os.path.join(folder, "child.log")) as fh:
            log(fh.read()[-4000:])
    summary.update(source=cell.source, cards=cell.cards, generate_s=gen_s, process_s=child_s)
    wall = summary.get("wall_s")
    log(f"bench: cell {name}: cold {summary.get('cold_s')}, warm median "
        f"{wall and wall['median']} s over {wall and wall['n']} runs, gate {summary['gate']}")
    shutil.rmtree(folder, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Benchmark of mcaat_tpu_torch (see the docstring)")
    ap.add_argument("--cell", action="append", help="a named input (repeatable); default: "
                    "every one-card cell")
    ap.add_argument("--runs", type=int, help="warm runs a cell (10; 2 with --quick)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true", help="small sizes, for the CPU")
    ap.add_argument("--json", help="also write the result line to this file")
    ap.add_argument("--child", choices=("cell", "scaling"), help=argparse.SUPPRESS)
    ap.add_argument("--inputs", nargs="+", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def card_line(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    from mcaat_tpu_torch import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)  # raises for cuda without a card
    if args.child == "scaling":
        with open(args.out, "w") as fh:
            json.dump(scaling_child(args.inputs[0], device), fh)
        return 0
    if args.child == "cell":
        return cell_child(args.inputs, args.out, args.runs, device)

    import torch

    from synthetic import make_metagenome, write_fastq

    cells = _cells()
    names = args.cell or (QUICK_CELLS if args.quick else ONE_CARD_CELLS)
    for n in names:
        if n not in cells:
            raise SystemExit(f"bench_torch: no cell {n!r} (cells: {', '.join(cells)})")
    need = max(cells[n].cards for n in names)
    if device.type == "cuda" and torch.cuda.device_count() < need:
        raise SystemExit(f"bench_torch: the cells need {need} cards, "
                         f"{torch.cuda.device_count()} visible")
    runs = args.runs if args.runs is not None else (2 if args.quick else 10)
    if device.type == "cuda":  # Part 1 runs on one card, not sharded over every visible one
        device = torch.device("cuda", 0)
    card = card_line(device)
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    log(f"bench: torch {torch.__version__} on {card or 'the CPU'}")
    if device.type == "cuda":  # built here, so that no run holds the nvcc build
        from mcaat_tpu_torch.report import lcs_cuda

        lcs_cuda.build()

    work = tempfile.mkdtemp(prefix="bench_torch_")
    try:
        log("bench: uniform build ...")
        uniform_rate = bench_uniform_build(device, n_reads=2_000 if args.quick else 100_000)
        log(f"bench: uniform build {uniform_rate / 1e6:.2f}M k-mers/s")
        meta = make_metagenome(**(PLANTED_TINY if args.quick else dict(
            seed=123, n_arrays=20, n_spacers=6, background_len=200_000,
            background_coverage=8.0, coverage=35.0)))
        fq = os.path.join(work, "planted.fq")
        write_fastq(fq, meta.pop("reads"))
        log("bench: planted metagenome ...")
        extra, _report = bench_planted(meta, fq, device, work)
        extra["graph_build_kmers_per_s"] = uniform_rate
        log(f"bench: planted {extra}")
        log("bench: scaling (kp 1 and kp 8, a process each) ...")
        extra["scaling"] = bench_scaling(fq, device, work)
        log(f"bench: scaling parity {extra['scaling']['node_table_parity']}")
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the cells' processes share the card
        extra["cells"] = {}
        for n in names:
            extra["cells"][n] = bench_cell(n, cells[n], runs, device, work,
                                           timeout=3600 if cells[n].cards > 1 else 1800)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failed = [n for n, c in extra["cells"].items() if c["gate"] != "passed"]
    if not extra["scaling"]["node_table_parity"]:
        failed.append("scaling")
    extra.update(failed=failed, runs=runs, card=card,
                 device={"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                         "count": torch.cuda.device_count() if device.type == "cuda" else 0})
    line = json.dumps({
        "metric": "graph_build_kmers_per_s_per_chip",
        "value": uniform_rate,
        "unit": "kmers/s",
        "vs_baseline": uniform_rate / BASELINE_NODES_PER_S,
        "extra": extra,
    })
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
