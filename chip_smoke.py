#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mcaat_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written LCS kernel (``mcaat_tpu_torch/csrc/lcs.cu``);
3. the kernel against its plain torch version on the card: exact
   equality of LCS and bitwise equality of the ratio over batch sizes
   1 ... 1M, every length pair in [0, 64]^2, identical and empty strings;
   times of both at 1M pairs;
4. the four golden fixtures of ``tests/data`` through the port on the
   card: byte-identical ``CRISPR_Arrays.txt``;
5. a planted metagenome (20 arrays of 30 spacers in a 10 Mbp background,
   about 0.8M reads; more than 2M graph nodes, so the neighbourhood
   extraction, lazy clip and region condensation branches run) through
   the CLI entry point: every array reported, at least 98% of the
   spacers recovered, the LCS kernel launched on that path; then the
   kernel and its plain version timed again on the inputs the path gave
   it;
7. the chunked build at full width: a 40 Mbp planted metagenome (3.2M
   reads, about 495M windows) built in one pass and in at least 4 row
   parts with a host spill and a chunked adjacency; every table and both
   endpoint tensors equal, seconds and device peaks printed;
8. the same input through the CLI with a ``--ram`` that forces parts and
   without: 20/20 arrays, at least 98% of the spacers, LCS launches,
   byte-identical reports;
9. ``--resume`` on the input of phase 5: a first run writes the four
   checkpoints, a second loads all three stages, a third (without
   ``reads.json`` and ``cycles.json``) loads the graph; all three
   reports byte-identical; checkpoint write and load seconds printed;
10. ``--debug-pipeline`` through the CLI entry point: the four outputs
    on the inputs of ``tests/torch_debug_inputs.py`` equal the
    JAX-written files in ``tests/torch_data/debug/``; on the input of
    phase 5 the run writes all four, its histogram equals that of a
    separate build of that input, and each stage's seconds are printed.

Each path after phase 6 reads its own LCS launch count (zeroed just
before it) and fails when it is 0; the kernel's inputs on phases 8 and
10 are held against the plain version too.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their launch counts, errors
and times. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str):
    """Decorator: run a phase, print its seconds, exit non-zero on error."""

    def wrap(fn):
        def run(*args, **kwargs):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except SystemExit:
                raise
            except BaseException:
                traceback.print_exc()
                fail(f"phase '{name}' raised")
            print(f"== {name}: ok ({time.perf_counter() - t0:.2f}s)", flush=True)
            return out

        return run

    return wrap


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(kernel, plain, inputs) -> float:
    """Run kernel and plain version on the same inputs; require exact
    equality (LCS as integers, ratio bit for bit). Returns the largest
    absolute difference, which must be 0."""
    import torch

    l1, r1 = kernel(*inputs)
    l2, r2 = plain(*inputs)
    torch.cuda.synchronize()
    if not torch.equal(l1, l2):
        bad = int((l1 != l2).sum())
        fail(f"LCS differs from the plain version on {bad}/{l1.numel()} pairs")
    if not torch.equal(r1.view(torch.int32), r2.view(torch.int32)):
        bad = int((r1.view(torch.int32) != r2.view(torch.int32)).sum())
        fail(f"ratio differs bitwise from the plain version on {bad}/{r1.numel()} pairs")
    err = max(
        float((l1 - l2).abs().max()) if l1.numel() else 0.0,
        float((r1 - r2).abs().max()) if r1.numel() else 0.0,
    )
    return err


def random_pairs(rng, B: int, device):
    """Random 2-bit code rows; the first rows carry the edge lengths
    0, 32, 33, 64, identical strings and empty strings."""
    import numpy as np
    import torch

    a = rng.integers(0, 4, (B, 64), dtype=np.uint8)
    b = rng.integers(0, 4, (B, 64), dtype=np.uint8)
    la = rng.integers(0, 65, B).astype(np.int32)
    lb = rng.integers(0, 65, B).astype(np.int32)
    edge = [(0, 0), (32, 33), (33, 32), (64, 64), (64, 0), (0, 64), (32, 32), (33, 64)]
    for i, (x, y) in enumerate(edge[:B]):
        la[i], lb[i] = x, y
    for i in range(len(edge), min(B, len(edge) + 4)):  # identical strings
        b[i] = a[i]
        lb[i] = la[i]
    return [torch.as_tensor(x, device=device) for x in (a, la, b, lb)]


def length_grid(rng, device):
    """Every (|a|, |b|) in [0, 64]^2 once, random codes."""
    import numpy as np
    import torch

    la, lb = np.meshgrid(np.arange(65), np.arange(65), indexing="ij")
    B = la.size
    a = rng.integers(0, 4, (B, 64), dtype=np.uint8)
    b = rng.integers(0, 4, (B, 64), dtype=np.uint8)
    return [
        torch.as_tensor(x, device=device)
        for x in (a, la.reshape(-1).astype(np.int32), b, lb.reshape(-1).astype(np.int32))
    ]


def recovery(meta, report: str):
    """(arrays reported, planted spacers, spacers recovered) of a report
    against the planted ground truth (either strand; the reported repeat
    lacks its last base, a reference quirk)."""
    from mcaat_tpu_torch.io.fastq import reverse_complement

    arrays = sum(
        1 for a in meta["arrays"]
        if a["repeat"][:-1] in report or reverse_complement(a["repeat"])[:-1] in report
    )
    spacers = [s for a in meta["arrays"] for s in a["spacers"]]
    found = sum(
        1 for s in spacers if s[6:-6] in report or reverse_complement(s[6:-6]) in report
    )
    return arrays, spacers, found


@contextlib.contextmanager
def lcs_run(lcs_cuda, seen: list | None = None):
    """Zero the LCS launch count for one path and read it after; with
    ``seen``, record the kernel's inputs on that path (the count stays
    the wrapper's own). Yields a dict whose ``launches`` is set on exit."""
    out = {}
    launch = lcs_cuda.lcs_ratio_cuda

    def recording(*args):
        seen.append([t.clone() for t in args])
        return launch(*args)

    if seen is not None:
        lcs_cuda.lcs_ratio_cuda = recording
    lcs_cuda.LAUNCHES = 0
    try:
        yield out
    finally:
        out["launches"] = lcs_cuda.LAUNCHES
        lcs_cuda.lcs_ratio_cuda = launch


@contextlib.contextmanager
def counting(module, name: str, counts: dict, timed: bool = False):
    """Count the calls of ``module.name`` (and sum their seconds with
    ``timed``) into ``counts[name]`` / ``counts[name + "_s"]``."""
    orig = getattr(module, name)
    counts.setdefault(name, 0)
    counts.setdefault(name + "_s", 0.0)

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            counts[name] += 1
            counts[name + "_s"] += time.perf_counter() - t0

    setattr(module, name, spy)
    try:
        yield counts
    finally:
        setattr(module, name, orig)


def quiet_cli(run_cli, argv, log_name: str):
    """``run_cli(argv)`` with its console output kept in
    ``build/chip_smoke/<log_name>`` instead of the tail of this script's
    output (it lists every array found); returns ``(result, console
    text, wall seconds)``."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = run_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = os.path.join(ROOT, "build", "chip_smoke", log_name)
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as fh:
        fh.write(buf.getvalue())
    if result is None:
        fail(f"the CLI refused the settings ({log_name})")
    return result, buf.getvalue(), wall


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import mcaat_tpu_torch  # noqa: F401
        from synthetic import make_metagenome, write_fastq
    except ImportError as e:
        fail(f"the repository is not beside chip_smoke.py ({e})")
    os.environ["MCAAT_TORCH_DEVICE"] = "cuda"
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    import numpy as np

    import mcaat_tpu_torch.pipeline as tpipeline
    from mcaat_tpu_torch.report import lcs_cuda
    from mcaat_tpu_torch.report.batched_fuzz import lcs_ratio_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    @phase("1 card")
    def p1():
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")

    @phase("2 build the LCS kernel")
    def p2():
        lcs_cuda.build(verbose_ptxas=True)
        info = lcs_cuda.BUILD_INFO
        print(f"nvcc: {info['seconds']:.2f}s -> {os.path.relpath(info['path'], ROOT)}")
        for line in info["output"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    stats = {"max_abs_err": 0.0}

    @phase("3 LCS kernel vs plain torch on the card")
    def p3():
        rng = np.random.default_rng(0)
        cases = [("length grid 65x65", length_grid(rng, device))]
        for B in (1, 31, 32, 33, 4097, 1 << 20):
            cases.append((f"B={B}", random_pairs(rng, B, device)))
        for name, inputs in cases:
            err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, inputs)
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            print(f"  {name}: equal (max abs err {err})")
        # a few pairs against the host reference implementation too
        from mcaat_tpu_torch.report.fuzz import lcs_length

        a, la, b, lb = (t.cpu().numpy() for t in cases[-2][1])
        lcs, _ = lcs_cuda.lcs_ratio_cuda(*cases[-2][1])
        lcs = lcs.cpu().numpy()
        for i in range(0, a.shape[0], 97):
            sa = "".join("ACGT"[c] for c in a[i, : la[i]])
            sb = "".join("ACGT"[c] for c in b[i, : lb[i]])
            if lcs[i] != lcs_length(sa, sb):
                fail(f"kernel LCS {lcs[i]} != host LCS {lcs_length(sa, sb)} on pair {i}")
        big = cases[-1][1]
        stats["ms_1m"] = cuda_ms(lambda: lcs_cuda.lcs_ratio_cuda(*big), 20)
        stats["plain_ms_1m"] = cuda_ms(lambda: lcs_ratio_plain(*big), 5)
        print(
            f"  1,048,576 pairs: kernel {stats['ms_1m']:.4f} ms, plain "
            f"{stats['plain_ms_1m']:.4f} ms ({card})"
        )

    @phase("4 golden fixtures through the port on the card")
    def p4():
        from mcaat_tpu_torch.pipeline import run_pipeline
        from mcaat_tpu_torch.settings import Settings

        data = os.path.join(ROOT, "tests", "data")
        fixtures = {
            "golden": "golden_reads.fq",
            "golden_rc": "golden_rc_reads.fq",
            "golden_mut": "golden_mut_reads.fq",
            "golden_pe": "golden_pe_1.fq golden_pe_2.fq",
        }
        with tempfile.TemporaryDirectory() as tmp:
            for name, files in fixtures.items():
                s = Settings(
                    input_files=" ".join(os.path.join(data, f) for f in files.split()),
                    output_file=os.path.join(tmp, f"{name}.txt"),
                )
                r = run_pipeline(s, verbose=False, device=device)
                expected = open(os.path.join(data, f"{name}_CRISPR_Arrays.txt")).read()
                if r.report_text != expected:
                    fail(f"{name}: report differs from {name}_CRISPR_Arrays.txt")
                print(f"  {name}: byte-identical")

    main_path: dict = {}

    @phase("5 planted metagenome through python -m mcaat_tpu_torch")
    def p5():
        from mcaat_tpu_torch.cli import run_cli

        t0 = time.perf_counter()
        meta = make_metagenome(
            seed=7, n_arrays=20, n_spacers=30, background_len=10_000_000,
            background_coverage=8.0, coverage=35.0,
        )
        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_")
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, meta["reads"])
        n_reads = len(meta["reads"])
        print(f"  generated {n_reads} reads in {time.perf_counter() - t0:.1f}s")

        # record the kernel's main-path inputs (the count stays the
        # wrapper's own)
        seen: list = []
        with lcs_run(lcs_cuda, seen) as lcs:
            result, _text, wall = quiet_cli(run_cli, [
                "--input-files", fq, "--output-folder", os.path.join(tmp, "out"),
                "--mesh", "off",
            ], "cli.log")
        launches = lcs["launches"]
        print("  CLI console output: build/chip_smoke/cli.log")
        # the profiler resets the peak at every stage boundary: the run's
        # peak is the largest stage peak
        peak = result.profile.peak_device_mb() * 2**20
        nodes = next(s.counters["nodes"] for s in result.profile.stages if s.name == "graph_build")
        arrays, spacers, found = recovery(meta, result.report_text)
        print("  stage timings:")
        print(result.profile.report())
        print(
            f"  reads {n_reads}, graph nodes {nodes}, wall {wall:.2f}s, "
            f"{n_reads / wall:.0f} reads/s, peak device memory "
            f"{peak / 2**30:.2f} GiB ({card})"
        )
        print(
            f"  arrays reported {arrays}/{len(meta['arrays'])}, spacers "
            f"recovered {found}/{len(spacers)}, LCS launches {launches} "
            f"(batch sizes {[int(x[0].shape[0]) for x in seen]})"
        )
        if nodes < 2_000_000:
            fail(f"only {nodes} graph nodes; the smoke needs at least 2M")
        if arrays != len(meta["arrays"]):
            fail(f"{len(meta['arrays']) - arrays} planted arrays not reported")
        if found < 0.98 * len(spacers):
            fail(f"only {found}/{len(spacers)} planted spacers recovered")
        if launches == 0:
            fail("the main path never launched the LCS kernel")
        main_path.update(launches=launches, seen=seen, fq=fq)
        scratch.append(tmp)

    @phase("6 LCS kernel vs plain torch on the main path's inputs")
    def p6():
        seen = main_path["seen"]
        for inputs in seen:
            err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, inputs)
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        big = max(seen, key=lambda x: x[0].shape[0])
        stats["batch"] = int(big[0].shape[0])
        stats["ms"] = cuda_ms(lambda: lcs_cuda.lcs_ratio_cuda(*big), 50)
        stats["plain_ms"] = cuda_ms(lambda: lcs_ratio_plain(*big), 10)
        print(
            f"  {len(seen)} main-path batches equal; largest B={stats['batch']}: "
            f"kernel {stats['ms']:.4f} ms, plain {stats['plain_ms']:.4f} ms ({card})"
        )

    big: dict = {}

    @phase("7 the chunked build at about 495M windows, single pass vs parts")
    def p7():
        from mcaat_tpu_torch.graph import dbg
        from mcaat_tpu_torch.io.fastq import read_encoded_batch
        from mcaat_tpu_torch.kmer import count as kcount

        t0 = time.perf_counter()
        meta = make_metagenome(
            seed=7, n_arrays=20, n_spacers=30, background_len=40_000_000,
            background_coverage=8.0, coverage=35.0,
        )
        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_big_")
        scratch.append(tmp)
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, meta["reads"])
        n_reads = len(meta["reads"])
        del meta["reads"]
        big.update(meta=meta, fq=fq, tmp=tmp, n_reads=n_reads)
        batch = read_encoded_batch(fq)
        R, L = batch.codes.shape
        n_windows = R * (min(L, int(batch.lengths.max())) - 23) * 2
        big["n_windows"] = n_windows
        print(f"  {n_reads} reads, {n_windows} windows, generated in "
              f"{time.perf_counter() - t0:.1f}s")

        def timed_build(**kw):
            eps: dict = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            g = dbg.build_dbg_from_reads(
                batch.codes, batch.lengths, endpoints_out=eps, device=device, **kw
            )
            torch.cuda.synchronize()
            return g, eps, time.perf_counter() - t1, torch.cuda.max_memory_allocated() - base

        one, eps1, s1, peak1 = timed_build(chunk_windows=0)
        chunk_windows = n_windows // 4
        counts: dict = {}
        budgets = kcount.DEVICE_PARTS_BUDGET, dbg.ADJ_SINGLE_SHOT_MAX_EDGES
        # small, so parts go to the host and the adjacency goes in chunks
        kcount.DEVICE_PARTS_BUDGET = 256 << 20
        dbg.ADJ_SINGLE_SHOT_MAX_EDGES = 16_000_000
        try:
            with counting(kcount, "_count_edge_part", counts), \
                    counting(kcount, "_spill", counts), \
                    counting(dbg, "_adjacency_scatter_chunk", counts):
                parted, eps2, s2, peak2 = timed_build(chunk_windows=chunk_windows, verbose=True)
        finally:
            kcount.DEVICE_PARTS_BUDGET, dbg.ADJ_SINGLE_SHOT_MAX_EDGES = budgets
        for f in ("kmers", "mult", "out", "in_", "valid"):
            if not torch.equal(getattr(parted, f), getattr(one, f)):
                fail(f"the parted build's {f} differs from the single pass")
        for key in ("first_km", "last_km"):
            if not torch.equal(eps1[key], eps2[key]):
                fail(f"the parted build's {key} differs from the single pass")
        parts, spills, passes = (
            counts["_count_edge_part"], counts["_spill"], counts["_adjacency_scatter_chunk"]
        )
        print(
            f"  graph: {one.size} nodes, {int((one.out >= 0).sum())} edges; equal "
            f"element for element (kmers, mult, out, in_, valid, endpoints)"
        )
        print(f"  single pass: {s1:.2f}s, device peak {peak1 / 2**30:.2f} GiB ({card})")
        print(
            f"  {parts} parts of at most {chunk_windows} windows, {spills} host "
            f"spills, {passes} adjacency passes: {s2:.2f}s, device peak "
            f"{peak2 / 2**30:.2f} GiB ({card})"
        )
        big.update(single_s=s1, single_peak=peak1, parted_s=s2, parted_peak=peak2)
        if parts < 4 or spills < 1 or passes < 2:
            fail(f"the parted build ran {parts} parts, {spills} spills, {passes} passes")
        if peak2 > 0.6 * peak1:
            fail("the parted build's peak is not well under the single pass's")

    @phase("8 the same input through python -m mcaat_tpu_torch, in parts and in one pass")
    def p8():
        from mcaat_tpu_torch.cli import run_cli
        from mcaat_tpu_torch.graph import dbg
        from mcaat_tpu_torch.kmer import count as kcount

        fq, tmp, meta = big["fq"], big["tmp"], big["meta"]
        # --ram scales the window budget against 80 GB: this value leaves
        # about a quarter of the input's windows per part
        ram = max(80.0 * big["n_windows"] / 4 / dbg.SINGLE_PASS_MAX_WINDOWS, 1.0)
        runs = {}
        for name, extra in (("parted", ["--ram", f"{ram:.3f}G"]), ("single", [])):
            counts: dict = {}
            seen: list = []
            with counting(kcount, "_count_edge_part", counts), \
                    lcs_run(lcs_cuda, seen if name == "parted" else None) as lcs:
                result, _text, wall = quiet_cli(run_cli, [
                    "--input-files", fq, "--output-folder", os.path.join(tmp, name),
                    "--mesh", "off", *extra,
                ], f"cli_{name}.log")
            report = open(os.path.join(tmp, name, "CRISPR_Arrays.txt"), "rb").read()
            runs[name] = (report, counts["_count_edge_part"], lcs["launches"], wall, result)
            arrays, spacers, found = recovery(meta, result.report_text)
            print(
                f"  {name}: {counts['_count_edge_part']} part(s), wall {wall:.2f}s, "
                f"{big['n_reads'] / wall:.0f} reads/s, arrays {arrays}/{len(meta['arrays'])}, "
                f"spacers {found}/{len(spacers)}, LCS launches {lcs['launches']} ({card})"
            )
            print(result.profile.report())
            if arrays != len(meta["arrays"]) or found < 0.98 * len(spacers):
                fail(f"{name}: {arrays} arrays, {found}/{len(spacers)} spacers")
            if name == "parted":
                for inputs in seen:
                    err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, inputs)
                    stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if runs["parted"][1] < 2 or runs["single"][1] != 1:
            fail(f"--ram {ram:.3f}G gave {runs['parted'][1]} parts, no --ram {runs['single'][1]}")
        if runs["parted"][2] == 0:
            fail("the parted CLI run never launched the LCS kernel")
        if runs["parted"][0] != runs["single"][0]:
            fail("the parted CLI run's CRISPR_Arrays.txt differs from the single pass's")
        print("  CRISPR_Arrays.txt byte-identical; the parted run's LCS inputs equal on the plain version")
        main_path["launches_parted_cli"] = runs["parted"][2]
        big["wall"] = {k: v[3] for k, v in runs.items()}

    @phase("9 --resume on the planted metagenome of phase 5")
    def p9():
        from mcaat_tpu_torch import checkpoint as ckpt
        from mcaat_tpu_torch.cli import run_cli

        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_resume_")
        scratch.append(tmp)
        out = os.path.join(tmp, "out")
        argv = ["--input-files", main_path["fq"], "--output-folder", out,
                "--mesh", "off", "--resume"]
        reports, launches = [], []
        loaded = (
            "Graph loaded from checkpoint:",
            "Cycles loaded from checkpoint:",
            "Reads loaded from checkpoint:",
        )
        for i in range(3):
            if i == 2:
                for f in ("reads.json", "cycles.json"):
                    os.remove(os.path.join(out, "graph", f))
            counts: dict = {}
            with counting(ckpt, "save_graph", counts, timed=True), \
                    counting(ckpt, "load_graph", counts, timed=True), \
                    lcs_run(lcs_cuda) as lcs:
                _r, text, wall = quiet_cli(run_cli, argv, f"cli_resume_{i + 1}.log")
            report_path = os.path.join(out, "CRISPR_Arrays.txt")
            reports.append(open(report_path, "rb").read())
            os.remove(report_path)
            launches.append(lcs["launches"])
            lines = [x for x in loaded if x in text]
            files = sorted(os.listdir(os.path.join(out, "graph")))
            print(
                f"  run {i + 1}: wall {wall:.2f}s; graph saves {counts['save_graph']} in "
                f"{counts['save_graph_s']:.2f}s, loads {counts['load_graph']} in "
                f"{counts['load_graph_s']:.2f}s; loaded lines {len(lines)}; LCS launches "
                f"{lcs['launches']}; artifacts {files} ({card})"
            )
            want = {0: 0, 1: 3, 2: 1}[i]
            if len(lines) != want:
                fail(f"resume run {i + 1} printed {len(lines)} 'loaded from checkpoint' lines")
            if files != ["cycles.json", "graph.npz", "graph_pruned.npz", "reads.json"]:
                fail(f"resume run {i + 1} left {files}")
        sizes = {f: os.path.getsize(os.path.join(out, "graph", f)) for f in files}
        print(f"  artifact bytes {sizes}")
        if reports[1] != reports[0] or reports[2] != reports[0]:
            fail("a resumed run's CRISPR_Arrays.txt differs from the first run's")
        if min(launches) == 0:
            fail(f"a resume run never launched the LCS kernel ({launches})")
        print("  the full and the partial resume are byte-identical")
        main_path["launches_resume"] = launches

    @phase("10 --debug-pipeline through python -m mcaat_tpu_torch")
    def p10():
        import torch_debug_inputs as dinputs  # tests/ is on sys.path

        from mcaat_tpu_torch.cli import run_cli
        from mcaat_tpu_torch.settings import Settings

        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_debug_")
        scratch.append(tmp)

        def debug_cli(files: str, out: str, log_name: str):
            return quiet_cli(run_cli, [
                "--input-files", *files.split(), "--output-folder", out,
                "--mesh", "off", "--debug-pipeline",
            ], log_name)

        with lcs_run(lcs_cuda) as lcs:
            for name in dinputs.NAMES:
                kw = dinputs.settings_kwargs(name, tmp)
                debug_cli(kw["input_files"], kw["output_folder"], f"cli_debug_{name}.log")
                got = dinputs.read_outputs(kw["output_folder"])
                want = dinputs.read_outputs(os.path.join(dinputs.EXPECTED, name))
                for f in dinputs.OUTPUTS:
                    if got[f] != want[f]:
                        fail(f"debug {name}: {f} differs from tests/torch_data/debug/{name}")
                print(f"  {name}: the four outputs equal the JAX-written files")
        if lcs["launches"] == 0:
            fail("the debug runs never launched the LCS kernel")
        # planted-20x30, the input of phase 5
        out = os.path.join(tmp, "planted_20x30")
        seen: list = []
        with lcs_run(lcs_cuda, seen) as lcs20:
            r, _text, wall = debug_cli(main_path["fq"], out, "cli_debug_planted_20x30.log")
        print(f"  planted-20x30: wall {wall:.2f}s, LCS launches {lcs20['launches']} ({card})")
        print(r.profile.report())
        for f in dinputs.OUTPUTS:
            if not os.path.exists(os.path.join(out, f)):
                fail(f"debug planted-20x30 wrote no {f}")
        # the reference histogram: a separate build of phase 5's input,
        # outside every timed run
        g = tpipeline.build_graph_from_settings(Settings(input_files=main_path["fq"]), device=device)
        histogram = tpipeline.multiplicity_histogram(g)
        del g
        hist = "".join(f"Multiplicity {m}: {c} nodes\n" for m, c in histogram)
        if open(os.path.join(out, "node_multiplicities.txt")).read() != hist:
            fail("the debug run's histogram differs from that of phase 5's graph")
        for inputs in seen:
            err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, inputs)
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        print(f"  histogram equal to phase 5's graph's ({len(histogram)} values)")
        main_path["launches_debug"] = lcs["launches"] + lcs20["launches"]

    scratch: list = []
    try:
        p1()
        p2()
        p3()
        p4()
        p5()
        p6()
        p7()
        p8()
        p9()
        p10()
    finally:
        for d in scratch:
            shutil.rmtree(d, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "lcs_ratio",
        "route": "cuda",
        "source": "mcaat_tpu_torch/csrc/lcs.cu",
        "replaces": "mcaat_tpu/report/pallas_dp.py:53",
        "launches": main_path["launches"],
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"],
        "plain_ms": stats["plain_ms"],
        "batch": stats["batch"],
        "ms_1m": stats["ms_1m"],
        "plain_ms_1m": stats["plain_ms_1m"],
        "launches_on_paths": {
            "5 planted CLI": main_path["launches"],
            "8 parted CLI": main_path["launches_parted_cli"],
            "9 resume": main_path["launches_resume"],
            "10 debug": main_path["launches_debug"],
        },
    }]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
