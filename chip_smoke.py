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
   it.

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
        from mcaat_tpu_torch.io.fastq import reverse_complement

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
        seen = []
        launch = lcs_cuda.lcs_ratio_cuda

        def recording(*args):
            seen.append([t.clone() for t in args])
            return launch(*args)

        lcs_cuda.lcs_ratio_cuda = recording
        cli_out = io.StringIO()
        lcs_cuda.LAUNCHES = 0
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(cli_out):
            result = run_cli([
                "--input-files", fq, "--output-folder", os.path.join(tmp, "out"),
                "--mesh", "off",
            ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = lcs_cuda.LAUNCHES
        lcs_cuda.lcs_ratio_cuda = launch
        # the CLI's console output is long (every found array); keep it
        # beside the run instead of in the tail of this script's output
        log = os.path.join(ROOT, "build", "chip_smoke", "cli.log")
        os.makedirs(os.path.dirname(log), exist_ok=True)
        with open(log, "w") as fh:
            fh.write(cli_out.getvalue())
        print(f"  CLI console output: {os.path.relpath(log, ROOT)}")
        # the profiler resets the peak at every stage boundary: the run's
        # peak is the largest stage peak
        peak = result.profile.peak_device_mb() * 2**20 if result else 0.0
        if result is None:
            fail("the CLI refused the settings")
        nodes = next(s.counters["nodes"] for s in result.profile.stages if s.name == "graph_build")
        rep = result.report_text
        arrays = sum(
            1 for a in meta["arrays"]
            if a["repeat"][:-1] in rep or reverse_complement(a["repeat"])[:-1] in rep
        )
        spacers = [s for a in meta["arrays"] for s in a["spacers"]]
        found = sum(
            1 for s in spacers if s[6:-6] in rep or reverse_complement(s[6:-6]) in rep
        )
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
        main_path.update(launches=launches, seen=seen)
        shutil.rmtree(tmp, ignore_errors=True)

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

    p1()
    p2()
    p3()
    p4()
    p5()
    p6()
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
    }]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
