#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mcaat_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels (``mcaat_tpu_torch/csrc/*.cu``: the
   per-pair LCS kernel, the fused ``partial_ratio`` kernel and the
   all-pairs ``ratio_matrix`` kernel) into one library, with the
   registers and spills of each;
3. each kernel against its plain torch version on the card. The per-pair
   kernel: exact equality of LCS and bitwise equality of the ratio over
   batch sizes 1 ... 1M, every length pair in [0, 64]^2, identical and
   empty strings; times of both at 1M pairs. The fused kernel: bitwise
   equality with its plain version and with the expanded route (every
   window cut out on the host and scored by the per-pair kernel) over
   every length pair of {0, 1, 2, 31, 32, 33, 63, 64}^2 with planted
   substrings, tables of 1, 2 and 64 strings, and 1 ... 4097 pairs. The
   all-pairs kernel: bitwise equality with its plain version and with
   the gathered route (the n² pairs laid out as lanes of the per-pair
   kernel) on tables of 1 ... 2,048 strings with lengths over [0, 64],
   NaN for a length of 65, and its times at 1,024 strings (1M pairs);
4. the four golden fixtures of ``tests/data`` through the port on the
   card: byte-identical ``CRISPR_Arrays.txt``;
5. a planted metagenome (20 arrays of 30 spacers in a 10 Mbp background,
   about 0.8M reads; more than 2M graph nodes, so the neighbourhood
   extraction, lazy clip and region condensation branches run) through
   the CLI entry point: every array reported, at least 98% of the
   spacers recovered, the ``ratio_matrix`` and ``partial_ratio`` kernels
   launched on that path, and the seconds of the report stage's parts;
6. the kernels against their plain versions on the inputs the path gave
   them (the per-pair kernel on the gathered pairs of the path's tables),
   and timed on the largest system's: each kernel, its plain version,
   the wall time of ``partial_ratio_pairs`` beside that of the expanded
   route and the wall time of ``pairwise_ratio_matrix`` beside that of
   the gathered route on the same strings;
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

11. the sharded build at full width: the input of phase 5 built with
    ``build_sharded_dbg`` on a mesh of 4 shards on the card and with the
    single-device build; the concatenated k-mers and multiplicities equal
    and both adjacencies equal after mapping ids; rows per shard, seconds,
    device peaks and the exchanged bytes per stage printed;
12. the sharded pipeline through the CLI entry point
    (``MCAAT_TORCH_SHARDS=4``, ``--mesh auto``): report byte-identical to
    phase 5's, every array, at least 98% of the spacers, the pipeline's
    kernels launched and held against their plain versions, stage
    seconds; then
    ``--mesh off``: the same bytes;
13. sharded ``--resume``: a first run writes ``graph_sharded/``,
    ``valid_pruned/``, ``cycles.json`` and ``reads.json``, a second loads
    them all, a third on 2 shards finds the kp mismatch and rebuilds;
    three reports byte-identical to phase 5's; write and load seconds;
14. the process-group path: one process, ``nccl``, world size 1 over a
    ``file://`` store, 4 local shards; ``run_pipeline_multihost`` on a
    golden fixture and on the input of phase 5 gives the golden report
    and phase 5's, byte for byte. This shows that the NCCL calls are well
    formed (types, split sizes), not that two cards talk.

15. the two build engines on the input of phase 5:
    ``build_dbg_from_reads`` with ``engine="join"`` and ``engine="inst"``
    in turns; k-mers, multiplicities, both adjacencies and both endpoint
    tensors equal element for element, seconds and device peak of each;
    ``build_dbg`` on the tables alone (no source ids: the two-sided
    checked join) and the whole build under ``MCAAT_VERIFY_ADJ=1`` (the
    checked destination join) give the same graph; ``device_memory_stats``
    after a profiled build;
16. the direct-call API and the profiling tools: ``map_reads_to_nodes``
    on the first 200,000 reads against ``graph.lookup`` (every window
    hits), ``chains_from_ids`` against ``get_reads`` for phase 5's cycle
    set, ``count_nodes_and_edges`` against a forward-strand build,
    ``lcs_batch`` on CUDA tensors (the per-pair kernel's length output)
    against ``lcs_batch_plain``, a golden fixture inside ``device_trace``
    (the Chrome trace names CUDA kernels), and ``Profiler.to_json`` of
    phase 5's run.

Each path after phase 6 reads its own launch counts (zeroed just before
it) and fails when ``ratio_matrix`` or ``partial_ratio`` is 0; the
kernels' inputs on phases 8, 10 and 12 are held against the plain
versions too. The per-pair kernel serves the public ``ratio_batch`` and
``lcs_batch`` and no pipeline path: phases 3 and 6 launch it, and fail
when they did not, and phase 16 drives ``lcs_batch`` with the counts
zeroed just before and fails when the kernel was not launched. Phase 3
also measures the card's rate of 32-bit integer multiply-adds
(``csrc/int_rate.cu``) and prints it beside ``PEAK_INT_OPS_S``.

``--skip 3,4,7`` leaves phases out while a change is being debugged; such
a run prints no result lines.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their launch counts, errors,
times and bounds. It imports nothing of JAX.
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


def same_bits(what: str, got, want) -> float:
    """Require two float32 tensors to be equal bit for bit; their largest
    absolute difference, which is then 0."""
    import torch

    if got.shape != want.shape or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum()) if got.shape == want.shape else -1
        fail(f"{what} differs bitwise on {bad}/{got.numel()} pairs")
    return float((got - want).abs().max()) if got.numel() else 0.0


def graph_ms(fn, launches: int = 20, replays: int = 50) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured in
    a CUDA graph and replayed, so the host's time to enqueue a launch
    (tens of microseconds through the Python wrapper, more than a small
    kernel runs) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays) / launches


def compare(kernel, plain, inputs) -> float:
    """Run the per-pair kernel and its plain version on the same inputs;
    require exact equality (LCS as integers, ratio bit for bit). Returns
    the largest absolute difference, which must be 0."""
    import torch

    l1, r1 = kernel(*inputs)
    l2, r2 = plain(*inputs)
    torch.cuda.synchronize()
    if not torch.equal(l1, l2):
        bad = int((l1 != l2).sum())
        fail(f"LCS differs from the plain version on {bad}/{l1.numel()} pairs")
    err = same_bits("the ratio against the plain version", r1, r2)
    return max(err, float((l1 - l2).abs().max()) if l1.numel() else 0.0)


def gathered_pairs(codes, lengths) -> list:
    """The n² pairs of a string table as lanes of the per-pair kernel:
    row i against row j at lane i * n + j."""
    import torch

    n = codes.shape[0]
    ii = torch.arange(n, device=codes.device).repeat_interleave(n)
    jj = torch.arange(n, device=codes.device).repeat(n)
    return [codes[ii], lengths[ii], codes[jj], lengths[jj]]


def compare_matrix(lcs_cuda, plain, inputs) -> float:
    """The all-pairs kernel on ``(codes, lengths)`` against its plain
    version and against the gathered route through the per-pair kernel,
    bit for bit."""
    import torch

    n = inputs[0].shape[0]
    got, want = lcs_cuda.ratio_matrix_cuda(*inputs), plain(*inputs)
    per_pair = lcs_cuda.lcs_ratio_cuda(*gathered_pairs(*inputs))[1].view(n, n)
    torch.cuda.synchronize()
    same_bits("ratio_matrix against the gathered per-pair route", got, per_pair)
    return same_bits("ratio_matrix against the plain version", got, want)


def compare_table(kernel, plain, inputs) -> float:
    """The same for the fused partial_ratio kernel and its plain version
    on ``(codes, lengths, s_idx, l_idx)``."""
    import torch

    got, want = kernel(*inputs), plain(*inputs)
    torch.cuda.synchronize()
    return same_bits("partial_ratio against the plain version", got, want)


# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, which counts a
# fused multiply-add as two, so 33.5e12 instructions a second. The integer
# recurrences here are counted in 32-bit integer operations against that
# rate (the data sheet gives none for integers, and theirs is no higher).
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 33.5e12
STEP_OPS = 20  # one step of the recurrence: about 10 operations on 64 bits
MASK_OPS = 8  # building the four match masks, per base of the row string


def bound(n_bytes: float, n_ops: float, int_ops_s: float = PEAK_INT_OPS_S) -> tuple[float, str]:
    """(least milliseconds the card could take, "bytes" or "operations").
    ``int_ops_s`` is the integer rate the operations are held against:
    the assumed peak, or the rate phase 3 measured."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / int_ops_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lcs_ratio_bound(inputs, int_ops_s: float = PEAK_INT_OPS_S) -> tuple[float, str]:
    """Bound of the per-pair kernel on these inputs: both code rows and
    lengths read once and both outputs written once (144 bytes a pair);
    one recurrence step per base of b and the masks of a."""
    _a, la, _b, lb = inputs
    B = int(la.numel())
    return bound(144 * B, STEP_OPS * int(lb.sum()) + MASK_OPS * int(la.sum()), int_ops_s)


def partial_ratio_bound(inputs, int_ops_s: float = PEAK_INT_OPS_S) -> tuple[float, str]:
    """Bound of the fused kernel on these inputs: the table, both index
    vectors and the output once; one recurrence step per base of every
    non-empty window of every pair (what this data needs), and the masks
    of each pair's short string."""
    import torch

    codes, lengths, s_idx, l_idx = inputs
    n, P = int(codes.shape[0]), int(s_idx.numel())
    ls = lengths[s_idx.long()].long()
    ll = lengths[l_idx.long()].long()
    w = torch.arange(127, device=codes.device)[None, :]
    start = w - (ls[:, None] - 1)
    lw = torch.minimum(ll[:, None], start + ls[:, None]) - torch.clamp(start, min=0)
    live = (w < (ls - 1 + torch.clamp(ll, min=1))[:, None]) & (ls[:, None] > 0)
    steps = int(torch.clamp(lw, min=0)[live].sum())
    return bound(68 * n + 12 * P, STEP_OPS * steps + MASK_OPS * int(ls.sum()), int_ops_s)


def ratio_matrix_bound(inputs, int_ops_s: float = PEAK_INT_OPS_S) -> tuple[float, str, float]:
    """Bound of the all-pairs kernel on these inputs, and the same with
    every one of the n² pairs scored. Bytes: the table read once and the
    matrix written once. Operations: ratio(i, j) == ratio(j, i) bit for
    bit, so the function needs the n(n+1)/2 pairs with i <= j only: one
    recurrence step per base of b for each of them (a string is b in
    (n+1)/2 of them, averaged over the table's order) and the masks once
    a string. The second figure counts the steps of all n² pairs, what a
    kernel that mirrors nothing would do."""
    codes, lengths = inputs
    n, bases = int(codes.shape[0]), int(lengths.sum())
    n_bytes = 68 * n + 4 * n * n
    ms, by = bound(n_bytes, STEP_OPS * (n + 1) * bases / 2 + MASK_OPS * bases, int_ops_s)
    return ms, by, bound(n_bytes, STEP_OPS * n * bases + MASK_OPS * bases, int_ops_s)[0]


def random_table(rng, n: int, device):
    """A string table of random 2-bit code rows with lengths over [0, 64];
    a 64-base string first and, where there is room, an empty string and
    a duplicate of the first."""
    import numpy as np
    import torch

    codes = rng.integers(0, 4, (n, 64), dtype=np.uint8)
    lengths = rng.integers(0, 65, n).astype(np.int32)
    lengths[0] = 64
    if n > 2:
        lengths[1] = 0
        codes[2], lengths[2] = codes[0], lengths[0]
    return [torch.as_tensor(codes, device=device), torch.as_tensor(lengths, device=device)]


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


KERNELS = {
    "lcs_ratio": "lcs_ratio_cuda",
    "partial_ratio": "partial_ratio_cuda",
    "ratio_matrix": "ratio_matrix_cuda",
}
PATH_KERNELS = ("partial_ratio", "ratio_matrix")  # what every pipeline path launches


@contextlib.contextmanager
def lcs_run(lcs_cuda, seen: dict | None = None):
    """Zero the launch counts of the kernels for one path and read them
    after; with ``seen``, record each kernel's inputs on that path under
    its name (the counts stay the wrappers' own). Yields a dict whose
    ``launches`` (name -> count) is set on exit."""
    out = {}
    wrappers = {name: getattr(lcs_cuda, fn) for name, fn in KERNELS.items()}

    def recording(name):
        def run(*args):
            seen.setdefault(name, []).append([t.clone() for t in args])
            return wrappers[name](*args)

        return run

    if seen is not None:
        for name, fn in KERNELS.items():
            setattr(lcs_cuda, fn, recording(name))
    lcs_cuda.reset_launch_counts()
    try:
        yield out
    finally:
        out["launches"] = lcs_cuda.launch_counts()
        for name, fn in KERNELS.items():
            setattr(lcs_cuda, fn, wrappers[name])


def need_launches(path: str, launches: dict) -> None:
    """Fail when a kernel of the pipeline was never launched on ``path``."""
    for name in PATH_KERNELS:
        if launches[name] == 0:
            fail(f"{path} never launched the {name} kernel ({launches})")


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
    skip: set = set()
    if len(sys.argv) == 3 and sys.argv[1] == "--skip":
        skip = {int(x) for x in sys.argv[2].split(",")}
    elif len(sys.argv) != 1:
        fail("usage: python3 chip_smoke.py [--skip N,N,...]")
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
        from torch_fuzz_windows import edge_pairs, expanded_partial_ratio, rand_dna
    except ImportError as e:
        fail(f"the repository is not beside chip_smoke.py ({e})")
    os.environ["MCAAT_TORCH_DEVICE"] = "cuda"
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    import numpy as np

    import mcaat_tpu_torch.pipeline as tpipeline
    from mcaat_tpu_torch.report import lcs_cuda
    from mcaat_tpu_torch.report import batched_fuzz as tfuzz
    from mcaat_tpu_torch.report.batched_fuzz import (
        lcs_ratio_plain,
        partial_ratio_table_plain,
        ratio_matrix_plain,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    @phase("1 card")
    def p1():
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")

    @phase("2 build the LCS, partial_ratio and ratio_matrix kernels")
    def p2():
        lcs_cuda.build(verbose_ptxas=True)
        info = lcs_cuda.BUILD_INFO
        print(f"nvcc: {info['seconds']:.2f}s -> {os.path.relpath(info['path'], ROOT)}")
        for line in info["output"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
        for name in KERNELS:
            if f"{name}_kernel" not in info["output"]:
                fail(f"the build's report names no {name}_kernel")

    stats = {"max_abs_err": 0.0}
    int_rate: dict = {}

    def measured_int_rate() -> float:
        """The integer rate phase 3's probe measured (the assumed peak
        while that phase is skipped), for the restated bounds."""
        return int_rate.get("madd_per_s", PEAK_INT_OPS_S)

    pstats = {"max_abs_err": 0.0}
    mstats = {"max_abs_err": 0.0}

    def kernel_ratio(*arrays):
        """Lane ratios of the expanded route: upload, per-pair kernel, download."""
        return lcs_cuda.lcs_ratio_cuda(
            *(torch.as_tensor(x, device=device) for x in arrays)
        )[1].cpu().numpy()

    def check_partial(name: str, shorts, longs, expanded: bool = True):
        """``partial_ratio_pairs`` on the card (the fused kernel) against
        the plain version on the kernel's own inputs and, with
        ``expanded``, against the expanded route through the per-pair
        kernel: all bit for bit."""
        seen: dict = {}
        with lcs_run(lcs_cuda, seen) as run:
            got = tfuzz.partial_ratio_pairs(shorts, longs, device)
        if run["launches"] != {"lcs_ratio": 0, "partial_ratio": 1, "ratio_matrix": 0}:
            fail(f"{name}: partial_ratio_pairs launched {run['launches']}")
        err = compare_table(lcs_cuda.partial_ratio_cuda, partial_ratio_table_plain,
                            seen["partial_ratio"][0])
        if expanded:
            old = expanded_partial_ratio(shorts, longs, kernel_ratio)
            err = max(err, same_bits(f"{name}: partial_ratio against the expanded route",
                                     torch.as_tensor(got), torch.as_tensor(old)))
        pstats["max_abs_err"] = max(pstats["max_abs_err"], err)
        n = seen["partial_ratio"][0][0].shape[0]
        print(f"  partial_ratio {name}: {len(shorts)} pairs over {n} strings equal "
              f"(max abs err {err})")
        return got

    def check_matrix(inputs) -> None:
        err = compare_matrix(lcs_cuda, ratio_matrix_plain, inputs)
        mstats["max_abs_err"] = max(mstats["max_abs_err"], err)

    def gathered_ratio_matrix(strings):
        """The all-pairs matrix by the gathered route: two uploads, the n²
        index pairs and four gathered copies made on the card, the
        per-pair kernel, one copy back."""
        n = len(strings)
        codes, lengths = tfuzz.encode_batch(strings)
        lanes = gathered_pairs(torch.as_tensor(codes, device=device),
                               torch.as_tensor(lengths, device=device))
        return lcs_cuda.lcs_ratio_cuda(*lanes)[1].cpu().numpy().reshape(n, n)

    def need_per_pair(where: str, into: dict) -> None:
        """The per-pair kernel is on no pipeline path: the phases that
        hold it must have launched it since they zeroed the counts."""
        into[where] = lcs_cuda.launch_counts()["lcs_ratio"]
        if into[where] == 0:
            fail(f"{where} never launched the lcs_ratio kernel")

    @phase("3 the kernels vs plain torch on the card")
    def p3():
        lcs_cuda.reset_launch_counts()
        # the integer roof: what the card sustains in independent 32-bit
        # multiply-adds, beside the peak the bounds above assume
        def probe(blocks: int, iters: int):
            out = torch.empty(blocks * lcs_cuda.INT_RATE_THREADS, dtype=torch.int32, device=device)
            return out, lcs_cuda.int_rate_probe(out, blocks, iters)

        small, _n = probe(4, 64)  # held against numpy's wrapping uint32 arithmetic
        x = np.arange(small.numel(), dtype=np.uint32)
        want = np.zeros_like(x)
        for j in range(lcs_cuda.INT_RATE_CHAINS):
            v = x + np.uint32((0x9E3779B9 * (j + 1)) & 0xFFFFFFFF)
            for _ in range(64):
                v = v * np.uint32(1664525) + np.uint32(1013904223)
            want ^= v
        if not np.array_equal(small.cpu().numpy().view(np.uint32), want):
            fail("the integer-rate probe's result differs from numpy's")
        blocks, iters = 132 * 16, 4096
        probe_out, n_madd = probe(blocks, iters)
        ms = min(cuda_ms(lambda: lcs_cuda.int_rate_probe(probe_out, blocks, iters), 10) for _ in range(3))
        int_rate["madd_per_s"] = n_madd / (ms * 1e-3)
        int_rate["ms"], int_rate["madds"] = ms, n_madd
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        int_rate["clocks_sm_now_max"] = clock
        print(
            f"  integer roof: {n_madd} independent 32-bit multiply-adds in {ms:.4f} ms = "
            f"{int_rate['madd_per_s'] / 1e12:.2f}e12 a second measured, beside PEAK_INT_OPS_S = "
            f"{PEAK_INT_OPS_S / 1e12:.1f}e12 assumed ({int_rate['madd_per_s'] / PEAK_INT_OPS_S:.3f} of it; "
            f"SM clock now, max: {clock}) ({card})"
        )
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
        stats["bound_ms_1m"], by = lcs_ratio_bound(big)
        stats["measured_rate_bound_1m"] = lcs_ratio_bound(big, measured_int_rate())
        print(
            f"  1,048,576 pairs: kernel {stats['ms_1m']:.4f} ms, plain "
            f"{stats['plain_ms_1m']:.4f} ms, bound {stats['bound_ms_1m']:.4f} ms by {by} ({card})"
        )
        # the fused kernel
        shorts, longs = edge_pairs(rng)
        got = check_partial("edge lengths, both orders, planted", shorts, longs)
        for a, b, r in zip(shorts, longs, got):
            if a and a in b and r != 100.0:
                fail(f"planted substring scored {r}, not 100")
        for n in (1, 2, 64):
            pool = [rand_dna(rng, int(rng.integers(0, 65))) for _ in range(n)]
            ii, jj = np.arange(300) % n, rng.integers(0, n, 300)
            check_partial(f"table of {n}", [pool[i] for i in ii], [pool[j] for j in jj])
        pool = [rand_dna(rng, int(rng.integers(20, 46))) for _ in range(48)]
        for P in (1, 31, 32, 33, 4097):
            ii, jj = rng.integers(0, 48, P), rng.integers(0, 48, P)
            check_partial(f"P={P}", [pool[i] for i in ii], [pool[j] for j in jj])
        # any row against any row, whichever is longer, and pairs the
        # kernel must refuse: an index outside the table comes back as NaN
        codes = torch.as_tensor(rng.integers(0, 4, (64, 64), dtype=np.uint8), device=device)
        lengths = torch.as_tensor(rng.integers(0, 65, 64).astype(np.int32), device=device)
        s_idx = torch.as_tensor(rng.integers(0, 64, 5000).astype(np.int32), device=device)
        l_idx = torch.as_tensor(rng.integers(0, 64, 5000).astype(np.int32), device=device)
        err = compare_table(lcs_cuda.partial_ratio_cuda, partial_ratio_table_plain,
                            [codes, lengths, s_idx, l_idx])
        pstats["max_abs_err"] = max(pstats["max_abs_err"], err)
        s_idx[7], l_idx[11] = 64, -1
        out = lcs_cuda.partial_ratio_cuda(codes, lengths, s_idx, l_idx)
        nan = torch.isnan(out).nonzero().flatten().tolist()
        if nan != [7, 11]:
            fail(f"out-of-range pairs 7 and 11 should be NaN, got NaN at {nan}")
        print(f"  partial_ratio any row against any row: 5000 pairs equal (max abs err {err}); "
              f"out-of-range indices refused")
        # the all-pairs kernel
        for n in (1, 2, 30, 33, 64, 257, 1024, 2048):
            table = random_table(rng, n, device)
            check_matrix(table)
            print(f"  ratio_matrix table of {n} (runs of {lcs_cuda.matrix_run(n)}): {n * n} pairs "
                  f"equal to the plain version and to the gathered route")
        good = random_table(rng, 33, device)
        want = lcs_cuda.ratio_matrix_cuda(*good)
        good[1][5] = 65
        out = lcs_cuda.ratio_matrix_cuda(*good)
        refused = torch.zeros((33, 33), dtype=torch.bool, device=device)
        refused[5, :] = refused[:, 5] = True
        if not bool(torch.isnan(out[refused]).all()) or bool(torch.isnan(out[~refused]).any()):
            fail("a length of 65 should give NaN in row and column 5 and nowhere else")
        same_bits("ratio_matrix beside a refused string", out[~refused], want[~refused])
        print("  ratio_matrix: a length of 65 gives NaN in its row and column, nothing else changes")
        # 1,024 strings: 1,048,576 pairs, the shape of the per-pair kernel's last row
        table = random_table(rng, 1024, device)
        lanes = gathered_pairs(*table)
        mstats["ms_1m"] = graph_ms(lambda: lcs_cuda.ratio_matrix_cuda(*table))
        mstats["call_ms_1m"] = cuda_ms(lambda: lcs_cuda.ratio_matrix_cuda(*table), 50)
        mstats["gathered_kernel_ms_1m"] = graph_ms(lambda: lcs_cuda.lcs_ratio_cuda(*lanes))
        mstats["plain_ms_1m"] = cuda_ms(lambda: ratio_matrix_plain(*table), 5)
        mstats["bound_ms_1m"], by, mstats["bound_ms_1m_every_pair"] = ratio_matrix_bound(table)
        mstats["measured_rate_bound_1m"] = ratio_matrix_bound(table, measured_int_rate())[:2]
        print(
            f"  1,024 strings, 1,048,576 pairs: ratio_matrix {mstats['ms_1m']:.4f} ms on the card "
            f"(runs of {lcs_cuda.matrix_run(1024)}; {mstats['call_ms_1m']:.4f} ms a call from Python), "
            f"the per-pair kernel on the gathered lanes {mstats['gathered_kernel_ms_1m']:.4f} ms, plain "
            f"{mstats['plain_ms_1m']:.4f} ms, bound {mstats['bound_ms_1m']:.4f} ms by {by} "
            f"({mstats['bound_ms_1m_every_pair']:.4f} ms with all n² pairs scored) ({card})"
        )
        need_per_pair("phase 3", stats.setdefault("launches_in_phases", {}))

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

        # record the kernels' main-path inputs (the counts stay the
        # wrappers' own), the strings of every partial_ratio_pairs call and
        # the seconds of the report stage's parts
        from mcaat_tpu_torch import native
        from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer

        seen: dict = {}
        strings: list = []
        tables: list = []
        parts: dict = {}
        pairs_fn, matrix_fn = tfuzz.partial_ratio_pairs, tfuzz.pairwise_ratio_matrix

        call_ms: dict = {"partial_ratio_pairs": [], "pairwise_ratio_matrix": []}

        def pairs_spy(shorts, longs, dev):
            strings.append((list(shorts), list(longs)))
            t0 = time.perf_counter()
            out = pairs_fn(shorts, longs, dev)
            call_ms["partial_ratio_pairs"].append(1e3 * (time.perf_counter() - t0))
            return out

        def matrix_spy(table, dev):
            tables.append(list(table))
            t0 = time.perf_counter()
            out = matrix_fn(table, dev)
            call_ms["pairwise_ratio_matrix"].append(1e3 * (time.perf_counter() - t0))
            return out

        tfuzz.partial_ratio_pairs = pairs_spy
        tfuzz.pairwise_ratio_matrix = matrix_spy
        try:
            with contextlib.ExitStack() as stack:
                for name in ("find_common_prefix_kmers", "find_common_suffix_kmers",
                             "trim_kmers_from_sequences", "filter_substring_spacers",
                             "validate_spacer_diversity"):
                    stack.enter_context(counting(CRISPRAnalyzer, name, parts))
                stack.enter_context(counting(native, "umap_order", parts))
                stack.enter_context(counting(tfuzz, "partial_ratio_pairs", parts))
                stack.enter_context(counting(tfuzz, "pairwise_ratio_matrix", parts))
                lcs = stack.enter_context(lcs_run(lcs_cuda, seen))
                result, _text, wall = quiet_cli(run_cli, [
                    "--input-files", fq, "--output-folder", os.path.join(tmp, "out"),
                    "--mesh", "off",
                ], "cli.log")
        finally:
            tfuzz.partial_ratio_pairs = pairs_fn
            tfuzz.pairwise_ratio_matrix = matrix_fn
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
            f"recovered {found}/{len(spacers)}, launches {launches}"
        )
        print(
            f"  lcs_ratio batch sizes {[int(x[0].shape[0]) for x in seen.get('lcs_ratio', [])]}; "
            f"ratio_matrix strings {[int(x[0].shape[0]) for x in seen.get('ratio_matrix', [])]}; "
            f"partial_ratio (strings, pairs) "
            f"{[(int(x[0].shape[0]), int(x[2].shape[0])) for x in seen.get('partial_ratio', [])]}"
        )
        report_s = next(s.seconds for s in result.profile.stages if s.name == "report")
        print(f"  report stage {report_s:.3f}s, of which (calls, seconds; nested calls "
              f"count in their callers too) ({card}):")
        for name in [k for k in parts if not k.endswith("_s")]:
            print(f"    {name}: {parts[name]} calls, {parts[name + '_s']:.4f}s")
        # a process's first call of a kernel also loads the library and the
        # kernel's module: the calls after it say what a system costs
        for name, ms in call_ms.items():
            rest = sorted(ms[1:])
            print(f"    {name}: first call {ms[0]:.3f} ms, the {len(rest)} after it "
                  f"{rest[0]:.3f}-{rest[-1]:.3f} ms, median {rest[len(rest) // 2]:.3f} ms")
        if nodes < 2_000_000:
            fail(f"only {nodes} graph nodes; the smoke needs at least 2M")
        if arrays != len(meta["arrays"]):
            fail(f"{len(meta['arrays']) - arrays} planted arrays not reported")
        if found < 0.98 * len(spacers):
            fail(f"only {found}/{len(spacers)} planted spacers recovered")
        need_launches("the main path", launches)
        with open(os.path.join(tmp, "out", "CRISPR_Arrays.txt"), "rb") as fh:
            report = fh.read()
        del meta["reads"]
        main_path.update(launches=launches, seen=seen, fq=fq, strings=strings, tables=tables,
                         call_ms=call_ms,
                         report_s=report_s, wall=wall, report=report, meta=meta,
                         n_reads=n_reads, stages={s.name: s.seconds for s in result.profile.stages},
                         cycles=result.cycles, profile_json=result.profile.to_json(), nodes=nodes)
        scratch.append(tmp)

    def hold_recorded(seen: dict) -> None:
        """The kernels against their plain versions on a path's recorded
        inputs (the all-pairs kernel against the gathered route too)."""
        for inputs in seen.get("lcs_ratio", []):
            err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, inputs)
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        for inputs in seen.get("partial_ratio", []):
            err = compare_table(lcs_cuda.partial_ratio_cuda, partial_ratio_table_plain, inputs)
            pstats["max_abs_err"] = max(pstats["max_abs_err"], err)
        for inputs in seen.get("ratio_matrix", []):
            check_matrix(inputs)

    @phase("6 the kernels vs plain torch on the main path's inputs")
    def p6():
        lcs_cuda.reset_launch_counts()
        seen = main_path["seen"]
        hold_recorded(seen)
        mbig = max(seen["ratio_matrix"], key=lambda x: x[0].shape[0])
        mstats["strings"] = int(mbig[0].shape[0])
        mstats["batch"] = mstats["strings"] ** 2
        mstats["ms"] = graph_ms(lambda: lcs_cuda.ratio_matrix_cuda(*mbig))
        mstats["call_ms"] = cuda_ms(lambda: lcs_cuda.ratio_matrix_cuda(*mbig), 200)
        mstats["plain_ms"] = cuda_ms(lambda: ratio_matrix_plain(*mbig), 10)
        mstats["bound_ms"], mstats["bound_by"], mstats["bound_ms_every_pair"] = ratio_matrix_bound(mbig)
        mstats["measured_rate_bound"] = ratio_matrix_bound(mbig, measured_int_rate())[:2]
        print(
            f"  {len(seen['ratio_matrix'])} main-path ratio_matrix tables equal (plain version and "
            f"gathered route); largest {mstats['strings']} strings, {mstats['batch']} pairs: kernel "
            f"{mstats['ms']:.5f} ms on the card ({mstats['call_ms']:.4f} ms a call from Python), "
            f"plain {mstats['plain_ms']:.4f} ms, bound {mstats['bound_ms']:.6f} ms by "
            f"{mstats['bound_by']} ({mstats['bound_ms_every_pair']:.6f} ms with all n² pairs scored) ({card})"
        )
        # the per-pair kernel on the gathered pairs of every such table, and
        # timed on the largest's
        for inputs in seen["ratio_matrix"]:
            err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, gathered_pairs(*inputs))
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        big = gathered_pairs(*mbig)
        stats["batch"] = int(big[0].shape[0])
        stats["ms"] = graph_ms(lambda: lcs_cuda.lcs_ratio_cuda(*big))
        stats["call_ms"] = cuda_ms(lambda: lcs_cuda.lcs_ratio_cuda(*big), 200)
        stats["plain_ms"] = cuda_ms(lambda: lcs_ratio_plain(*big), 10)
        stats["bound_ms"], stats["bound_by"] = lcs_ratio_bound(big)
        stats["measured_rate_bound"] = lcs_ratio_bound(big, measured_int_rate())
        print(
            f"  lcs_ratio on the gathered pairs of those tables equal; largest "
            f"B={stats['batch']}: kernel {stats['ms']:.5f} ms on the card ({stats['call_ms']:.4f} ms a "
            f"call from Python), plain {stats['plain_ms']:.4f} ms, "
            f"bound {stats['bound_ms']:.6f} ms by {stats['bound_by']} ({card})"
        )
        pbig = max(seen["partial_ratio"], key=lambda x: x[2].shape[0])
        pstats["batch"] = int(pbig[2].shape[0])
        pstats["strings"] = int(pbig[0].shape[0])
        pstats["ms"] = graph_ms(lambda: lcs_cuda.partial_ratio_cuda(*pbig))
        pstats["call_ms"] = cuda_ms(lambda: lcs_cuda.partial_ratio_cuda(*pbig), 200)
        pstats["plain_ms"] = cuda_ms(lambda: partial_ratio_table_plain(*pbig), 10)
        pstats["bound_ms"], pstats["bound_by"] = partial_ratio_bound(pbig)
        pstats["measured_rate_bound"] = partial_ratio_bound(pbig, measured_int_rate())
        print(
            f"  {len(seen['partial_ratio'])} main-path partial_ratio tables equal; largest "
            f"{pstats['strings']} strings, P={pstats['batch']}: kernel {pstats['ms']:.5f} ms on the "
            f"card ({pstats['call_ms']:.4f} ms a call from Python), "
            f"plain {pstats['plain_ms']:.4f} ms, bound {pstats['bound_ms']:.6f} ms by "
            f"{pstats['bound_by']} ({card})"
        )
        # the largest system's strings: partial_ratio_pairs end to end beside
        # the expanded route (host window expansion and per-string encoding,
        # upload, per-pair kernel, host reduction), in turns, best of each
        shorts, longs = max(main_path["strings"], key=lambda x: len(x[0]))
        lanes: dict = {}
        launch = lcs_cuda.lcs_ratio_cuda

        def keep_lanes(*args):
            lanes["inputs"] = [t.clone() for t in args]
            return launch(*args)

        lcs_cuda.lcs_ratio_cuda = keep_lanes
        try:
            old = expanded_partial_ratio(shorts, longs, kernel_ratio)
        finally:
            lcs_cuda.lcs_ratio_cuda = launch
        new = tfuzz.partial_ratio_pairs(shorts, longs, device)
        same_bits("the main path's largest system against the expanded route",
                  torch.as_tensor(new), torch.as_tensor(old))
        walls = {"new": [], "old": []}
        for which in ("old", "new", "new", "old", "old", "new"):
            t0 = time.perf_counter()
            if which == "new":
                tfuzz.partial_ratio_pairs(shorts, longs, device)
            else:
                expanded_partial_ratio(shorts, longs, kernel_ratio)
            walls[which].append(time.perf_counter() - t0)
        old_in = lanes["inputs"]
        pstats["wall_ms"] = 1e3 * min(walls["new"])
        pstats["expanded_wall_ms"] = 1e3 * min(walls["old"])
        pstats["expanded_lanes"] = int(old_in[0].shape[0])
        pstats["expanded_kernel_ms"] = graph_ms(lambda: lcs_cuda.lcs_ratio_cuda(*old_in))
        pstats["expanded_kernel_bound_ms"], by = lcs_ratio_bound(old_in)
        print(
            f"  largest system, {len(shorts)} pairs: partial_ratio_pairs "
            f"{pstats['wall_ms']:.3f} ms wall; the expanded route {pstats['expanded_wall_ms']:.3f} ms "
            f"wall over {pstats['expanded_lanes']} lanes (its per-pair kernel "
            f"{pstats['expanded_kernel_ms']:.5f} ms on the card, bound "
            f"{pstats['expanded_kernel_bound_ms']:.6f} ms by {by}); equal bit for bit ({card})"
        )
        # the same for the all-pairs score of the largest system's spacers
        table = max(main_path["tables"], key=len)
        same_bits("the main path's largest system against the gathered route",
                  torch.as_tensor(tfuzz.pairwise_ratio_matrix(table, device)),
                  torch.as_tensor(gathered_ratio_matrix(table)))
        walls = {"new": [], "old": []}
        for which in ("old", "new", "new", "old", "old", "new"):
            t0 = time.perf_counter()
            if which == "new":
                tfuzz.pairwise_ratio_matrix(table, device)
            else:
                gathered_ratio_matrix(table)
            walls[which].append(time.perf_counter() - t0)
        mstats["wall_ms"] = 1e3 * min(walls["new"])
        mstats["gathered_wall_ms"] = 1e3 * min(walls["old"])
        print(
            f"  largest system, {len(table)} spacers: pairwise_ratio_matrix "
            f"{mstats['wall_ms']:.3f} ms wall; the gathered route {mstats['gathered_wall_ms']:.3f} ms "
            f"wall; equal bit for bit ({card})"
        )
        need_per_pair("phase 6", stats.setdefault("launches_in_phases", {}))

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
            seen: dict = {}
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
                f"spacers {found}/{len(spacers)}, launches {lcs['launches']} ({card})"
            )
            print(result.profile.report())
            if arrays != len(meta["arrays"]) or found < 0.98 * len(spacers):
                fail(f"{name}: {arrays} arrays, {found}/{len(spacers)} spacers")
            need_launches(f"the {name} CLI run", lcs["launches"])
            if name == "parted":
                hold_recorded(seen)
        if runs["parted"][1] < 2 or runs["single"][1] != 1:
            fail(f"--ram {ram:.3f}G gave {runs['parted'][1]} parts, no --ram {runs['single'][1]}")
        if runs["parted"][0] != runs["single"][0]:
            fail("the parted CLI run's CRISPR_Arrays.txt differs from the single pass's")
        print("  CRISPR_Arrays.txt byte-identical; the parted run's kernel inputs equal on the plain versions")
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
                f"{counts['load_graph_s']:.2f}s; loaded lines {len(lines)}; launches "
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
        for i, counts in enumerate(launches):
            need_launches(f"resume run {i + 1}", counts)
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
        need_launches("the debug runs", lcs["launches"])
        # planted-20x30, the input of phase 5
        out = os.path.join(tmp, "planted_20x30")
        seen: dict = {}
        with lcs_run(lcs_cuda, seen) as lcs20:
            r, _text, wall = debug_cli(main_path["fq"], out, "cli_debug_planted_20x30.log")
        print(f"  planted-20x30: wall {wall:.2f}s, launches {lcs20['launches']} ({card})")
        need_launches("the planted debug run", lcs20["launches"])
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
        hold_recorded(seen)
        print(f"  histogram equal to phase 5's graph's ({len(histogram)} values)")
        main_path["launches_debug"] = {
            k: lcs["launches"][k] + lcs20["launches"][k] for k in KERNELS
        }


    @contextlib.contextmanager
    def shards(n: int):
        """``MCAAT_TORCH_SHARDS=n`` for one path: the default mesh then
        has n shards on the card."""
        old = os.environ.get("MCAAT_TORCH_SHARDS")
        os.environ["MCAAT_TORCH_SHARDS"] = str(n)
        try:
            yield
        finally:
            if old is None:
                del os.environ["MCAAT_TORCH_SHARDS"]
            else:
                os.environ["MCAAT_TORCH_SHARDS"] = old

    def check_planted(path: str, report: bytes, launches: dict) -> None:
        """A planted-20x30 report: phase 5's bytes, every array, at least
        98% of the spacers, the pipeline's kernels launched."""
        meta = main_path["meta"]
        arrays, spacers, found = recovery(meta, report.decode())
        print(f"  {path}: arrays {arrays}/{len(meta['arrays'])}, spacers "
              f"{found}/{len(spacers)}, launches {launches}")
        if arrays != len(meta["arrays"]) or found < 0.98 * len(spacers):
            fail(f"{path}: {arrays} arrays, {found}/{len(spacers)} spacers")
        if report != main_path["report"]:
            fail(f"{path}: CRISPR_Arrays.txt differs from phase 5's")
        need_launches(path, launches)

    def wire_line(snap: dict) -> str:
        return ", ".join(
            f"{k} {v['bytes'] / 1e6:.1f} MB in {v['calls']}" for k, v in snap.items()
        )

    @phase("11 the sharded build at full width, 4 shards on the card vs one device")
    def p11():
        from mcaat_tpu_torch.graph import dbg
        from mcaat_tpu_torch.io.fastq import read_encoded_batch
        from mcaat_tpu_torch.parallel.sharded import make_pipeline_mesh
        from mcaat_tpu_torch.parallel.sharded_graph import build_sharded_dbg
        from mcaat_tpu_torch.utils import wire

        batch = read_encoded_batch(main_path["fq"])

        def timed(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g = fn()
            torch.cuda.synchronize()
            return g, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

        one, s1, peak1 = timed(
            lambda: dbg.build_dbg_from_reads(batch.codes, batch.lengths, device=device)
        )
        mesh = make_pipeline_mesh([device] * 4)
        wire.reset()
        sg, s4, peak4 = timed(
            lambda: build_sharded_dbg(mesh, batch.codes, batch.lengths, add_rc=True)
        )
        snap = wire.snapshot()
        if not torch.equal(torch.cat(sg.kmers), one.kmers):
            fail("the sharded build's k-mers differ from the single-device build's")
        if not torch.equal(torch.cat(sg.mult), one.mult):
            fail("the sharded build's multiplicities differ")
        offs = torch.as_tensor(
            np.concatenate([[0], np.cumsum(sg.n_live)]), device=device
        )

        def compact(adj):  # global id shard*T + local -> rank over all rows
            a = torch.cat(adj).to(torch.int64)
            s = torch.clamp(a, min=0) // sg.T
            return torch.where(a >= 0, a - s * sg.T + offs[s], -1).to(torch.int32)

        for name, mine, ref in (("out", sg.out, one.out), ("in_", sg.in_, one.in_)):
            if not torch.equal(compact(mine), ref):
                fail(f"the sharded build's {name}-adjacency differs after mapping ids")
        print(f"  graph: {sg.n_nodes} nodes, {int((one.out >= 0).sum())} edges; k-mers, "
              f"multiplicities and both adjacencies equal; rows per shard "
              f"{sg.n_live.tolist()}, T={sg.T}, {sg.n_parts} part(s)")
        print(f"  single device: {s1:.2f}s, device peak {peak1 / 2**30:.2f} GiB; 4 shards: "
              f"{s4:.2f}s, device peak {peak4 / 2**30:.2f} GiB ({card})")
        print(f"  exchanged: {wire_line(snap)}")
        if sg.n_nodes != one.size or len(sg.n_live) != 4 or int(sg.n_live.min()) == 0:
            fail(f"the sharded build has {sg.n_nodes} nodes in {sg.n_live.tolist()}")
        sharded.update(build_s=s4, build_peak=peak4, single_build_s=s1,
                       single_build_peak=peak1, wire_build=snap, n_live=sg.n_live.tolist())

    @phase("12 the sharded pipeline through python -m mcaat_tpu_torch, 4 shards on the card")
    def p12():
        from mcaat_tpu_torch.cli import run_cli
        from mcaat_tpu_torch.utils import wire

        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_sharded_")
        scratch.append(tmp)
        with shards(4):
            for name, mesh_arg in (("sharded", "auto"), ("mesh_off", "off")):
                seen: dict = {}
                wire.reset()
                with lcs_run(lcs_cuda, seen) as lcs:
                    result, text, wall = quiet_cli(run_cli, [
                        "--input-files", main_path["fq"], "--output-folder",
                        os.path.join(tmp, name), "--mesh", mesh_arg,
                    ], f"cli_{name}.log")
                snap = wire.snapshot()
                with open(os.path.join(tmp, name, "CRISPR_Arrays.txt"), "rb") as fh:
                    report = fh.read()
                check_planted(f"--mesh {mesh_arg}", report, lcs["launches"])
                hold_recorded(seen)
                print(f"  --mesh {mesh_arg}: wall {wall:.2f}s, "
                      f"{main_path['n_reads'] / wall:.0f} reads/s ({card})")
                print(result.profile.report())
                if name == "sharded":
                    if "Graph built (sharded over" not in text or not snap:
                        fail("--mesh auto with 4 shards did not take the sharded path")
                    print(f"  exchanged: {wire_line(snap)}")
                    sharded.update(
                        wall=wall, wire=snap, launches=lcs["launches"],
                        stages={s.name: s.seconds for s in result.profile.stages},
                        peak=result.profile.peak_device_mb(),
                    )
                elif snap:
                    fail(f"--mesh off exchanged {snap}")
        print("  both reports byte-identical to phase 5's; the kernels' inputs equal "
              "on the plain versions")

    @phase("13 sharded --resume: write, load, and a kp mismatch that rebuilds")
    def p13():
        from mcaat_tpu_torch import checkpoint as ckpt
        from mcaat_tpu_torch.cli import run_cli

        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_sresume_")
        scratch.append(tmp)
        out = os.path.join(tmp, "out")
        argv = ["--input-files", main_path["fq"], "--output-folder", out,
                "--mesh", "auto", "--resume"]
        loaded = (
            "Graph loaded from sharded checkpoint:",
            "Cycles loaded from checkpoint:",
            "Reads loaded from checkpoint:",
        )
        launches = []
        for i, (n, want) in enumerate(((4, 0), (4, 3), (2, 0))):
            counts: dict = {}
            with shards(n), \
                    counting(ckpt, "save_sharded_graph", counts, timed=True), \
                    counting(ckpt, "load_sharded_graph", counts, timed=True), \
                    counting(ckpt, "save_sharded_valid", counts, timed=True), \
                    counting(ckpt, "load_sharded_valid", counts, timed=True), \
                    lcs_run(lcs_cuda) as lcs:
                _r, text, wall = quiet_cli(run_cli, argv, f"cli_sresume_{i + 1}.log")
            report_path = os.path.join(out, "CRISPR_Arrays.txt")
            with open(report_path, "rb") as fh:
                report = fh.read()
            os.remove(report_path)
            check_planted(f"sharded resume run {i + 1} ({n} shards)", report, lcs["launches"])
            launches.append(lcs["launches"])
            lines = [x for x in loaded if x in text]
            files = sorted(os.listdir(os.path.join(out, "graph")))
            shard_files = sorted(os.listdir(os.path.join(out, "graph", "graph_sharded")))
            print(
                f"  run {i + 1}: wall {wall:.2f}s; graph saves "
                f"{counts['save_sharded_graph']} in {counts['save_sharded_graph_s']:.2f}s, loads "
                f"{counts['load_sharded_graph']} in {counts['load_sharded_graph_s']:.2f}s; validity "
                f"saves {counts['save_sharded_valid']} in {counts['save_sharded_valid_s']:.2f}s, "
                f"loads {counts['load_sharded_valid']} in {counts['load_sharded_valid_s']:.2f}s; "
                f"loaded lines {len(lines)}; artifacts {files} ({card})"
            )
            if len(lines) != want:
                fail(f"sharded resume run {i + 1} printed {len(lines)} 'loaded' lines, not {want}")
            if files != ["cycles.json", "graph_sharded", "reads.json", "valid_pruned"]:
                fail(f"sharded resume run {i + 1} left {files}")
            if shard_files != ["meta.json"] + [f"shard_{s:04d}.npz" for s in range(n)]:
                fail(f"sharded resume run {i + 1} left {shard_files} in graph_sharded/")
            if i == 2 and "does not fit this mesh" not in text:
                fail("the run on 2 shards did not report the kp mismatch")
            sharded.setdefault("resume_wall", []).append(wall)
        size = sum(
            os.path.getsize(os.path.join(out, "graph", "graph_sharded", f)) for f in shard_files
        )
        print(f"  graph_sharded/ holds {size} bytes on 2 shards; the three reports are "
              f"byte-identical to phase 5's")
        sharded["launches_resume"] = launches

    @phase("14 the process-group path: one process, nccl, 4 local shards")
    def p14():
        import torch.distributed as dist

        from mcaat_tpu_torch.parallel import multihost
        from mcaat_tpu_torch.settings import Settings

        tmp = tempfile.mkdtemp(prefix="mcaat_smoke_group_")
        scratch.append(tmp)
        calls: dict = {}
        with shards(4), counting(dist, "all_to_all_single", calls), \
                counting(dist, "all_gather", calls):
            multihost.initialize_distributed(
                f"file://{os.path.join(tmp, 'store')}", 1, 0, device=device, timeout_s=120
            )
            try:
                if dist.get_backend() != "nccl":
                    fail(f"the process group's backend is {dist.get_backend()}, not nccl")
                data = os.path.join(ROOT, "tests", "data")
                s = Settings(input_files=os.path.join(data, "golden_reads.fq"),
                             output_file=os.path.join(tmp, "golden.txt"))
                r = multihost.run_pipeline_multihost(s, verbose=False, device=device)
                with open(os.path.join(data, "golden_CRISPR_Arrays.txt")) as fh:
                    if r.report_text != fh.read():
                        fail("the process-group run's golden report differs")
                print("  golden: byte-identical")
                s = Settings(input_files=main_path["fq"],
                             output_file=os.path.join(tmp, "planted.txt"))
                stats14: dict = {}
                with lcs_run(lcs_cuda) as lcs:
                    t0 = time.perf_counter()
                    r = multihost.run_pipeline_multihost(
                        s, verbose=False, stats_out=stats14, device=device
                    )
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                dist.destroy_process_group()
        with open(os.path.join(tmp, "planted.txt"), "rb") as fh:
            check_planted("process group", fh.read(), lcs["launches"])
        print(f"  planted-20x30: wall {wall:.2f}s, mesh {stats14['mesh']}, rows per shard "
              f"{stats14['live_rows_per_shard']}, build {stats14['build_wall_s']}s ({card})")
        print(f"  stages {stats14['stages']}")
        print(f"  exchanged: {wire_line(stats14['wire'])}")
        print(f"  torch.distributed calls: all_to_all_single {calls['all_to_all_single']}, "
              f"all_gather {calls['all_gather']}")
        if calls["all_to_all_single"] == 0 or calls["all_gather"] == 0:
            fail("the process-group path made no torch.distributed call")
        print("  this shows that the NCCL calls are well formed (types, split sizes) in a "
              "group of one process; it does not show two cards talking")
        sharded.update(launches_group=lcs["launches"], group_wall=wall)

    engines: dict = {}

    @phase("15 the build engines: join vs inst, the two-sided join, MCAAT_VERIFY_ADJ")
    def p15():
        from mcaat_tpu_torch.graph import dbg
        from mcaat_tpu_torch.io.fastq import read_encoded_batch
        from mcaat_tpu_torch.utils.profiling import Profiler, device_memory_stats

        batch = read_encoded_batch(main_path["fq"])
        engines["batch"] = batch

        def timed_build(**kw):
            eps: dict = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g = dbg.build_dbg_from_reads(
                batch.codes, batch.lengths, endpoints_out=eps, device=device, **kw
            )
            torch.cuda.synchronize()
            return g, eps, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

        def same_graph(what: str, g, ref) -> None:
            for f in ("kmers", "mult", "out", "in_", "valid"):
                a, b = getattr(g, f), getattr(ref, f)
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"{what}: {f} differs")

        if dbg.BUILD_ENGINE != "join":
            fail(f"BUILD_ENGINE is {dbg.BUILD_ENGINE!r}")
        runs: dict = {"join": [], "inst": []}
        ref = ref_eps = None
        for engine in ("join", "inst", "inst", "join"):
            g, eps, s, peak = timed_build(engine=engine)
            runs[engine].append((s, peak))
            if ref is None:
                ref, ref_eps = g, eps
                continue
            same_graph(f"engine={engine} against engine=join", g, ref)
            for key in ("first_km", "last_km"):
                if eps[key].shape[0] != batch.num_reads or not torch.equal(eps[key], ref_eps[key]):
                    fail(f"engine={engine}: {key} differs from engine=join's")
            del g, eps
        n_edges = int((ref.out >= 0).sum())
        print(f"  graph: {ref.size} nodes, {n_edges} edges; engine=inst equals engine=join element "
              f"for element (kmers, mult, out, in_, valid, endpoints), twice")
        for engine in ("join", "inst"):
            print(f"  engine={engine}: " + ", ".join(
                f"{s:.3f}s at {peak / 2**30:.2f} GiB" for s, peak in runs[engine]) + f" ({card})")
        if ref.size != main_path["nodes"]:
            fail(f"the build has {ref.size} nodes, phase 5's had {main_path['nodes']}")
        # build_dbg on the tables alone: the edge table is read off the graph
        # (slot 4v+b holds an edge v.b), no source ids are given, so both
        # endpoints take the checked two-sided join
        slots = torch.nonzero(ref.out >= 0).flatten()
        u24 = (ref.kmers[slots // 4] << 2) | (slots % 4)
        del slots
        counts: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting(dbg, "_join_lookup2", counts), counting(dbg, "_join_lookup1_trusted", counts):
            g2 = dbg.build_dbg(ref.kmers, ref.mult, u24)
        torch.cuda.synchronize()
        s2 = time.perf_counter() - t0
        same_graph("build_dbg without u_id", g2, ref)
        if counts["_join_lookup2"] < 1 or counts["_join_lookup1_trusted"] != 0:
            fail(f"build_dbg without u_id took {counts}")
        # a foreign edge (its suffix is no node) is dropped by that join
        mask23 = (1 << 46) - 1
        cand = (ref.kmers[:4096] << 2) | 3
        foreign = cand[(dbg._lookup(ref.kmers, cand & mask23) < 0)][:1]
        if foreign.numel() != 1:
            fail("no foreign edge found to plant")
        g3 = dbg.build_dbg(ref.kmers, ref.mult, torch.sort(torch.cat([u24, foreign])).values)
        same_graph("build_dbg with a foreign edge", g3, ref)
        del g2, g3, u24
        print(f"  build_dbg(u23, c23, u24) without source ids: equal adjacency, "
              f"{counts['_join_lookup2']} two-sided join(s), {s2:.3f}s; a planted foreign edge is dropped")
        counts = {}
        os.environ["MCAAT_VERIFY_ADJ"] = "1"
        try:
            with counting(dbg, "_join_lookup1", counts), counting(dbg, "_join_lookup1_trusted", counts):
                g4, _eps, s4, peak4 = timed_build(engine="join")
        finally:
            del os.environ["MCAAT_VERIFY_ADJ"]
        same_graph("the build under MCAAT_VERIFY_ADJ=1", g4, ref)
        if counts["_join_lookup1"] < 1 or counts["_join_lookup1_trusted"] != 0:
            fail(f"MCAAT_VERIFY_ADJ=1 took {counts}")
        del g4
        print(f"  MCAAT_VERIFY_ADJ=1: the checked destination join ({counts['_join_lookup1']} call(s)), "
              f"equal graph, {s4:.3f}s at {peak4 / 2**30:.2f} GiB ({card})")
        # device_memory_stats after a profiled build
        prof = Profiler(device)
        with prof.stage("graph_build"):
            g5 = dbg.build_dbg_from_reads(batch.codes, batch.lengths, device=device)
        st = device_memory_stats(device)
        stage_peak = prof.stages[0].device_peak_mb * 2**20
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  device_memory_stats after a profiled build: {st}; the stage's peak "
              f"{stage_peak / 2**30:.2f} GiB")
        if set(st) != {"bytes_in_use", "bytes_limit", "peak_bytes_in_use", "bytes_reserved"}:
            fail(f"device_memory_stats has keys {sorted(st)}")
        if st["bytes_limit"] != total or st["peak_bytes_in_use"] < stage_peak:
            fail("device_memory_stats disagrees with the card's total or the stage's peak")
        if not (st["bytes_reserved"] >= st["bytes_in_use"] > 0):
            fail("device_memory_stats: reserved < in use")
        del g5
        engines.update(graph=ref, runs=runs)

    @phase("16 the direct-call API, lcs_batch on the card, device_trace, Profiler.to_json")
    def p16():
        from mcaat_tpu_torch.io.fastq import ReadBatch
        from mcaat_tpu_torch.graph import dbg
        from mcaat_tpu_torch.kmer import count as kcount
        from mcaat_tpu_torch.pipeline import run_pipeline
        from mcaat_tpu_torch.reads.mapper import chains_from_ids, get_reads, map_reads_to_nodes
        from mcaat_tpu_torch.settings import Settings
        from mcaat_tpu_torch.utils.profiling import device_trace

        graph, batch = engines["graph"], engines["batch"]
        k = graph.k
        sub = ReadBatch(codes=batch.codes[:200_000], lengths=batch.lengths[:200_000])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, n_windows = map_reads_to_nodes(graph, sub)
        s_map = time.perf_counter() - t0
        if ids.dtype != np.int32 or ids.shape != (sub.num_reads, sub.max_len - k + 1):
            fail(f"map_reads_to_nodes gave {ids.dtype} {ids.shape}")
        km = kcount.extract_kmers(torch.as_tensor(sub.codes, device=device),
                                  torch.as_tensor(sub.lengths, device=device), k)
        if not np.array_equal(graph.lookup(km.reshape(-1)).reshape(km.shape).cpu().numpy(), ids):
            fail("map_reads_to_nodes differs from graph.lookup of the same windows")
        del km
        live = np.arange(ids.shape[1])[None, :] < n_windows[:, None]
        if not (ids[live] >= 0).all() or not (ids[~live] == -1).all():
            fail("a window of a read of the build missed the graph")
        print(f"  map_reads_to_nodes: {sub.num_reads} reads, {int(live.sum())} windows, every one a "
              f"hit, equal to graph.lookup; {s_map:.3f}s ({card})")
        cycles = main_path["cycles"]
        cycle_nodes = {int(n) for c in cycles for n in c}
        chains = chains_from_ids(ids, n_windows, sub.lengths, k, cycle_nodes)
        want = get_reads(graph, "first 200,000 reads", None, cycles,
                         batches={"first 200,000 reads": sub})
        if not (np.array_equal(chains.flat, want.flat) and np.array_equal(chains.offsets, want.offsets)):
            fail("chains_from_ids differs from get_reads' chains")
        if len(chains) == 0:
            fail("no read of the first 200,000 was kept")
        print(f"  chains_from_ids: {len(chains)} kept reads over {len(cycle_nodes)} cycle nodes, equal "
              f"to get_reads' chains")
        del ids, chains, want
        # count_nodes_and_edges counts the forward strand: against a build without RC
        fwd = dbg.build_dbg_from_reads(batch.codes, batch.lengths, add_reverse_complement=False,
                                       device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_k, c_k, n_k, u_k1, n_k1 = kcount.count_nodes_and_edges(
            torch.as_tensor(batch.codes, device=device), torch.as_tensor(batch.lengths, device=device), k)
        torch.cuda.synchronize()
        s_cnt = time.perf_counter() - t0
        slots = torch.nonzero(fwd.out >= 0).flatten()
        edges = (fwd.kmers[slots // 4] << 2) | (slots % 4)
        if not (torch.equal(u_k, fwd.kmers) and torch.equal(c_k, fwd.mult) and n_k == fwd.size
                and n_k1 == int(edges.shape[0]) and torch.equal(u_k1, edges)):
            fail("count_nodes_and_edges differs from the forward-strand build's tables")
        print(f"  count_nodes_and_edges: {n_k} nodes, {n_k1} edges, equal to the forward-strand "
              f"build's tables; {s_cnt:.3f}s ({card})")
        del fwd, u_k, c_k, u_k1, slots, edges
        # lcs_batch on the card is the per-pair kernel's length output: this
        # slice's path for that kernel, counts zeroed just before
        grid = length_grid(np.random.default_rng(0), device)
        with lcs_run(lcs_cuda) as run:
            got = tfuzz.lcs_batch(*grid)
            torch.cuda.synchronize()
        engines["launches"] = run["launches"]
        if run["launches"]["lcs_ratio"] < 1:
            fail(f"lcs_batch on CUDA tensors never launched the lcs_ratio kernel ({run['launches']})")
        want = tfuzz.lcs_batch_plain(*grid)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            fail("lcs_batch on the card differs from lcs_batch_plain")
        err = compare(lcs_cuda.lcs_ratio_cuda, lcs_ratio_plain, grid)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        print(f"  lcs_batch on the card: {got.numel()} pairs equal to lcs_batch_plain, launches "
              f"{run['launches']}")
        # a golden fixture inside device_trace
        data = os.path.join(ROOT, "tests", "data")
        trace_dir = os.path.join(ROOT, "build", "chip_smoke", "trace")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with tempfile.TemporaryDirectory() as tmp:
            s = Settings(input_files=os.path.join(data, "golden_reads.fq"),
                         output_file=os.path.join(tmp, "golden.txt"))
            with device_trace(trace_dir) as prof:
                t0 = time.perf_counter()
                r = run_pipeline(s, verbose=False, device=device)
                s_trace = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_pipeline(s, verbose=False, device=device)
            s_plain = time.perf_counter() - t0
        with open(os.path.join(data, "golden_CRISPR_Arrays.txt")) as fh:
            if r.report_text != fh.read():
                fail("the traced golden run's report differs")
        files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if len(files) != 1:
            fail(f"device_trace wrote {files}")
        with open(os.path.join(trace_dir, files[0])) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            fail("the trace names no CUDA kernel (is CUPTI missing?)")
        busy_us = sum(e.get("dur", 0) for e in kernels)
        by_name: dict = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0) + e.get("dur", 0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        print(f"  device_trace on a golden fixture: {len(events)} events, {len(kernels)} CUDA kernel "
              f"launches of {len(by_name)} kernels, {busy_us / 1e3:.2f} ms of kernel time in a "
              f"{s_trace:.2f}s run ({s_plain:.2f}s untraced); trace "
              f"{os.path.relpath(os.path.join(trace_dir, files[0]), ROOT)}; report byte-identical")
        for name, us in top:
            print(f"    {us / 1e3:8.3f} ms  {name[:100]}")
        if not any(k.key.startswith("aten::") for k in prof.key_averages()):
            fail("the profiler's key_averages hold no aten operation")
        # Profiler.to_json of phase 5's run
        stages = json.loads(main_path["profile_json"])
        names = [st["name"] for st in stages]
        if names != ["graph_build", "cycle_search", "read_mapping", "spacer_ordering", "report"]:
            fail(f"Profiler.to_json has the stages {names}")
        for st in stages:
            if set(st) != {"name", "seconds", "counters", "rss_mb", "device_peak_mb"}:
                fail(f"a stage of Profiler.to_json has the keys {sorted(st)}")
            if not (st["seconds"] > 0 and st["rss_mb"] > 0 and st["device_peak_mb"] is not None):
                fail(f"stage {st['name']} of Profiler.to_json is empty: {st}")
        counters = {st["name"]: st["counters"] for st in stages}
        if counters["graph_build"].get("nodes") != main_path["nodes"] or not (
                counters["cycle_search"].get("start_nodes", 0) > 0
                and counters["read_mapping"].get("reads", 0) > 0
                and counters["spacer_ordering"].get("systems", 0) > 0):
            fail(f"Profiler.to_json lost counters: {counters}")
        print(f"  Profiler.to_json of phase 5's run: {counters}; host RSS at stage ends "
              f"{[st['rss_mb'] for st in stages]} MB")
        engines.pop("graph")
        engines.pop("batch")

    scratch: list = []
    sharded: dict = {}
    phases = [p1, p2, p3, p4, p5, p6, p7, p8, p9, p10, p11, p12, p13, p14, p15, p16]
    try:
        for i, run in enumerate(phases, start=1):
            if i not in skip:
                run()
    finally:
        for d in scratch:
            shutil.rmtree(d, ignore_errors=True)
    if skip:
        print(f"phases {sorted(skip)} skipped: no result lines")
        return 0
    print(card)

    def on_paths(name: str) -> dict:
        return {
            "5 planted CLI": main_path["launches"][name],
            "8 parted CLI": main_path["launches_parted_cli"][name],
            "9 resume": [r[name] for r in main_path["launches_resume"]],
            "10 debug": main_path["launches_debug"][name],
            "12 sharded CLI": sharded["launches"][name],
            "13 sharded resume": [r[name] for r in sharded["launches_resume"]],
            "14 process group": sharded["launches_group"][name],
            "16 direct API": engines["launches"][name],
        }

    # no PyTorch call computes an LCS, a ratio or a partial_ratio: library_ms is null
    common = {"route": "cuda", "replaces": "mcaat_tpu/report/pallas_dp.py:53", "library_ms": None}
    print(json.dumps({"kernels": [
        {
            "name": "lcs_ratio",
            "source": "mcaat_tpu_torch/csrc/lcs.cu",
            **common,
            # no pipeline path launches the per-pair kernel; its path is the
            # public lcs_batch/ratio_batch, driven by phase 16
            "launches": engines["launches"]["lcs_ratio"],
            "max_abs_err": stats["max_abs_err"],
            "ms": stats["ms"],
            "call_ms": stats["call_ms"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"],
            "batch": stats["batch"],
            "ms_1m": stats["ms_1m"],
            "plain_ms_1m": stats["plain_ms_1m"],
            "bound_ms_1m": stats["bound_ms_1m"],
            "measured_rate_bound": stats["measured_rate_bound"],
            "measured_rate_bound_1m": stats["measured_rate_bound_1m"],
            "launches_in_phases": stats["launches_in_phases"],
            "launches_on_paths": on_paths("lcs_ratio"),
        },
        {
            "name": "partial_ratio",
            "source": "mcaat_tpu_torch/csrc/partial_ratio.cu",
            **common,
            "launches": main_path["launches"]["partial_ratio"],
            "max_abs_err": pstats["max_abs_err"],
            "ms": pstats["ms"],
            "call_ms": pstats["call_ms"],
            "plain_ms": pstats["plain_ms"],
            "bound_ms": pstats["bound_ms"],
            "bound_by": pstats["bound_by"],
            "batch": pstats["batch"],
            "strings": pstats["strings"],
            "wall_ms": pstats["wall_ms"],
            "expanded_wall_ms": pstats["expanded_wall_ms"],
            "expanded_lanes": pstats["expanded_lanes"],
            "expanded_kernel_ms": pstats["expanded_kernel_ms"],
            "expanded_kernel_bound_ms": pstats["expanded_kernel_bound_ms"],
            "measured_rate_bound": pstats["measured_rate_bound"],
            "launches_on_paths": on_paths("partial_ratio"),
        },
        {
            "name": "ratio_matrix",
            "source": "mcaat_tpu_torch/csrc/ratio_matrix.cu",
            **common,
            "launches": main_path["launches"]["ratio_matrix"],
            "max_abs_err": mstats["max_abs_err"],
            "ms": mstats["ms"],
            "call_ms": mstats["call_ms"],
            "plain_ms": mstats["plain_ms"],
            "bound_ms": mstats["bound_ms"],
            "bound_by": mstats["bound_by"],
            "batch": mstats["batch"],
            "strings": mstats["strings"],
            "wall_ms": mstats["wall_ms"],
            "gathered_wall_ms": mstats["gathered_wall_ms"],
            "ms_1m": mstats["ms_1m"],
            "call_ms_1m": mstats["call_ms_1m"],
            "gathered_kernel_ms_1m": mstats["gathered_kernel_ms_1m"],
            "plain_ms_1m": mstats["plain_ms_1m"],
            "bound_ms_1m": mstats["bound_ms_1m"],
            "bound_ms_every_pair": mstats["bound_ms_every_pair"],
            "bound_ms_1m_every_pair": mstats["bound_ms_1m_every_pair"],
            "measured_rate_bound": mstats["measured_rate_bound"],
            "measured_rate_bound_1m": mstats["measured_rate_bound_1m"],
            "launches_on_paths": on_paths("ratio_matrix"),
        },
    ], "planted_20x30": {"report_s": main_path["report_s"], "wall_s": main_path["wall"],
                         "report_call_ms": main_path["call_ms"],
                         "stages_s": main_path["stages"]},
        "int_rate": {**int_rate, "assumed_peak_per_s": PEAK_INT_OPS_S},
        "build_engines_planted_20x30": {
            e: [{"seconds": sec, "peak_bytes": pk} for sec, pk in engines["runs"][e]]
            for e in ("join", "inst")},
        "planted_20x30_4_shards": {k: sharded[k] for k in (
            "wall", "stages", "peak", "wire", "build_s", "build_peak", "single_build_s",
            "single_build_peak", "wire_build", "n_live", "resume_wall", "group_wall")}}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
