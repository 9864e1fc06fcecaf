"""The sharded pipeline of the torch port on a graph that no single card
holds: planted-20x30 with only its background grown.

Usage:  python3 scripts/torch_sharded_past_ceiling.py BACKGROUND_LEN --cards N
            [--device cuda|cpu] [--arrays A] [--json PATH] [--logs DIR]

The input is ``make_metagenome(seed=7, n_arrays=20, n_spacers=30,
background_len=BACKGROUND_LEN, background_coverage=8.0, coverage=35.0)``:
20 arrays of 30 spacers (the batched report runs), 100 bp reads, about
two graph nodes a background base (the reverse strand doubles them), so
350,000,000 gives about 700M nodes and 500,000,000 about 1.0B. It is
written once as FASTQ and run, in order:

1. one process over the first N cards through the CLI entry point
   (``--mesh auto``, one shard a card);
2. N processes of one card each through the CLI entry point, joined by
   ``MCAAT_COORDINATOR`` / ``MCAAT_NUM_PROCESSES`` / ``MCAAT_PROCESS_ID``
   (NCCL); every shard's k-mers and multiplicities must have run 1's
   SHA-1, the whole k-mer column the digest of ``run_pipeline_multihost``'s
   ``stats_out`` (SHA-1 fed shard by shard equals SHA-1 of the
   concatenation), and the report run 1's bytes;
3. an independent count of the node table on one card, one owner range
   (``parallel/sharded.py::kmer_bounds``) at a time: the reads' 23-mers
   and their reverse complements, filtered to the range and counted in
   row parts with the single-device ``count_unique`` and merge stack;
   each range must equal run 1's shard (rows, k-mers, multiplicities);
4. one ``--mesh off`` run on one card (beside run 3, on another card):
   when it runs out of memory, the stage and the bytes asked for are
   printed; when it passes, its report must equal runs 1 and 2.

Printed for each run: nodes, live rows per shard, ``T`` and its margin
under the int32 id range, count parts, every card's peak, host RSS, stage
seconds, bytes exchanged per stage (``utils/wire``), systems and spacers
recovered, and the launches of the report kernels, whose inputs on the
path are held against their plain versions (max abs err). The card's
name and power limit head the output. Any difference exits non-zero.

``--device cpu`` with a small background (a few hundred kbp) rehearses
the control flow without a card: run 1 takes ``MCAAT_TORCH_SHARDS=N``
CPU shards, run 2 N gloo processes (``--arrays 2`` makes it faster; the
report kernels' 30-spacer systems stay). The default device is the card, and
fewer than N cards is an error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "scripts"))

K = 23
TIMEOUT_S = 600  # seconds a collective may wait before the group fails
RANGE_PART_ROWS = 4_000_000  # reads a part of the range count (about 25 GB at its peak)
CEILING_NODES = 620_000_000  # the single-device path ran out of memory at about this many (PERF.md)
STATS = "PAST_CEILING_STATS "


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("background_len", type=int)
    ap.add_argument("--cards", type=int, required=True)
    ap.add_argument("--arrays", type=int, default=20,
                    help="planted arrays (20; fewer only to rehearse faster)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", help="write every figure to this file")
    ap.add_argument("--logs", help="keep the runs' console logs in this directory")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--fastq", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def card_lines(device: str) -> list[str]:
    if device != "cuda":
        return ["cpu (no device figures)"]
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


# ---------------------------------------------------------------------------
# What the children measure
# ---------------------------------------------------------------------------


def shard_digests(sg) -> dict:
    """SHA-1 (16 hex digits) of every local primary shard's k-mers (int64)
    and multiplicities (int32), fetched one shard at a time, keyed by kp
    shard; ``kmers_all`` is SHA-1 of the whole k-mer column fed in shard
    order, when this process holds every shard."""
    import numpy as np

    mesh = sg.mesh
    out, whole = {}, hashlib.sha1()
    for i in sorted(mesh.primary, key=lambda i: mesh.local_kp[i]):
        km = np.ascontiguousarray(sg.kmers[i].cpu().numpy(), dtype=np.int64)
        mu = np.ascontiguousarray(sg.mult[i].cpu().numpy(), dtype=np.int32)
        whole.update(km)
        out[str(mesh.local_kp[i])] = {
            "rows": int(km.size),
            "kmers": hashlib.sha1(km).hexdigest()[:16],
            "mult": hashlib.sha1(mu).hexdigest()[:16],
        }
        del km, mu
    res = {"shards": out}
    if len(out) == mesh.kp:
        res["kmers_all"] = whole.hexdigest()[:16]
    return res


def _recorded_kernels(seen: dict, device) -> dict:
    """Each report kernel against its plain version on the inputs the path
    gave it: ``{name: {"calls", "max_abs_err"}}``; a bit that differs is
    an error (``inf``)."""
    import torch

    from mcaat_tpu_torch.report.batched_fuzz import partial_ratio_table_plain, ratio_matrix_plain

    out = {}
    if device.type != "cuda":
        return out
    from mcaat_tpu_torch.report import lcs_cuda

    pairs = {
        "partial_ratio": (lcs_cuda.partial_ratio_cuda, partial_ratio_table_plain),
        "ratio_matrix": (lcs_cuda.ratio_matrix_cuda, ratio_matrix_plain),
    }
    for name, (kernel, plain) in pairs.items():
        err = 0.0
        for inputs in seen.get(name, []):
            got, want = kernel(*inputs), plain(*inputs)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(
                got.view(torch.int32), want.view(torch.int32)
            ):
                err = float("inf")
            elif got.numel():
                err = max(err, float((got - want).abs().max()))
        out[name] = {"calls": len(seen.get(name, [])), "max_abs_err": err}
    return out


class _KernelWatch:
    """Zero the report kernels' launch counts and record their inputs
    over one run (on a card); the counts stay the wrappers' own."""

    NAMES = {"partial_ratio": "partial_ratio_cuda", "ratio_matrix": "ratio_matrix_cuda"}

    def __init__(self, device):
        self.device = device
        self.seen: dict = {}
        self.launches: dict = {}

    def __enter__(self):
        if self.device.type != "cuda":
            return self
        from mcaat_tpu_torch.report import lcs_cuda

        self._orig = {fn: getattr(lcs_cuda, fn) for fn in self.NAMES.values()}
        for name, fn in self.NAMES.items():
            setattr(lcs_cuda, fn, self._recording(name, self._orig[fn]))
        lcs_cuda.reset_launch_counts()
        return self

    def _recording(self, name, wrapper):
        def run(*args):
            self.seen.setdefault(name, []).append([t.clone() for t in args])
            return wrapper(*args)

        return run

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            return False
        from mcaat_tpu_torch.report import lcs_cuda

        counts = lcs_cuda.launch_counts()
        self.launches = {name: counts[name] for name in self.NAMES}
        for fn, wrapper in self._orig.items():
            setattr(lcs_cuda, fn, wrapper)
        return False


def _common_stats(result, wall: float, peaks: dict) -> dict:
    from mcaat_tpu_torch.utils import wire

    return {
        "wall_s": wall,
        "stages": json.loads(result.profile.to_json()) if result.profile else [],
        "systems": len(result.found_systems),
        "card_peaks_bytes": dict(peaks),
        "host_rss_peak_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "wire": wire.snapshot(),
    }


def _peaks(device):
    """The peak of every visible card over a block (``torch_e2e_big``'s
    ``card_peaks``); nothing to read on the CPU."""
    import contextlib

    import torch
    from torch_e2e_big import card_peaks

    if device.type != "cuda":
        return contextlib.nullcontext({})
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for d in cards:  # the allocator of a card keeps no peak before its first tensor
        torch.zeros(1, device=d)
    return card_peaks(cards)


def _keep_build(into: dict):
    """Wrap ``build_sharded_dbg`` so that the graph's digests, layout and
    build seconds land in ``into``; returns the undo."""
    import torch

    from mcaat_tpu_torch.parallel import sharded_graph

    build = sharded_graph.build_sharded_dbg

    def keep(mesh, *a, **kw):
        t0 = time.perf_counter()
        sg = build(mesh, *a, **kw)
        for d in set(mesh.local_devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        into.update(
            build_s=time.perf_counter() - t0, mesh=dict(mesh.shape), n_nodes=sg.n_nodes,
            live_rows_per_shard=sg.n_live.tolist(), T=sg.T, n_parts=sg.n_parts,
            gid_margin=(1 << 31) - 1 - mesh.kp * sg.T, **shard_digests(sg),
        )
        return sg

    sharded_graph.build_sharded_dbg = keep
    return lambda: setattr(sharded_graph, "build_sharded_dbg", build)


def child_single(args) -> dict:
    """Run 1: one process over every visible card (or N CPU shards)."""
    from mcaat_tpu_torch import resolve_device
    from mcaat_tpu_torch.cli import run_cli

    device = resolve_device()
    stats: dict = {}
    undo = _keep_build(stats)
    try:
        with _KernelWatch(device) as kw, _peaks(device) as peaks:
            t0 = time.perf_counter()
            result = run_cli(["--input-files", args.fastq, "--output-folder", args.out,
                              "--mesh", "auto"])
            wall = time.perf_counter() - t0
    finally:
        undo()
    if "live_rows_per_shard" not in stats:
        raise RuntimeError("--mesh auto did not take the sharded path")
    stats.update(_common_stats(result, wall, peaks))
    stats["launches"] = kw.launches
    stats["kernels"] = _recorded_kernels(kw.seen, device)
    return stats


def child_group(args) -> dict:
    """Run 2: one of N processes, one card (or one CPU shard) each."""
    import torch.distributed as dist

    from mcaat_tpu_torch import resolve_device
    from mcaat_tpu_torch.cli import parse_arguments, run_cli
    from mcaat_tpu_torch.parallel import multihost

    device = resolve_device()
    stats: dict = {}
    undo = _keep_build(stats)
    run_mh = multihost.run_pipeline_multihost
    mh_stats: dict = {}

    def with_stats(settings, **kw):
        return run_mh(settings, stats_out=mh_stats, **kw)

    multihost.run_pipeline_multihost = with_stats
    argv = ["--input-files", args.fastq, "--output-folder", args.out]
    try:
        with _KernelWatch(device) as kw, _peaks(device) as peaks:
            t0 = time.perf_counter()
            if int(os.environ["MCAAT_NUM_PROCESSES"]) > 1:
                result = run_cli(argv)
            else:
                # the CLI takes a group of one for a one-process run, so the
                # group's entry is called with the CLI's settings directly
                multihost.initialize_distributed(device=device)
                result = with_stats(parse_arguments(argv), device=device)
            wall = time.perf_counter() - t0
    finally:
        undo()
        multihost.run_pipeline_multihost = run_mh
    if not dist.is_initialized() or "live_rows_per_shard" not in stats:
        raise RuntimeError("the CLI did not take the process-group path")
    stats["process"] = dist.get_rank()
    stats.update(_common_stats(result, wall, peaks))
    # the process group's own figures (run_pipeline_multihost's stats_out):
    # its stages, its wire bytes and the digest of the gathered k-mer column
    stats["stages"] = mh_stats["stages"]
    stats["wire"] = mh_stats["wire"]
    stats["node_table_sha1"] = mh_stats["node_table_sha1"]
    stats["launches"] = kw.launches
    stats["kernels"] = _recorded_kernels(kw.seen, device)
    dist.barrier()
    dist.destroy_process_group()
    return stats


def count_range(codes, lengths, lo: int, hi: int, device, part_rows: int = RANGE_PART_ROWS):
    """The unique 23-mers in ``[lo, hi)`` of the reads and their reverse
    complements, with their multiplicities, counted on one device in row
    parts through the single-device ``count_unique`` and merge stack:
    ``(kmers int64, mult int32)``. ``codes``/``lengths`` may already be on
    the device."""
    import torch

    from mcaat_tpu_torch.kmer.count import (
        _merge_stack_drain,
        _merge_stack_push,
        count_unique,
        extract_kmers,
        revcomp_kmers,
    )

    codes = torch.as_tensor(codes, device=device)
    lengths = torch.as_tensor(lengths, device=device)
    stack: list = []
    for r0 in range(0, int(codes.shape[0]), part_rows):
        km = extract_kmers(codes[r0 : r0 + part_rows], lengths[r0 : r0 + part_rows], K)
        km = km.reshape(-1)
        km = torch.cat([km, revcomp_kmers(km, K)])
        km = km[(km >= lo) & (km < hi)]  # SENTINEL lies past every range
        u, c, _n = count_unique(km)
        del km
        _merge_stack_push(stack, u, c)
    u, c, _n = _merge_stack_drain(stack, device)
    return u, c.to(torch.int32)


def child_ranges(args) -> dict:
    """Run 3: the node table counted on one device, one owner range at a
    time, with each range's rows and digests."""
    import numpy as np
    import torch

    from mcaat_tpu_torch import resolve_device
    from mcaat_tpu_torch.io.fastq import read_encoded_batch
    from mcaat_tpu_torch.parallel.sharded import kmer_bounds

    device = resolve_device()
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    batch = read_encoded_batch(args.fastq)
    parse_s = time.perf_counter() - t0
    codes = torch.as_tensor(batch.codes, device=device)
    lengths = torch.as_tensor(batch.lengths, device=device)
    del batch
    if device.type == "cuda":  # after the card's first tensor: its allocator exists then
        torch.cuda.reset_peak_memory_stats(device)
    bounds = kmer_bounds(K, args.cards)
    shards, seconds = {}, []
    for s in range(args.cards):
        t1 = time.perf_counter()
        u, c = count_range(codes, lengths, bounds[s], bounds[s + 1], device)
        km = np.ascontiguousarray(u.cpu().numpy(), dtype=np.int64)
        mu = np.ascontiguousarray(c.cpu().numpy(), dtype=np.int32)
        del u, c
        shards[str(s)] = {
            "rows": int(km.size),
            "kmers": hashlib.sha1(km).hexdigest()[:16],
            "mult": hashlib.sha1(mu).hexdigest()[:16],
        }
        seconds.append(time.perf_counter() - t1)
        del km, mu
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"shards": shards, "parse_s": parse_s, "range_s": seconds, "peak_bytes": peak,
            "host_rss_peak_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def child_mesh_off(args) -> dict:
    """Run 4: ``--mesh off`` on one device. Out of memory is an outcome:
    the stage, the bytes asked for and the port's innermost frame."""
    import traceback

    import torch

    from mcaat_tpu_torch import resolve_device
    from mcaat_tpu_torch.cli import run_cli
    from mcaat_tpu_torch.utils import profiling

    device = resolve_device()
    open_stages: list = []
    stage = profiling.Profiler.stage

    def tracked(self, name, **counters):
        open_stages.append(name)
        return stage(self, name, **counters)

    profiling.Profiler.stage = tracked
    t0 = time.perf_counter()
    try:
        with _KernelWatch(device) as kw:
            result = run_cli(["--input-files", args.fastq, "--output-folder", args.out,
                              "--mesh", "off"])
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        asked = re.search(r"Tried to allocate ([0-9.]+ [KMGT]?i?B)", msg)
        port = [f for f in traceback.extract_tb(e.__traceback__) if "mcaat_tpu_torch" in f.filename]
        where = port[-1] if port else None
        return {
            "outcome": "out_of_memory",
            "stage": open_stages[-1] if open_stages else None,
            "asked": asked.group(1) if asked else None,
            "where": f"{os.path.relpath(where.filename, REPO)}:{where.lineno} ({where.name})"
            if where else None,
            "allocated_bytes": torch.cuda.memory_allocated(0),
            "peak_bytes": torch.cuda.max_memory_allocated(0),
            "total_bytes": torch.cuda.get_device_properties(0).total_memory,
            "message": msg[:600], "seconds": time.perf_counter() - t0,
        }
    finally:
        profiling.Profiler.stage = stage
    out = _common_stats(result, time.perf_counter() - t0, {})
    out.update(outcome="passed", launches=kw.launches,
               kernels=_recorded_kernels(kw.seen, device))
    return out


CHILDREN = {"single": child_single, "group": child_group, "ranges": child_ranges,
            "mesh_off": child_mesh_off}


def child_main(args) -> int:
    import torch

    if os.environ.get("MCAAT_TORCH_DEVICE") == "cpu":
        torch.set_num_threads(2)
    stats = CHILDREN[args.child](args)
    print(STATS + json.dumps(stats), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The parent: the input, the runs, the comparisons
# ---------------------------------------------------------------------------


def write_planted_fastq(path: str, seed: int, n_arrays: int, n_spacers: int,
                        background_len: int, background_coverage: float, coverage: float,
                        read_len: int = 100, flank_len: int = 300):
    """``write_fastq(path, make_metagenome(...)["reads"])`` in bulk: the same
    random draws in the same order and the same file bytes, with the reads
    as rows of a byte matrix instead of a Python string each (tens of
    millions of strings take minutes to make and to write;
    ``tests/torch_reads.py``). Returns ``(arrays, n_reads)``, ``arrays`` as
    ``make_metagenome`` gives them."""
    from torch_reads import metagenome_matrix, write_fastq_matrix

    arrays, reads = metagenome_matrix(
        seed, n_arrays, n_spacers, background_len, background_coverage, coverage,
        read_len=read_len, flank_len=flank_len,
    )
    write_fastq_matrix(path, reads)
    return arrays, int(reads.shape[0])


def recovery(meta, report: str):
    """(arrays whose repeat is reported, spacers planted, spacers whose
    core is reported), either strand; the reported repeat lacks its last
    base, a reference quirk."""
    from mcaat_tpu_torch.io.fastq import reverse_complement

    arrays = sum(
        1 for a in meta["arrays"]
        if a["repeat"][:-1] in report or reverse_complement(a["repeat"])[:-1] in report
    )
    spacers = [s for a in meta["arrays"] for s in a["spacers"]]
    found = sum(1 for s in spacers if s[6:-6] in report or reverse_complement(s[6:-6]) in report)
    return arrays, len(spacers), found


class Runs:
    """Starts the children of one run and collects their figures; when
    one fails the others are stopped at once (a process group would
    otherwise wait for it until its collective timeout)."""

    def __init__(self, args, work: str):
        self.args, self.work = args, work
        self.logs = args.logs

    def env(self, **extra) -> dict:
        env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
        env["MCAAT_TORCH_DEVICE"] = self.args.device
        env.update({k: str(v) for k, v in extra.items()})
        return env

    def start(self, name: str, child: str, out: str, env: dict):
        log = open(os.path.join(self.work, f"{name}.log"), "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(self.args.background_len),
               "--cards", str(self.args.cards), "--device", self.args.device,
               "--child", child, "--fastq", self.fastq, "--out", out]
        p = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        return name, p, log

    def wait(self, procs: list) -> list:
        """Figures of every child in order, or None when one failed."""
        stats = [None] * len(procs)
        deadline = time.monotonic() + 2 * TIMEOUT_S
        failed = False
        try:
            while any(p.poll() is None for _n, p, _l in procs) and not failed:
                failed = any(p.poll() not in (None, 0) for _n, p, _l in procs)
                if time.monotonic() > deadline:
                    failed = True
                time.sleep(0.5)
        finally:
            for _n, p, _l in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (name, p, log) in enumerate(procs):
            log.seek(0)
            text = log.read()
            log.close()
            if self.logs:
                os.makedirs(self.logs, exist_ok=True)
                with open(os.path.join(self.logs, f"{name}.log"), "w") as fh:
                    fh.write(text)
            for line in text.splitlines():
                if line.startswith(STATS):
                    stats[i] = json.loads(line[len(STATS):])
            if p.returncode != 0 or stats[i] is None:
                failed = True
                print(f"--- {name} (rc={p.returncode}) ---\n{text[-8000:]}", flush=True)
        return None if failed else stats


def print_stats(name: str, st: dict, card: str) -> None:
    print(f"  {name}: wall {st['wall_s']:.2f}s, mesh {st.get('mesh')}, {st.get('n_nodes')} nodes, "
          f"live rows per shard {st.get('live_rows_per_shard')}, T={st.get('T')} (int32 id margin "
          f"{st.get('gid_margin')}), count parts {st.get('n_parts')}, "
          f"build {st.get('build_s', 0):.2f}s, "
          f"host RSS peak {st['host_rss_peak_gb']:.2f} GB ({card})", flush=True)
    if st["card_peaks_bytes"]:
        print("    card peaks: " + ", ".join(
            f"{d} {b / 2**30:.2f} GiB" for d, b in st["card_peaks_bytes"].items()), flush=True)
    for s in st["stages"]:
        peak = s["device_peak_mb"]
        print(f"    {s['name']:<16} {s['seconds']:8.3f}s  peak "
              f"{'-' if peak is None else f'{peak / 1024:.2f} GiB'}  rss {s['rss_mb']:.0f} MB  "
              f"{s['counters']}", flush=True)
    if st["wire"]:
        print("    exchanged: " + ", ".join(
            f"{k} {v['bytes'] / 1e6:.1f} MB in {v['calls']}" for k, v in st["wire"].items()),
            flush=True)
    print(f"    systems {st['systems']}, launches {st.get('launches')}, kernels against their "
          f"plain versions {st.get('kernels')}", flush=True)


def parent(args) -> int:
    import torch

    n = args.cards
    if n < 1 or n & (n - 1):
        print(f"--cards {n}: the mesh needs a power of two", file=sys.stderr)
        return 1
    if args.device == "cuda":
        have = torch_cards()
        if have < n:
            print(f"torch_sharded_past_ceiling: needs {n} CUDA cards, sees {have}", file=sys.stderr)
            return 1
    cards = card_lines(args.device)
    card = cards[0]
    print(f"torch {torch.__version__}; cards: {cards}", flush=True)

    work = tempfile.mkdtemp(prefix="mcaat_past_ceiling_")
    out: dict = {"argv": [args.background_len, n, args.arrays], "device": args.device,
                 "cards": cards}
    try:
        return _parent_runs(args, work, out, card)
    finally:
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
            with open(args.json, "w") as fh:
                json.dump(out, fh, indent=1)
        shutil.rmtree(work, ignore_errors=True)


def _parent_runs(args, work, out, card) -> int:
    n = args.cards
    # 100 bp reads at coverage 8 with their FASTQ text: about 2.5 bytes a
    # background base
    need = 2.5 * args.background_len * 8 / 100 * 2.2 + (1 << 30)
    free = shutil.disk_usage(work).free
    print(f"work directory {work}: {free / 2**30:.1f} GiB free", flush=True)
    if free < need:
        print(f"not enough disk for the FASTQ ({need / 2**30:.1f} GiB)", flush=True)
        return 1
    t0 = time.perf_counter()
    fq = os.path.join(work, "reads.fq")
    arrays, n_reads = write_planted_fastq(
        fq, seed=7, n_arrays=args.arrays, n_spacers=30, background_len=args.background_len,
        background_coverage=8.0, coverage=35.0,
    )
    meta = {"arrays": arrays}
    gen_s = time.perf_counter() - t0
    n_windows = 2 * n_reads * (100 - K)
    out.update(n_reads=n_reads, n_windows=n_windows, generate_s=gen_s,
               fastq_bytes=os.path.getsize(fq))
    print(f"generated {n_reads} reads, {n_windows} (k+1)-mer windows with RC, background "
          f"{args.background_len / 1e6:.1f} Mbp, and wrote them in {gen_s:.1f}s "
          f"({out['fastq_bytes'] / 2**30:.2f} GiB)", flush=True)

    runs = Runs(args, work)
    runs.fastq = fq
    cuda = args.device == "cuda"
    fails: list = []
    if cuda:  # built once here, so no run's report stage holds the nvcc build
        from mcaat_tpu_torch.report import lcs_cuda

        t0 = time.perf_counter()
        lib = lcs_cuda.build()
        print(f"report kernels: {os.path.relpath(lib, REPO)} ({time.perf_counter() - t0:.1f}s)",
              flush=True)

    def report(folder: str) -> str:
        with open(os.path.join(folder, "CRISPR_Arrays.txt")) as fh:
            return fh.read()

    def check_reference(name: str, st: dict, text: str) -> None:
        """The figures every later run is held against: recovery, mesh."""
        arrays, planted, found = recovery(meta, text)
        out["recovery"] = {"arrays": arrays, "arrays_planted": len(meta["arrays"]),
                           "spacers": found, "spacers_planted": planted}
        print(f"    arrays {arrays}/{len(meta['arrays'])}, spacers {found}/{planted}, report "
              f"{len(text)} bytes; past one card's ceiling ({CEILING_NODES} nodes): "
              f"{st['n_nodes'] > CEILING_NODES}", flush=True)
        if arrays != len(meta["arrays"]) or found < 0.98 * planted:
            fails.append(f"{name}: {arrays} arrays, {found}/{planted} spacers")
        if st["mesh"] != {"dp": 1, "kp": n}:
            fails.append(f"{name}: the mesh is {st['mesh']}, not one shard a card")

    # 1. one process over every card (with one card there is nothing to
    # shard in one process: run 2's group of one is the reference then)
    single = None
    if n > 1:
        print("== 1. one process over the cards, --mesh auto", flush=True)
        env = runs.env(CUDA_VISIBLE_DEVICES=",".join(map(str, range(n)))) if cuda \
            else runs.env(MCAAT_TORCH_SHARDS=n)
        got = runs.wait([runs.start("run1_single", "single", os.path.join(work, "single"), env)])
        if got is None:
            return 1
        single = out["single"] = got[0]
        ref = report(os.path.join(work, "single"))
        print_stats("one process", single, card)
        check_reference("run 1", single, ref)

    # 2. one process a card
    print("== 2. one process a card", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for pid in range(n):
        extra = dict(MCAAT_COORDINATOR=f"localhost:{port}", MCAAT_NUM_PROCESSES=n,
                     MCAAT_PROCESS_ID=pid, MCAAT_DIST_TIMEOUT_S=TIMEOUT_S)
        if cuda:
            extra["CUDA_VISIBLE_DEVICES"] = pid
        procs.append(runs.start(f"run2_process{pid}", "group", os.path.join(work, "group"),
                                runs.env(**extra)))
    group = runs.wait(procs)
    if group is None:
        return 1
    out["group"] = group
    out["group_wall_s"] = time.perf_counter() - t0
    print(f"  the process group finished in {out['group_wall_s']:.1f}s", flush=True)
    for st in group:
        print_stats(f"process {st['process']}", st, card)
    group_report = report(os.path.join(work, "group"))
    if single is None:
        single, ref = dict(group[0], kmers_all=group[0]["node_table_sha1"]), group_report
        check_reference("run 2", single, ref)
    shards = {}
    for st in group:
        shards.update(st["shards"])
    table_same = shards == single["shards"] and all(
        st["live_rows_per_shard"] == single["live_rows_per_shard"] and st["T"] == single["T"]
        for st in group
    )
    digest_same = all(st["node_table_sha1"] == single["kmers_all"] for st in group)
    print(f"  node table (every shard's k-mers and multiplicities) equal to run 1's: {table_same}; "
          f"stats_out's k-mer digest {group[0]['node_table_sha1']} = SHA-1 fed shard by shard "
          f"{single['kmers_all']}: {digest_same}; report equal: {group_report == ref}", flush=True)
    if not (table_same and digest_same and group_report == ref):
        fails.append("run 2: the process group differs from the one-process run")

    # 3 and 4: side by side on two cards, one after the other on one
    print("== 3. the node table counted range by range on one card; 4. --mesh off on one card",
          flush=True)
    t0 = time.perf_counter()
    beside = not cuda or torch_cards() > 1
    starts = [("run3_ranges", "ranges", 0), ("run4_mesh_off", "mesh_off", 1 if beside else 0)]
    got = []
    for batch in ([starts] if beside else [[x] for x in starts]):
        res = runs.wait([
            runs.start(name, child, os.path.join(work, child),
                       runs.env(CUDA_VISIBLE_DEVICES=card_no) if cuda else runs.env())
            for name, child, card_no in batch
        ])
        if res is None:
            return 1
        got += res
    ranges, mesh_off = got
    out["ranges"], out["mesh_off"] = ranges, mesh_off
    print(f"  runs 3 and 4 took {time.perf_counter() - t0:.1f}s "
          f"{'side by side' if beside else 'one after the other'}", flush=True)
    ranges_same = ranges["shards"] == single["shards"]
    print(f"  range count: rows {[v['rows'] for _k, v in sorted(ranges['shards'].items())]}, "
          f"seconds {[round(x, 2) for x in ranges['range_s']]}, parse {ranges['parse_s']:.2f}s, "
          f"peak {(ranges['peak_bytes'] or 0) / 2**30:.2f} GiB; equal to the sharded table: "
          f"{ranges_same} ({card})", flush=True)
    if not ranges_same:
        fails.append(f"run 3: range count {ranges['shards']} against {single['shards']}")
    if mesh_off["outcome"] == "out_of_memory":
        print(f"  --mesh off ran out of memory in stage {mesh_off['stage']} at "
              f"{mesh_off['where']}: asked for {mesh_off['asked']} with "
              f"{mesh_off['allocated_bytes'] / 2**30:.2f} GiB allocated, peak "
              f"{mesh_off['peak_bytes'] / 2**30:.2f} GiB of {mesh_off['total_bytes'] / 2**30:.2f} "
              f"GiB, after {mesh_off['seconds']:.1f}s ({card})",
              flush=True)
    else:
        off_report = report(os.path.join(work, "mesh_off"))
        print_stats("--mesh off", mesh_off, card)
        print(f"  --mesh off passed; report equal to the sharded runs': {off_report == ref}",
              flush=True)
        if off_report != ref:
            fails.append("run 4: the --mesh off report differs")

    # the report kernels on every path, and the cards' peaks
    paths = ([("run 1", out["single"])] if "single" in out else []) + [
        (f"run 2 process {g['process']}", g) for g in group]
    if cuda:
        import torch

        total = torch.cuda.get_device_properties(0).total_memory
        for name, st in paths:
            for kern in ("partial_ratio", "ratio_matrix"):
                if not st["launches"].get(kern) or st["launches"] != single["launches"]:
                    fails.append(f"{name} launched {kern} {st['launches'].get(kern)} times")
                if st["kernels"][kern]["max_abs_err"] != 0.0:
                    fails.append(f"{name}: {kern} differs from its plain version")
            for d, b in st["card_peaks_bytes"].items():
                if b >= total:
                    fails.append(f"{name}: {d} peaked at {b} bytes of {total}")
    for f in fails:
        print(f"FAIL: {f}", flush=True)
    out["passed"] = not fails
    print(json.dumps({k: out[k] for k in ("argv", "cards", "n_reads", "n_windows", "recovery")}
                     | {"n_nodes": single["n_nodes"], "passed": not fails}), flush=True)
    print("PAST CEILING FAILED" if fails else "PAST CEILING PASSED", flush=True)
    return 1 if fails else 0


def torch_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.child:
        return child_main(args)
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
