"""The large synthetic metagenome through the whole pipeline of the torch
port on one card: the counterpart of ``scripts/e2e_big_tpu.py``, with
the same arguments, seed and ``make_metagenome`` call.

Usage:  python3 scripts/torch_e2e_big.py [n_arrays] [background_len]
            [background_coverage] [--error-rate E] [--error-seed S]
            [--paired] [--input NAME] [--gz] [--device cuda] [--json PATH]

``400 62000000 10.4`` gives 6.59M reads of 100 bases, about 1.03B
(k+1)-mer windows with the reverse complements, a 124.7M-node graph and
400 planted arrays of 6 spacers. The reads are written from a byte matrix
(``tests/torch_reads.py``: the bytes ``make_metagenome`` + ``write_fastq``
give). ``--error-rate E`` substitutes each base with probability E
(``--error-seed``, default 1), ``--paired`` writes two mate files (mate 2
reverse-complemented) and ``--gz`` gzips them: ``--error-rate 0.005
--paired`` is sample-1.03B-err-pe, ``--error-rate 0.01 --paired``
sample-1.03B-err1-pe (``PERF.md`` §4). ``--input NAME`` takes a named
input of ``tests/torch_fragments.py`` instead (2x150-bp fragment pairs
with trimmed mates, N bases and errors rising along a mate; ``--gz``
applies): ``--input sample-pe150`` is that file's 1.03B-window sample,
whose windows are counted padded (the build's ``R x (Lmax - k) x 2``)
and real (inside each mate). In order:

1. ``run_pipeline`` twice in one process (cold, then warm) with
   ``--mesh off``: each stage's seconds, ``Profiler.to_json`` counters,
   the device peak, reads/s and windows/s, and the number of adjacency
   chunks (``graph/dbg.py::_adjacency_scatter_chunk`` calls; more than
   one when the edge table passes ``ADJ_SINGLE_SHOT_MAX_EDGES``);
2. systems found and spacers recovered, counted as the JAX script counts
   them (a spacer's core, or its reverse complement, in the report);
3. a run with ``--ram 20G``, which forces row parts at this size (a
   quarter of the single-pass window budget a part): the report must
   equal run 1's byte for byte;
4. a run with ``--mesh auto`` over 4 shards (``MCAAT_TORCH_SHARDS=4``:
   dealt over the visible cards, so one card holds all four): the same
   bytes again; the peak of each card and the exchanged bytes per stage.

Any difference exits non-zero. ``--device cpu`` with a small input
(``2 200000 4``) rehearses the control flow without a card; the default
device is the card, and no card is an error. ``--json`` writes every
figure to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_arrays", nargs="?", type=int, default=100)
    ap.add_argument("background_len", nargs="?", type=int, default=4_000_000)
    ap.add_argument("background_coverage", nargs="?", type=float, default=8.0)
    ap.add_argument("--error-rate", type=float, default=0.0,
                    help="substitutions a base (tests/torch_reads.py)")
    ap.add_argument("--error-seed", type=int, default=1)
    ap.add_argument("--input", help="a named input of tests/torch_fragments.py (two mate "
                    "files) in place of the make_metagenome call")
    ap.add_argument("--paired", action="store_true", help="two mate files, mate 2 reverse-complemented")
    ap.add_argument("--gz", action="store_true", help="gzip the input files (level 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the figures to this file")
    return ap.parse_args(argv)


RAM_GB = 20.0  # the --ram of the parted run
SHARDS = 4  # the shards of the --mesh auto run


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu (no device figures)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def card_peaks(devices):
    """The peak allocation of every card over the block: the profiler
    resets the peaks at each stage boundary, so each reset first folds
    the running peak into ``out``."""
    import torch

    out = {str(d): 0 for d in devices if d.type == "cuda"}
    reset = torch.cuda.reset_peak_memory_stats

    def fold(d=None):
        dev = torch.device("cuda") if d is None else torch.device(d)
        if dev.type == "cuda" and dev.index is None:  # the profiler names the card "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        if key in out:
            out[key] = max(out[key], torch.cuda.max_memory_allocated(key))
        reset(d)

    for d in out:
        fold(d)
        out[d] = 0
    torch.cuda.reset_peak_memory_stats = fold
    try:
        yield out
    finally:
        torch.cuda.reset_peak_memory_stats = reset
        for d in out:
            out[d] = max(out[d], torch.cuda.max_memory_allocated(d))


def recovery(meta, report: str):
    """(planted arrays whose spacers all appear, spacers recovered,
    spacers planted), the JAX script's count: a core (the spacer less
    six bases at each end) or its reverse complement in the report."""
    from mcaat_tpu_torch.io.fastq import reverse_complement

    hits = total = full = 0
    for arr in meta["arrays"]:
        got = 0
        for sp in arr["spacers"]:
            core = sp[6:-6]
            got += core in report or reverse_complement(core) in report
        hits += got
        total += len(arr["spacers"])
        full += got == len(arr["spacers"])
    return full, hits, total


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from mcaat_tpu_torch import resolve_device

    device = resolve_device(args.device)
    os.environ["MCAAT_TORCH_DEVICE"] = device.type
    os.environ.pop("MCAAT_TORCH_SHARDS", None)
    card = card_line(device)
    print(f"torch {torch.__version__}, device {device}: {card}", flush=True)

    from torch_probes import probe_pipeline
    from torch_reads import add_substitutions, metagenome_matrix, write_reads

    from mcaat_tpu_torch.graph import dbg
    from mcaat_tpu_torch.pipeline import BUDGET_CARD_GB, run_pipeline
    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils import wire

    tmp = tempfile.mkdtemp(prefix="mcaat_e2e_big_")
    t0 = time.perf_counter()
    if args.input:
        from torch_fragments import make_named

        written = make_named(args.input, tmp, gz=args.gz)
        arrays, n_reads, subs = written["arrays"], written["n_reads"], written["substitutions"]
        n_windows, real_windows = written["padded_windows"], written["real_windows"]
        gen_s, err_s = time.perf_counter() - t0, 0.0
        write_s = gen_s
        print(f"generated {args.input}: {written['n_pairs']} pairs, {len(arrays)} arrays, mate "
              f"lengths {written['length_counts']}, {n_windows} padded and {real_windows} real "
              f"windows with RC, {subs} substitutions, {written['n_bases']} N"
              f"{', gzipped' if args.gz else ''}, sha1 {written['sha1']} (made and written in "
              f"{gen_s:.1f}s)", flush=True)
    else:
        arrays, reads = metagenome_matrix(
            seed=7, n_arrays=args.n_arrays, n_spacers=6, background_len=args.background_len,
            background_coverage=args.background_coverage, coverage=35.0,
        )
        t1 = time.perf_counter()
        subs = add_substitutions(reads, args.error_rate, args.error_seed)
        gen_s, err_s = t1 - t0, time.perf_counter() - t1
        t0 = time.perf_counter()
        written = write_reads(tmp, reads, paired=args.paired, gz=args.gz)
        write_s = time.perf_counter() - t0
        n_reads, read_len = reads.shape
        del reads
        # both strands, every (k+1)-window of a read of read_len bases
        n_windows = real_windows = 2 * n_reads * (read_len - 23)
        print(f"generated {n_reads} reads, {args.n_arrays} arrays, {n_windows} windows with RC, "
              f"{subs} substitutions (rate {args.error_rate:g}), {len(written['files'])} file(s)"
              f"{' gzipped' if args.gz else ''}, sha1 {written['sha1']} (generated in "
              f"{gen_s:.1f}s, errors in {err_s:.1f}s, written in {write_s:.1f}s)", flush=True)
    fq = " ".join(written["files"])
    meta = {"arrays": arrays}
    out: dict = {
        "argv": [args.n_arrays, args.background_len, args.background_coverage],
        "input": args.input, "error_rate": args.error_rate, "error_seed": args.error_seed,
        "paired": args.paired, "gz": args.gz, "substitutions": subs,
        "input_sha1": written["sha1"], "card": card, "device": str(device), "n_reads": n_reads,
        "n_windows": n_windows, "real_windows": real_windows, "generate_s": gen_s,
        "errors_s": err_s, "write_s": write_s, "runs": {},
    }

    def one_run(name: str, **settings_kw):
        s = Settings(input_files=fq, output_file=os.path.join(tmp, f"{name}.txt"), **settings_kw)
        devices = [device]
        if device.type == "cuda" and device.index is None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        if s.mesh != "off":
            from mcaat_tpu_torch.parallel.sharded import default_devices

            devices = sorted(set(default_devices(device)), key=str)
        wire.reset()
        with probe_pipeline() as probe, \
                card_peaks(devices) if device.type == "cuda" else contextlib.nullcontext({}) as peaks:
            t1 = time.perf_counter()
            r = run_pipeline(s, verbose=False, device=device)
            if device.type == "cuda":
                for d in devices:
                    torch.cuda.synchronize(d)
            wall = time.perf_counter() - t1
        stages = json.loads(r.profile.to_json())
        full, hits, total = recovery(meta, r.report_text)
        build = next(st for st in stages if st["name"] == "graph_build")
        nodes = build["counters"].get("nodes")
        build_peak = (build["device_peak_mb"] or 0) * 2**20
        fig = {
            "wall_s": wall, "reads_per_s": n_reads / wall, "windows_per_s": n_windows / wall,
            "stages": stages, "device_peak_mb": r.profile.peak_device_mb(),
            "card_peaks_bytes": dict(peaks), "adjacency_chunks": probe["adjacency_chunks"],
            "count_parts": probe["count_parts"], "nodes": nodes,
            "unique_edges": probe["unique_edges"] or None,
            "build_peak_bytes_per_window": build_peak / n_windows if build_peak else None,
            "build_peak_bytes_per_real_window": build_peak / real_windows if build_peak else None,
            "build_peak_bytes_per_node": build_peak / nodes if build_peak and nodes else None,
            "reverse_complement_s": probe["rc_s"], "reverse_complement_reads": probe["rc_reads"],
            "ordering_pool_s": probe["ordering_pool_s"], "subproblems": probe["subproblems"],
            "cycles_per_subproblem_max": max(probe["cycles_per_subproblem"], default=0),
            "cycles_in_subproblems": sum(probe["cycles_per_subproblem"]),
            "systems": len(r.found_systems), "arrays_all_spacers": full,
            "spacers_recovered": hits, "spacers_planted": total, "wire": wire.snapshot(),
        }
        out["runs"][name] = fig
        print(f"== {name}: wall {wall:.2f}s, {fig['reads_per_s']:,.0f} reads/s, "
              f"{fig['windows_per_s']:,.0f} windows/s, device peak "
              f"{(fig['device_peak_mb'] or 0) / 1024:.2f} GiB, adjacency chunks "
              f"{fig['adjacency_chunks']}, count parts {fig['count_parts']} ({card})",
              flush=True)
        if nodes:
            per = (f", build peak {fig['build_peak_bytes_per_window']:.2f} B a window "
                   f"({fig['build_peak_bytes_per_real_window']:.2f} a real one) and "
                   f"{fig['build_peak_bytes_per_node']:.1f} B a node" if build_peak else "")
            print(f"   nodes {nodes}, unique (k+1)-mers {fig['unique_edges']}{per}; "
                  f"reverse_complement_batch {fig['reverse_complement_s']:.2f}s on "
                  f"{fig['reverse_complement_reads']} reads; ordering pool "
                  f"{fig['ordering_pool_s']:.2f}s, {fig['subproblems']} subproblems, "
                  f"{fig['cycles_in_subproblems']} cycles (at most "
                  f"{fig['cycles_per_subproblem_max']} in one)", flush=True)
        for st in stages:
            peak = st["device_peak_mb"]
            print(f"   {st['name']:<16} {st['seconds']:8.3f}s  peak "
                  f"{'-' if peak is None else f'{peak / 1024:.2f} GiB'}  rss {st['rss_mb']:.0f} MB  "
                  f"{st['counters']}", flush=True)
        print(f"   systems {fig['systems']}/{len(meta['arrays'])} planted, arrays with every spacer "
              f"{full}, spacers recovered {hits}/{total}", flush=True)
        if fig["card_peaks_bytes"]:
            print("   card peaks: " + ", ".join(
                f"{d} {b / 2**30:.2f} GiB" for d, b in fig["card_peaks_bytes"].items()), flush=True)
        if fig["wire"]:
            print("   exchanged: " + ", ".join(
                f"{k} {v['bytes'] / 1e6:.1f} MB in {v['calls']}" for k, v in fig["wire"].items()),
                flush=True)
        report = r.report_text.encode()
        del r
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return report

    def done(rc: int) -> int:
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
            with open(args.json, "w") as fh:
                json.dump(out, fh, indent=1)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        return rc

    ok = True
    ref = one_run("cold", mesh="off")
    if one_run("warm", mesh="off") != ref:
        print("MISMATCH: the warm run's report differs from the cold run's", flush=True)
        ok = False
    if one_run("ram", mesh="off", ram=RAM_GB, ram_explicit=True) != ref:
        print(f"MISMATCH: the --ram {RAM_GB:g}G run's report differs", flush=True)
        ok = False
    budget = max(int(dbg.SINGLE_PASS_MAX_WINDOWS * RAM_GB / BUDGET_CARD_GB), 2_000_000)
    if n_windows > budget and out["runs"]["ram"]["count_parts"] < 2:
        print(f"the --ram {RAM_GB:g}G run counted in one part", flush=True)
        ok = False
    os.environ["MCAAT_TORCH_SHARDS"] = str(SHARDS)
    try:
        if one_run("shards", mesh="auto") != ref:
            print(f"MISMATCH: the {SHARDS}-shard run's report differs", flush=True)
            ok = False
    finally:
        del os.environ["MCAAT_TORCH_SHARDS"]
    if args.input:  # the truth rules of chip_smoke.py phase 24
        from torch_fragments import truth_floor
        from torch_probes import arrays_found

        found = arrays_found(arrays, ref.decode(), errors=True)
        min_arrays, min_share = truth_floor(args.input)
        cold = out["runs"]["cold"]
        out["arrays_with_a_system"] = found
        print(f"arrays with a system (a shared 23-mer) {found}/{len(arrays)} (floor "
              f"{min_arrays}); spacers {cold['spacers_recovered']}/{cold['spacers_planted']} "
              f"(floor {min_share:.2%}); the floors are the JAX package's on the same arrays",
              flush=True)
        if found < min_arrays or \
                cold["spacers_recovered"] < min_share * cold["spacers_planted"]:
            print("the report misses planted arrays or spacers", flush=True)
            ok = False
    out["report_bytes"] = len(ref)
    out["reports_identical"] = ok
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}), flush=True)
    print("E2E BIG PASSED" if ok else "E2E BIG FAILED", flush=True)
    return done(0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
