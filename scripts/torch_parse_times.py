"""Time the FASTQ parse of a pair of mates on this host, route by route.

    python3 scripts/torch_parse_times.py [--input sample-pe150] [--dir D]
        [--threads 1,2,4,8] [--turns 3] [--gz] [--json F]

Writes the named input of ``tests/torch_fragments.py`` under ``D`` (kept
and reused when its two files are there; ``.fq.gz`` at level 1 with
``--gz``), then times, in turns:

- ``shared``: ``native.parse_fastx_batch`` on each mate (the shared
  library's one-thread zlib parse, its matrix copied into numpy), the
  route plain FASTQ took before the port had its own parser, and gzipped
  FASTQ before the port inflated it;
- plain files: ``serial-T``, ``native.parse_plain_fastq`` on each mate
  in turn with T threads each; ``concurrent-T``, both mates at once from
  two Python threads (ctypes lets the GIL go), T/2 threads each;
- gzipped files: ``gzip-T``, ``native.parse_gzip_fastq`` on both mates
  with T threads (the mates inflate at once, up to T); ``gzip-serial-T``,
  the mates one call each.

Every route's codes and lengths are checked equal to ``shared``'s. Then
the host's copy rate: numpy copies of a buffer the size of one mate's
file, on one thread and on every CPU, the figure a parse's bound is
read against (bytes read plus bytes written over the rate). Prints a
line a measurement and one JSON line of everything at the end. The
files are in the page cache (written just before, or read by the first
turn): the times are those of a warm read.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

from mcaat_tpu_torch import native  # noqa: E402


def _input(name: str, folder: str, gz: bool) -> list[str]:
    files = [os.path.join(folder, f"reads_{i}.fq" + (".gz" if gz else "")) for i in (1, 2)]
    if not all(os.path.exists(f) for f in files):
        import torch_fragments

        t0 = time.perf_counter()
        got = torch_fragments.make_named(name, folder, gz=gz)
        files = got["files"]
        print(f"wrote {name}: {got['n_pairs']} pairs in {time.perf_counter() - t0:.2f}s",
              flush=True)
    return files


def _shared(files, _threads):
    return [native.parse_fastx_batch(f) for f in files]


def _serial(files, threads):
    return [native.parse_plain_fastq(f, threads=threads) for f in files]


def _gzip(serial: bool):
    def run(files, threads):
        calls = [[f] for f in files] if serial else [files]
        got = [g for c in calls for g in native.parse_gzip_fastq(c, threads)]
        assert all(g is not None for g in got)
        return got

    return run


def _concurrent(files, threads):
    out = [None] * len(files)
    each = max(1, threads // len(files))

    def one(i):
        out[i] = native.parse_plain_fastq(files[i], threads=each)

    pool = [threading.Thread(target=one, args=(i,)) for i in range(len(files))]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return out


def _copy_rate(nbytes: int, threads: int, turns: int = 3) -> float:
    """Bytes a second a numpy copy moves (read plus write counted once
    each: 2 x nbytes a copy), ``threads`` slices at once."""
    src = np.ones(nbytes, dtype=np.uint8)
    dst = np.empty_like(src)
    dst[:] = 0  # fault the pages in before timing
    cuts = [nbytes * t // threads for t in range(threads + 1)]
    best = float("inf")
    for _ in range(turns):
        pool = [threading.Thread(target=np.copyto, args=(dst[a:b], src[a:b]))
                for a, b in zip(cuts, cuts[1:])]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="sample-pe150")
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "parse_times"))
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--gz", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    files = _input(args.input, args.dir, args.gz)
    file_bytes = [os.path.getsize(f) for f in files]
    cpus = native.parse_threads()
    threads = [int(t) for t in args.threads.split(",")]
    routes = [("shared", _shared, 1)]
    if args.gz:
        routes += [(f"gzip-{t}", _gzip(False), t) for t in threads]
        routes += [(f"gzip-serial-{t}", _gzip(True), t) for t in threads[-1:]]
    else:
        routes += [(f"serial-{t}", _serial, t) for t in threads]
        routes += [(f"concurrent-{t}", _concurrent, t) for t in threads if t >= 2]
    want = _shared(files, 1)
    out_bytes = sum(c.nbytes + ln.nbytes for c, ln in want)
    times: dict[str, list[float]] = {name: [] for name, _, _ in routes}
    for turn in range(args.turns):
        for name, fn, t in routes:
            t0 = time.perf_counter()
            got = fn(files, t)
            dt = time.perf_counter() - t0
            times[name].append(dt)
            for (c, ln), (wc, wl) in zip(got, want):
                assert c.dtype == wc.dtype and c.shape == wc.shape, name
                assert np.array_equal(c, wc) and np.array_equal(ln, wl), name
            print(f"turn {turn} {name}: {dt:.4f}s", flush=True)
            del got
    rate_1 = _copy_rate(max(file_bytes), 1)
    rate_all = _copy_rate(max(file_bytes), cpus)
    moved = sum(file_bytes) + out_bytes
    result = {
        "input": args.input,
        "gz": args.gz,
        "file_bytes": file_bytes,
        "reads": [int(ln.shape[0]) for _, ln in want],
        "out_bytes": out_bytes,
        "cpus": cpus,
        "median_s": {k: statistics.median(v) for k, v in times.items()},
        "times_s": times,
        "copy_rate_1_thread_Bps": rate_1,
        "copy_rate_all_Bps": rate_all,
        "bound_s_all": moved / rate_all,
        "bound_s_1_thread": moved / rate_1,
    }
    for k, v in result["median_s"].items():
        print(f"{k}: median {v:.4f}s", flush=True)
    print(f"copy rate {rate_1 / 1e9:.2f} GB/s one thread, {rate_all / 1e9:.2f} GB/s on {cpus}; "
          f"bound {result['bound_s_all']:.4f}s for {moved / 1e9:.3f} GB read and written",
          flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
