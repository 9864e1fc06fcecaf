#!/usr/bin/env python3
"""Device-memory peaks of the port's graph build on one CUDA card.

For each ``windows:coverage`` pair, samples error-free 100 bp reads at
that coverage from a random genome (as ``tests/synthetic.py`` samples its
background) so that the read set holds about that many (k+1)-mer windows
on both strands, then builds the graph with
``mcaat_tpu_torch.graph.dbg.build_dbg_from_reads``:

* by default in one pass (``chunk_windows=0``) with a single-shot
  adjacency, whatever the size;
* with ``--parted``, with the shipped budgets (``SINGLE_PASS_MAX_WINDOWS``,
  ``DEVICE_PARTS_BUDGET``, ``ADJ_SINGLE_SHOT_MAX_EDGES``), so that inputs
  above the window budget go in parts.

``torch.cuda.max_memory_allocated`` is read per segment of the build:

* ``count_peak``: the largest row part's (k+1)-mer count, with whatever
  counted parts are resident beside it (one part in one pass);
* ``merge_peak``: the largest merge of two counted tables, with
  ``merge_rows`` (the rows of both inputs) and ``merge_base`` (what was
  allocated when it started);
* ``other_peak``: everything between (uploads, spills, the last-window
  count, the node derivation);
* ``adj_peak``: the adjacency, and ``adj_base``, what was allocated when
  it started;

and the parts, spills, adjacency passes, unique edge and node counts and
the seconds of the build. A size that runs out of memory is recorded
with the segment it ran out in, and the next one is tried.

With ``--sharded N`` the same reads are built by
``mcaat_tpu_torch.parallel.sharded_graph.build_sharded_dbg`` on a mesh of
N shards that all sit on this one card, so the peak is the sum of the
shards': the whole build's peak, its seconds, the parts (set
``MCAAT_COUNT_SHARD_ROWS`` to force several), the rows per shard and the
bytes that changed shard per stage. Run from the repository root:

    python3 scripts/torch_build_peaks.py 126e6:8 495e6:8 1.0e9:8 1.2e9:1.5
    python3 scripts/torch_build_peaks.py --parted 2.0e9:8 3.0e9:8 2.0e9:4
    python3 scripts/torch_build_peaks.py --sharded 4 126e6:8 495e6:8 1.1e9:8

One JSON object per size goes to standard output, after a line with the
card's name, power limit and memory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READ_LEN = 100
K = 23


def reads_for(windows: float, coverage: float, seed: int = 0):
    """A code matrix of 100 bp reads with about ``windows`` windows
    (both strands), sampled at ``coverage`` from a random genome."""
    import numpy as np

    rng = np.random.default_rng(seed)
    per_read = 2 * (READ_LEN - K)
    n_reads = int(windows // per_read)
    genome_len = max(int(n_reads * READ_LEN / coverage), READ_LEN + 1)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.empty((n_reads, READ_LEN), dtype=np.uint8)
    step = 1 << 20  # rows per gather, so the index matrix stays small
    for lo in range(0, n_reads, step):
        hi = min(lo + step, n_reads)
        starts = rng.integers(0, genome_len - READ_LEN, hi - lo)
        codes[lo:hi] = genome[starts[:, None] + np.arange(READ_LEN)]
    return codes, np.full(n_reads, READ_LEN, dtype=np.int32)


class Segments:
    """Splits the build into named segments and keeps the device peak,
    entry allocation and call count of each (largest over calls)."""

    def __init__(self, torch, dev, row: dict):
        self.torch, self.dev, self.row = torch, dev, row
        self.current = "other"

    def _close(self) -> None:
        torch = self.torch
        torch.cuda.synchronize(self.dev)
        key = f"{self.current}_peak"
        self.row[key] = max(self.row.get(key, 0), torch.cuda.max_memory_allocated(self.dev))
        torch.cuda.reset_peak_memory_stats(self.dev)

    def enter(self, name: str) -> int:
        self._close()
        self.current = name
        self.row[f"{name}_calls"] = self.row.get(f"{name}_calls", 0) + 1
        return self.torch.cuda.memory_allocated(self.dev)

    def leave(self) -> None:
        self._close()
        self.current = "other"

    def wrap(self, module, attr: str, name: str, note=None):
        orig = getattr(module, attr)

        def spy(*args, **kwargs):
            base = self.enter(name)
            out = orig(*args, **kwargs)
            self.leave()
            if note is not None:
                note(self.row, base, args, out)
            return out

        setattr(module, attr, spy)
        return lambda: setattr(module, attr, orig)


def _note_merge(row, base, args, _out) -> None:
    a, b = args
    rows = int(a.u.shape[0]) + int(b.u.shape[0])
    if rows > row.get("merge_rows", 0):
        row["merge_rows"], row["merge_base"] = rows, base


def _note_adj(row, base, args, out) -> None:
    row["adj_base"] = base
    row["nodes"], row["edges"] = int(args[0].shape[0]), int(args[2].shape[0])


def measure(windows: float, coverage: float, parted: bool) -> dict:
    import torch

    from mcaat_tpu_torch.graph import dbg
    from mcaat_tpu_torch.kmer import count as kcount

    dev = torch.device("cuda", 0)
    codes, lengths = reads_for(windows, coverage)
    row = {
        "mode": "parted" if parted else "single",
        "windows": int(codes.shape[0]) * 2 * (READ_LEN - K),
        "coverage": coverage,
        "reads": int(codes.shape[0]),
    }
    seg = Segments(torch, dev, row)
    undo = [
        seg.wrap(kcount, "_count_edge_part", "count"),
        seg.wrap(kcount, "_merge_two", "merge", _note_merge),
        seg.wrap(kcount, "_spill", "spill"),
        seg.wrap(dbg, "build_dbg", "adj", _note_adj),
    ]
    adj_max = dbg.ADJ_SINGLE_SHOT_MAX_EDGES
    if not parted:
        dbg.ADJ_SINGLE_SHOT_MAX_EDGES = 1 << 62
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        g = dbg.build_dbg_from_reads(
            codes, lengths, k=K, chunk_windows=None if parted else 0, device=dev
        )
        torch.cuda.synchronize(dev)
        row["seconds"] = time.perf_counter() - t0
        row["peak"] = max(v for key, v in row.items() if key.endswith("_peak"))
        row["bytes_per_window"] = row["peak"] / row["windows"]
        del g
    except torch.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0]
        row["oom_in"] = seg.current
    finally:
        for f in undo:
            f()
        dbg.ADJ_SINGLE_SHOT_MAX_EDGES = adj_max
        torch.cuda.empty_cache()
    if parted:
        row["budgets"] = {
            "SINGLE_PASS_MAX_WINDOWS": dbg.SINGLE_PASS_MAX_WINDOWS,
            "DEVICE_PARTS_BUDGET": kcount.DEVICE_PARTS_BUDGET,
            "ADJ_SINGLE_SHOT_MAX_EDGES": dbg.ADJ_SINGLE_SHOT_MAX_EDGES,
        }
    return row


def measure_sharded(windows: float, coverage: float, n_shards: int) -> dict:
    import torch

    from mcaat_tpu_torch.parallel.sharded import make_pipeline_mesh
    from mcaat_tpu_torch.parallel.sharded_graph import build_sharded_dbg
    from mcaat_tpu_torch.utils import wire

    dev = torch.device("cuda", 0)
    codes, lengths = reads_for(windows, coverage)
    row = {
        "mode": f"sharded, {n_shards} shards on one card",
        "windows": int(codes.shape[0]) * 2 * (READ_LEN - K),
        "coverage": coverage,
        "reads": int(codes.shape[0]),
        "count_shard_rows": os.environ.get("MCAAT_COUNT_SHARD_ROWS", "default"),
    }
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    wire.reset()
    t0 = time.perf_counter()
    try:
        sg = build_sharded_dbg(
            make_pipeline_mesh([dev] * n_shards), codes, lengths, k=K, add_rc=True
        )
        torch.cuda.synchronize(dev)
        row["seconds"] = time.perf_counter() - t0
        row["peak"] = torch.cuda.max_memory_allocated(dev)
        row["bytes_per_window"] = row["peak"] / row["windows"]
        row["resident"] = torch.cuda.memory_allocated(dev)
        row.update(nodes=sg.n_nodes, parts=sg.n_parts, rows_per_shard=sg.n_live.tolist())
        row["wire_bytes"] = {k: v["bytes"] for k, v in wire.snapshot().items()}
        del sg
    except torch.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0]
    finally:
        torch.cuda.empty_cache()
    return row


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_build_peaks: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    parted = "--parted" in argv
    n_shards = 0
    if "--sharded" in argv:
        i = argv.index("--sharded")
        n_shards = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
    specs = [a for a in argv if a != "--parted"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{card}; total_memory {total} bytes", flush=True)
    for spec in specs or ["126e6:8", "495e6:8"]:
        w, c = spec.split(":")
        if n_shards:
            row = measure_sharded(float(w), float(c), n_shards)
        else:
            row = measure(float(w), float(c), parted)
        row.update(card=card, total_memory=total)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
