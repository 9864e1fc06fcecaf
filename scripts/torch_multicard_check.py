"""The sharded path of the torch port across several cards of one host.

Needs at least two visible CUDA cards (it stops otherwise). On the
planted metagenome of ``chip_smoke.py`` phase 5 (20 arrays of 30 spacers
in a 10 Mbp background, about 0.8M reads, 20M graph nodes):

1. one process, one shard a card: ``run_pipeline`` with ``--mesh off`` on
   the first card and with ``--mesh auto`` over all of them (card-to-card
   copies inside the exchange); the two reports must be equal byte for
   byte; stage seconds, exchanged bytes per stage and the largest peak
   memory of a card are printed;
2. one process a card over NCCL (``scripts/torch_multihost_dryrun.py
   --cuda``), first on that script's small synthetic input with its build
   and frontier checks, then on the planted metagenome with 1 and with 2
   shards a card: process 0's report must equal the single-device one.

Usage:  python scripts/torch_multicard_check.py
Prints one JSON line with the figures at the end; exit code 0 means every
comparison held.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
DRYRUN = os.path.join(REPO, "scripts", "torch_multihost_dryrun.py")


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_multicard_check: needs at least two CUDA cards", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    torch.cuda.init()  # the memory statistics below need the allocator up
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"{n} cards: {cards}", flush=True)

    from synthetic import make_metagenome, write_fastq

    from mcaat_tpu_torch.pipeline import run_pipeline
    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils import wire

    os.environ["MCAAT_TORCH_DEVICE"] = "cuda"
    os.environ.pop("MCAAT_TORCH_SHARDS", None)
    tmp = tempfile.mkdtemp(prefix="mcaat_multicard_")
    meta = make_metagenome(
        seed=7, n_arrays=20, n_spacers=30, background_len=10_000_000,
        background_coverage=8.0, coverage=35.0,
    )
    fq = os.path.join(tmp, "reads.fq")
    write_fastq(fq, meta["reads"])
    print(f"{len(meta['reads'])} reads", flush=True)
    del meta
    out: dict = {"cards": cards}

    # 1. one process, one shard a card
    runs = {}
    for mesh in ("off", "auto", "auto", "off"):
        wire.reset()
        s = Settings(input_files=fq, mesh=mesh, output_file=os.path.join(tmp, f"{mesh}.txt"))
        t0 = time.perf_counter()
        r = run_pipeline(s, verbose=False)
        for d in range(n):
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        # the profiler resets the peaks at every stage: the run's peak is
        # the largest stage peak, itself the largest over the cards
        peak = round(r.profile.peak_device_mb() / 1024, 3)
        used = [torch.cuda.memory_reserved(d) > 0 for d in range(n)]
        stages = {st.name: round(st.seconds, 3) for st in r.profile.stages}
        snap = {k: v["bytes"] for k, v in wire.snapshot().items() if v["bytes"]}
        print(f"--mesh {mesh}: wall {wall:.2f}s, stages {stages}, largest peak of a card "
              f"{peak} GiB, cards used {used}, exchanged bytes {snap}", flush=True)
        runs.setdefault(mesh, []).append(
            {"wall_s": wall, "stages_s": stages, "peak_gib": peak, "wire_bytes": snap,
             "cards_used": used}
        )
        runs[mesh + "_report"] = r.report_text
    if runs["auto_report"] != runs["off_report"] or "Number of Systems: 20" not in runs["auto_report"]:
        print("MISMATCH: --mesh auto over the cards != --mesh off", file=sys.stderr)
        return 1
    if not all(runs["auto"][-1]["cards_used"]):
        print("--mesh auto left a card unused", file=sys.stderr)
        return 1
    print(f"one process over {n} cards: report byte-identical to the single card's", flush=True)
    out["one_process"] = {k: v for k, v in runs.items() if not k.endswith("_report")}

    # 2. one process a card over NCCL
    out["process_group"] = {}
    for name, extra in (
        ("small", ["--shards", "1"]),
        ("planted_1_shard", ["--shards", "1", "--fastq", fq, "--k", "23"]),
        ("planted_2_shards", ["--shards", "2", "--fastq", fq, "--k", "23"]),
    ):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, DRYRUN, os.path.join(tmp, name), "--cuda", "--procs", str(n), *extra],
            capture_output=True, text=True, timeout=900,
        )
        wall = time.perf_counter() - t0
        print(res.stdout[-3000:], flush=True)
        if res.returncode != 0 or "MULTIHOST DRYRUN PASSED" not in res.stdout:
            print(res.stderr[-3000:], file=sys.stderr)
            print(f"the {name} run over {n} processes failed", file=sys.stderr)
            return 1
        print(f"{name}: {n} processes, one card each, passed in {wall:.1f}s", flush=True)
        out["process_group"][name] = {
            "wall_s": wall,
            "lines": [x for x in res.stdout.splitlines() if x.startswith(("mesh ", "wire:"))],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
