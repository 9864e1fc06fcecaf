#!/usr/bin/env python3
"""One traced run of the port's pipeline on one CUDA card: where the
device's time goes, and how much of the run the device sits idle.

Makes the planted-20x30 metagenome of ``PERF.md`` §4
(``tests/synthetic.make_metagenome(seed=7, n_arrays=20, n_spacers=30,
background_len=10_000_000, background_coverage=8.0, coverage=35.0)``; with
``--background-len N`` another background), runs the pipeline once
untraced to warm the process (kernel library, allocator), then once
inside ``mcaat_tpu_torch.utils.profiling.device_trace`` and prints

* the stage seconds of the untraced and the traced run (the difference is
  what the instrumentation costs when it is on),
* the device's busy time (the sum of the trace's kernel, memcpy and
  memset durations) and its idle share of the traced run's wall time,
* the top operations by device time (``key_averages()`` rows of the host
  operations, by the device time of the kernels each launched) and the
  top kernels by name,

each with the card's name and power limit. The Chrome trace itself stays
in ``build/torch_trace/`` (it is large). The last line is one JSON object
with the same numbers. Run from the repository root:

    python3 scripts/torch_trace_run.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_run: needs a CUDA card", file=sys.stderr)
        return 1
    background_len = 10_000_000
    if len(argv) == 2 and argv[0] == "--background-len":
        background_len = int(float(argv[1]))
    elif argv:
        print("usage: torch_trace_run.py [--background-len N]", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import make_metagenome, write_fastq

    from mcaat_tpu_torch.pipeline import run_pipeline
    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils.profiling import device_trace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    meta = make_metagenome(
        seed=7, n_arrays=20, n_spacers=30, background_len=background_len,
        background_coverage=8.0, coverage=35.0,
    )
    trace_dir = os.path.join(ROOT, "build", "torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    for f in os.listdir(trace_dir):
        os.remove(os.path.join(trace_dir, f))
    out: dict = {"card": card, "reads": len(meta["reads"]), "background_len": background_len}
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, meta["reads"])
        del meta

        def run(name: str):
            s = Settings(input_files=fq, output_file=os.path.join(tmp, f"{name}.txt"), mesh="off")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                r = run_pipeline(s, verbose=False, device=device)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        run("warm")
        plain, plain_wall = run("plain")
        t0 = time.perf_counter()
        with device_trace(trace_dir) as prof:
            traced, traced_wall = run("traced")
        export_s = time.perf_counter() - t0 - traced_wall
        if traced.report_text != plain.report_text:
            print("torch_trace_run: the traced run's report differs", file=sys.stderr)
            return 1

    def stages(r):
        return {s.name: round(s.seconds, 4) for s in r.profile.stages}

    out.update(untraced_wall_s=plain_wall, traced_wall_s=traced_wall,
               trace_stop_and_export_s=export_s,
               untraced_stages_s=stages(plain), traced_stages_s=stages(traced))
    print(f"untraced: {plain_wall:.3f}s {stages(plain)}")
    print(f"traced:   {traced_wall:.3f}s {stages(traced)} (+{export_s:.1f}s to stop and write the trace)")

    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    with open(os.path.join(trace_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev_events:
        print("torch_trace_run: the trace holds no device activity", file=sys.stderr)
        return 1
    busy_us = sum(e["dur"] for e in dev_events)
    first = min(e["ts"] for e in dev_events)
    last = max(e["ts"] + e["dur"] for e in dev_events)
    out.update(
        trace_events=len(events), device_events=len(dev_events),
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / traced_wall,
        first_to_last_device_event_s=(last - first) / 1e6,
    )
    print(f"device: {len(dev_events)} kernels and copies, busy {busy_us / 1e3:.1f} ms of "
          f"{traced_wall:.3f}s: idle share {out['device_idle_share']:.4f} ({card})")
    by_cat: dict = {}
    by_kernel: dict = {}
    for e in dev_events:
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + e["dur"]
        key = e["name"] if e["cat"] == "kernel" else e["cat"] + " " + e["name"]
        n, us = by_kernel.get(key, (0, 0))
        by_kernel[key] = (n + 1, us + e["dur"])
    out["device_ms_by_category"] = {k: v / 1e3 for k, v in by_cat.items()}
    print(f"by category (ms): {out['device_ms_by_category']}")
    top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    out["top_kernels"] = [{"name": k[:160], "calls": n, "ms": us / 1e3} for k, (n, us) in top_k]
    print("top kernels by device time:")
    for k, (n, us) in top_k:
        print(f"  {us / 1e3:9.2f} ms  {n:7d} calls  {k[:120]}")

    def self_device_us(row) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(row, attr):
                return float(getattr(row, attr))
        raise AttributeError("key_averages rows have no device time")

    rows = [r for r in prof.key_averages() if str(r.device_type).endswith("CPU")]
    rows.sort(key=lambda r: -self_device_us(r))
    out["top_operations"] = [
        {"name": r.key, "calls": r.count, "device_ms": self_device_us(r) / 1e3,
         "host_ms": float(r.self_cpu_time_total) / 1e3} for r in rows[:8]
    ]
    print("top operations by the device time of their kernels:")
    for o in out["top_operations"]:
        print(f"  {o['device_ms']:9.2f} ms device  {o['host_ms']:9.2f} ms host  "
              f"{o['calls']:7d} calls  {o['name']}")
    out["host_operations"] = int(sum(r.count for r in rows))
    print(f"{out['host_operations']} recorded host operations in all")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
