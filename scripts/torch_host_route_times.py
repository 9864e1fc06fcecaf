"""Time the report's host route on this host, route by route.

    python3 scripts/torch_host_route_times.py [--traffic short-arrays] [--seed 1]
        [--turns 3] [--json F]

Draws the planted arrays of a benchmark traffic
(``benchmark/traffic/<name>.json``: its array count, spacer counts and
shape seed; the bases from ``--seed``; no reads) and runs the report on
them as the pipeline's last stage does: ``CRISPRAnalyzer.run_analysis``
on ``{repeat: spacers}``, whose substring filter and diversity check take
the host route for every system of ``BATCH_THRESHOLD`` spacers or fewer.
In turns:

- ``python``: the loops over ``report/fuzz.py`` (the compiled library
  forced off), the route every system took before ``native/fuzz.cpp``;
- ``compiled``: ``native/fuzz.cpp``.

Each turn reads the analyzer's ``host_route`` timer and its
``host_route_pairs`` and ``host_route_compiled_pairs`` counters, and
checks the report's text equal to the first ``python`` turn's. Prints a
line a turn and one JSON line at the end: each route's median seconds
and microseconds a pair. Runs on the CPU (no batched call below the
threshold; above it the batched route takes its plain torch twin, whose
time is not in the host route's timer).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

from benchmark.fragments import templates  # noqa: E402
from mcaat_tpu_torch import native  # noqa: E402
from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer  # noqa: E402
from mcaat_tpu_torch.utils.profiling import Profiler  # noqa: E402


def _systems(traffic: str, seed: int) -> dict[str, list[str]]:
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic}.json")) as fh:
        p = json.load(fh)["params"]
    _, arrays, _ = templates(seed, p["n_arrays"], p["spacer_counts"], 1.0, 0, 0.0,
                             shape_seed=p.get("shape_seed"))
    return {a["repeat"]: a["spacers"] for a in arrays}


def _report(systems) -> tuple[str, float, int, int]:
    """The report's text, the host route's seconds, its pairs and those
    the compiled code scored."""
    prof = Profiler()
    with prof.stage("report"):
        text = CRISPRAnalyzer(systems, os.devnull, device="cpu").run_analysis()
    rec = prof.span_records()[0]
    ctr = rec["counters"]
    return (text, rec["timers"]["host_route"]["seconds"], ctr["host_route_pairs"],
            ctr["host_route_compiled_pairs"])


def _run(route: str, systems):
    if route == "compiled":
        return _report(systems)
    saved = native._fuzz, native._fuzz_tried
    native._fuzz, native._fuzz_tried = None, True
    try:
        return _report(systems)
    finally:
        native._fuzz, native._fuzz_tried = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", default="short-arrays")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--json")
    args = ap.parse_args()
    t0 = time.perf_counter()
    built = native._load_fuzz() is not None
    print(f"fuzz library {'loaded' if built else 'NOT built'} in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    if not built:
        return 1
    systems = _systems(args.traffic, args.seed)
    want = None
    seconds: dict[str, list[float]] = {"python": [], "compiled": []}
    pairs: dict[str, int] = {}
    compiled_pairs: dict[str, int] = {}
    for turn in range(args.turns):
        order = ("python", "compiled") if turn % 2 == 0 else ("compiled", "python")
        for route in order:
            text, s, n, nc = _run(route, systems)
            if want is None:
                want = text
            if text != want:
                raise SystemExit(f"turn {turn} {route}: the report differs")
            seconds[route].append(s)
            pairs[route], compiled_pairs[route] = n, nc
            print(f"turn {turn} {route}: {s:.4f}s over {n} pairs ({nc} compiled), "
                  f"{s / max(n, 1) * 1e6:.2f} us a pair", flush=True)
    if pairs["python"] != pairs["compiled"] or compiled_pairs["compiled"] != pairs["compiled"]:
        raise SystemExit(f"pairs differ: {pairs}, compiled {compiled_pairs}")
    median = {k: statistics.median(v) for k, v in seconds.items()}
    result = {
        "traffic": args.traffic,
        "seed": args.seed,
        "systems": len(systems),
        "pairs": pairs["compiled"],
        "cpus": native.parse_threads(),
        "median_s": median,
        "us_per_pair": {k: v / max(pairs[k], 1) * 1e6 for k, v in median.items()},
        "times_s": seconds,
    }
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
