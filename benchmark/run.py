"""Runs one cell of the benchmark of ``mcaat_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Set-up builds the program's libraries if they are not
built, writes the cell's FASTQ pair from ``--seed`` under ``$TMPDIR`` and
runs the first (cold) sample; the window then runs the same pair through
``mcaat_tpu_torch.cli.run_cli``, a sample after another, until
``--seconds`` have passed, finishing the sample in flight. Then the
reference checks the window's node tables and reports (``compare.py``).

Standard error ends with each number compared beside its limit;
standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last. Without CUDA, with fewer cards than
the cell asks for, or with JAX or ``mcaat_tpu`` loaded, the run exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root first, and not this folder: its module names stay
# under the package name "benchmark"
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") !=
                        os.path.dirname(os.path.abspath(__file__))]

from benchmark import harness  # noqa: E402


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for key in [k for k in os.environ if k.startswith("MCAAT_")]:
        del os.environ[key]  # the program runs as the CLI runs it: on one card, by default
    os.environ.update(harness.CACHE_ENV, MCAAT_TORCH_DEVICE="cuda")
    spec = harness.load_spec()
    cell = harness.load_cell(spec, args.workload)
    # the library build's child process starts first, beside this one's imports
    fd, build_log = tempfile.mkstemp(prefix="mcaat-bench-build-", suffix=".log")
    os.close(fd)
    build = harness.start_build(build_log)
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            harness.log(f"bench: {cell.name} needs {cell.chips} CUDA card(s), found {found}")
            return 2
        line = harness.execute(cell, args.seed, args.seconds, bool(args.trace), T_START,
                               build=build, build_log=build_log)
    finally:
        if build.poll() is None:
            build.kill()
        build.wait()
        os.unlink(build_log)
    for name, c in line["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
