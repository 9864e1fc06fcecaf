"""The readings that the limits of ``checks/<workload>.json`` are set from,
taken on the card at a cell's own size: not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds S1 S2 ... [--faults N] [--json PATH]

For each seed, in one process: the cell's input, one sample through
``cli.run_cli`` with the node-table digest hook (the sound reading), the
reference, and

- the controls, each in the program's place against the reference: the
  reference kept in int32 k-mers (``keep_bits=32``), and the reference's
  scores of the report's batched calls rounded to float16;
- on the first ``--faults`` seeds, faults planted in the program's
  output: a base of every reported spacer altered, every system of the
  report written twice, half of the reads of each file left out of the
  graph build (a second sample), and, where the sample made batched
  calls, both kernels giving 0 for every score (a third sample).

Every number of ``compare.NAMES`` is printed for each, and the whole is
written as JSON to ``--json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") !=
                        os.path.dirname(os.path.abspath(__file__))]

from benchmark import compare, fragments, harness, probes, reference  # noqa: E402

SWAP = str.maketrans("ACGT", "CATG")


def altered(report: bytes) -> bytes:
    """The report with the middle base of every spacer changed."""
    text = report.decode()
    spacers = set(reference.report_spacers(text))
    return "\n".join(ln[: len(ln) // 2] + ln[len(ln) // 2].translate(SWAP) + ln[len(ln) // 2 + 1:]
                     if ln in spacers else ln for ln in text.split("\n")).encode()


def twice(report: bytes) -> bytes:
    """The report with every system's block written twice."""
    head, sep, rest = report.decode().partition("-" * 50 + "\n")
    body, tail = rest.rsplit("Number of Systems:", 1)
    return (head + sep + body + body + "Number of Systems:" + tail).encode()


@contextlib.contextmanager
def zero_kernels():
    import torch

    from mcaat_tpu_torch.report import batched_fuzz

    saved = batched_fuzz.partial_ratio_table, batched_fuzz.ratio_matrix
    batched_fuzz.partial_ratio_table = lambda codes, lengths, s_idx, l_idx: torch.zeros(
        s_idx.shape[0], dtype=torch.float32, device=codes.device)
    batched_fuzz.ratio_matrix = lambda codes, lengths: torch.zeros(
        (codes.shape[0],) * 2, dtype=torch.float32, device=codes.device)
    try:
        yield
    finally:
        batched_fuzz.partial_ratio_table, batched_fuzz.ratio_matrix = saved


@contextlib.contextmanager
def half_the_reads():
    from mcaat_tpu_torch import pipeline
    from mcaat_tpu_torch.io.fastq import ReadBatch

    orig = pipeline._load_input_batches

    def half(settings):
        return [(p, ReadBatch(codes=b.codes[::2], lengths=b.lengths[::2]))
                for p, b in orig(settings)]

    pipeline._load_input_batches = half
    try:
        yield
    finally:
        pipeline._load_input_batches = orig


def free(device: str):
    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def one_seed(cell, seed: int, faults: bool, tmp: str, device: str = "cuda") -> dict:
    made = fragments.write_input(os.path.join(tmp, "input"), seed=seed % (1 << 64),
                                 **cell.params())
    console = os.path.join(tmp, "console.log")
    digests, calls = [], []
    with probes.graph_digests(digests), probes.batched_scores(calls):
        got = harness.sample(made["files"], os.path.join(tmp, "out"), console, device == "cuda")
    free(device)
    codes, lengths = reference.encode_reads(made["mates"], made["lengths"])
    report, arrays = got["report"], made["arrays"]
    t0 = time.perf_counter()
    ref = compare.reference_for(codes, lengths, report, device)
    gap = reference.score_gap(calls, device)
    ref_s = time.perf_counter() - t0
    out = {"seed": seed, "sample_s": got["wall_s"], "reference_s": ref_s, "nodes": ref["nodes"],
           "batched_calls": len(calls),
           "sound": compare.readings(ref, digests, 1, [report], report, arrays, gap)}
    ctrl = compare.reference_for(codes, lengths, report, device, keep_bits=32)
    out["control"] = compare.readings(ref, [ctrl], 1, [report], report, arrays, gap)
    out["control_scores_f16"] = compare.readings(
        ref, digests, 1, [report], report, arrays,
        reference.score_gap(calls, device, dtype=np.float16))
    if faults:
        bad = altered(report)
        ref_bad = compare.reference_for(codes, lengths, bad, device)
        out["fault_spacer_base"] = compare.readings(ref_bad, digests, 1, [bad], bad, arrays, gap)
        dup = twice(report)
        out["fault_systems_twice"] = compare.readings(ref, digests, 1, [dup], dup, arrays, gap)
        half_digests: list = []
        with probes.graph_digests(half_digests), half_the_reads():
            half = harness.sample(made["files"], os.path.join(tmp, "half"), console,
                                  device == "cuda")
        free(device)
        out["fault_half_reads"] = compare.readings(ref, half_digests, 1, [half["report"]],
                                                   report, arrays, gap)
        if calls:
            zero_calls: list = []
            with probes.batched_scores(zero_calls), zero_kernels():
                zero = harness.sample(made["files"], os.path.join(tmp, "zero"), console,
                                      device == "cuda")
            free(device)
            ref_zero = compare.reference_for(codes, lengths, zero["report"], device)
            out["fault_kernels_zero"] = compare.readings(
                ref_zero, digests, 1, [zero["report"]], zero["report"], arrays,
                reference.score_gap(zero_calls, device))
            out["fault_kernels_zero"]["report_changed"] = int(zero["report"] != report)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("MCAAT_")]:
        del os.environ[key]
    os.environ.update(harness.CACHE_ENV, MCAAT_TORCH_DEVICE="cuda")
    cell = harness.load_cell(harness.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log("control: no CUDA card")
        return 2
    harness.build_libraries()
    results = []
    for i, seed in enumerate(args.seeds):
        tmp = tempfile.mkdtemp(prefix="mcaat-control-")
        try:
            results.append(one_seed(cell, seed, i < args.faults, tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        r = results[-1]
        harness.log(f"control: seed {seed}: sample {r['sample_s']:.2f}s, reference "
                    f"{r['reference_s']:.2f}s; " + json.dumps({k: v for k, v in r.items()
                                                             if isinstance(v, dict)}))
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"workload": cell.name, "card": torch.cuda.get_device_name(0),
                           "results": results}, fh, indent=1)
    print(json.dumps({"workload": cell.name, "seeds": len(results),
                      "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
