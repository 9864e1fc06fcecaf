#!/usr/bin/env python3
"""Times of the per-pair LCS kernel (``lcs_ratio_cuda``) and the fused
``partial_ratio_cuda`` on one CUDA card, for this checkout alone or beside
another checkout of the repository.

    python3 scripts/torch_lcs_times.py
    python3 scripts/torch_lcs_times.py --against DIR

``DIR`` is the root of another checkout (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each checkout builds its own kernels and is timed in a process of its own,
in the order other, this, this, other, so that both meet the same card in
the same minutes. Shapes:

- 900 pairs: the all-pairs lanes of a 30-spacer system (strings of 34 bases);
- 29,145 lanes: every alignment window of that system's 435 pairs, what
  ``partial_ratio`` gave the kernel before it had a kernel of its own;
- 1,048,576 pairs with both lengths drawn from [0, 64], with both lengths
  64, and with both lengths in [26, 40];
- ``partial_ratio_cuda`` on the 30-spacer system's 435 pairs.

A time is one launch's device milliseconds in a CUDA-graph replay
(``chip_smoke.graph_ms``). Every result of the other checkout must equal
this one's bit for bit. Where a checkout has the all-pairs kernel
(``ratio_matrix_cuda``) its times at 30 and 1,024 strings are printed too,
and at 1,024 strings its time for each number of columns a warp walks
(``lcs_cuda.matrix_run`` replaced by a constant for the measurement).
The last line is one JSON object with every time, the card's name and its
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's ``chip_smoke`` module (timers and input makers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, out_path: str) -> None:
    """Time the kernels of the checkout at ``root``; write the times and a
    digest of the results to ``out_path``."""
    import hashlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_lcs_times: needs a CUDA card")
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, root)
    from mcaat_tpu_torch.report import batched_fuzz as tfuzz
    from mcaat_tpu_torch.report import lcs_cuda
    from torch_fuzz_windows import expand_windows, rand_dna

    if not os.path.abspath(lcs_cuda.__file__).startswith(os.path.abspath(root) + os.sep):
        sys.exit(f"torch_lcs_times: imported {lcs_cuda.__file__}, not the checkout at {root}")
    smoke = _smoke()
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def up(arrays):
        return [torch.as_tensor(x, device=device) for x in arrays]

    system = [rand_dna(rng, 34) for _ in range(30)]
    table = up(tfuzz.encode_batch(system))
    shorts = [system[i] for i in range(30) for _ in range(i)]
    longs = [system[j] for i in range(30) for j in range(i)]
    a_list, b_list, _owner = expand_windows(shorts, longs)

    def drawn(lo: int, hi: int):
        pairs = smoke.random_pairs(rng, 1 << 20, device)
        for k in (1, 3):
            pairs[k] = torch.as_tensor(
                rng.integers(lo, hi + 1, 1 << 20).astype(np.int32), device=device
            )
        return pairs

    shapes = {
        "900 pairs": smoke.gathered_pairs(*table),
        "29,145 lanes": up(tfuzz.encode_batch(a_list) + tfuzz.encode_batch(b_list)),
        "1,048,576 pairs, lengths in [0, 64]": drawn(0, 64),
        "1,048,576 pairs, lengths 64": drawn(64, 64),
        "1,048,576 pairs, lengths in [26, 40]": drawn(26, 40),
    }
    assert shapes["29,145 lanes"][0].shape[0] == 29145
    times, digest = {}, hashlib.sha256()
    for name, inputs in shapes.items():
        lcs, ratio = lcs_cuda.lcs_ratio_cuda(*inputs)
        torch.cuda.synchronize()
        digest.update(lcs.cpu().numpy().tobytes() + ratio.cpu().numpy().tobytes())
        times[f"lcs_ratio, {name}"] = smoke.graph_ms(lambda: lcs_cuda.lcs_ratio_cuda(*inputs))
    # the fused partial_ratio kernel on that system's 435 pairs
    s_idx, l_idx = (
        torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)
        for x in zip(*((i, j) for i in range(30) for j in range(i)))
    )
    partial = lcs_cuda.partial_ratio_cuda(*table, s_idx, l_idx)
    torch.cuda.synchronize()
    digest.update(partial.cpu().numpy().tobytes())
    times["partial_ratio, 30 strings, 435 pairs"] = smoke.graph_ms(
        lambda: lcs_cuda.partial_ratio_cuda(*table, s_idx, l_idx)
    )
    if hasattr(lcs_cuda, "ratio_matrix_cuda"):
        big = smoke.random_table(rng, 1024, device)
        for name, inputs in (("30 strings", table), ("1,024 strings", big)):
            times[f"ratio_matrix, {name}"] = smoke.graph_ms(
                lambda: lcs_cuda.ratio_matrix_cuda(*inputs)
            )
        if hasattr(lcs_cuda, "matrix_run"):
            want, picked = lcs_cuda.ratio_matrix_cuda(*big), lcs_cuda.matrix_run
            for run in (1, 2, 4, 8, 16, 32, 64):
                lcs_cuda.matrix_run = lambda n, run=run: run
                if not torch.equal(lcs_cuda.ratio_matrix_cuda(*big), want):
                    sys.exit(f"torch_lcs_times: runs of {run} columns change the matrix")
                times[f"ratio_matrix, 1,024 strings, runs of {run}"] = smoke.graph_ms(
                    lambda: lcs_cuda.ratio_matrix_cuda(*big), 10, 20
                )
            lcs_cuda.matrix_run = picked
    with open(out_path, "w") as fh:
        json.dump({"times": times, "digest": digest.hexdigest()}, fh)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", help="root of another checkout to time beside this one")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    order = ["this"] if not args.against else ["other", "this", "this", "other"]
    roots = {"this": HERE, "other": os.path.abspath(args.against) if args.against else None}
    out_dir = os.path.join(HERE, "build", "torch_lcs_times")
    os.makedirs(out_dir, exist_ok=True)
    runs: dict = {"this": [], "other": []}
    for turn, which in enumerate(order):
        out_path = os.path.join(out_dir, f"turn_{turn}.json")
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", roots[which], out_path],
            check=True, cwd=roots[which],
        )
        with open(out_path) as fh:
            runs[which].append(json.load(fh))
    digests = {r["digest"] for rs in runs.values() for r in rs}
    if len(digests) != 1:
        sys.exit("torch_lcs_times: the checkouts' results differ")
    print(card)
    for name in runs["this"][0]["times"]:
        line = f"  {name}: this " + ", ".join(f"{r['times'][name]:.5f}" for r in runs["this"])
        others = [r["times"][name] for r in runs["other"] if name in r["times"]]
        if others:
            line += " ms; other " + ", ".join(f"{t:.5f}" for t in others)
        print(line + " ms")
    print(json.dumps({
        "card": card,
        "this": [r["times"] for r in runs["this"]],
        "other": [r["times"] for r in runs["other"]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
