"""The yardstick of the report's two kernels: the operations and bytes
that the data of a launch needs, whatever implements it, and the
published peaks of the card they are held against.

The counts are frozen from ``chip_smoke.py`` (``partial_ratio_bound``,
``ratio_matrix_bound``) and ``PERF.md`` section 6 at commit 9d644f4:

- bytes: every input and output once; 68 B a distinct string of the
  table (64 code bytes and a 4-byte length) and 12 B a pair (two 4-byte
  indices and the 4-byte score) for ``partial_ratio``; the table and 4 B a pair
  of the n x n matrix for ``ratio_matrix``;
- operations, in 32-bit integer operations: 20 a step of the
  bit-parallel LCS recurrence (about ten operations on 64-bit words) and
  8 a base of the row string to build its four match masks.
  ``partial_ratio`` takes one step per base of every non-empty alignment
  window of every pair; ``ratio_matrix`` needs the pairs i <= j only
  (the score is symmetric bit for bit), one step per base of the column
  string of each.

Peaks of one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet and the Hopper
architecture white paper): 132 SMs at a boost clock of 1.98 GHz, each
with 64 INT32 lanes (and 128 FP32 lanes, which give the data sheet's 67
TFLOP/s when a fused multiply-add counts as two operations). An integer
operation here is one instruction on one lane, a multiply-add counting
once, so the integer peak is 132 x 64 x 1.98e9 = 16.73e12 operations a
second. Device memory: 3.35e12 bytes a second. A card set below its
700 W limit runs under these rates, and the share then reads low.
"""

from __future__ import annotations

import numpy as np

SMS, INT32_LANES, BOOST_HZ = 132, 64, 1.98e9
PEAK_INT_OPS_S = SMS * INT32_LANES * BOOST_HZ
PEAK_BYTES_S = 3.35e12
STEP_OPS = 20
MASK_OPS = 8
MAXLEN = 64


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the integer peak."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_INT_OPS_S)


def partial_ratio_counts(shorts, longs) -> tuple[float, float]:
    """``(bytes, operations)`` of one ``partial_ratio`` launch over the
    pairs ``(shorts[i], longs[i])``: the table holds each distinct string
    once; the shorter string of a pair is held against every alignment
    window of the longer, window w starting at ``w - (ls - 1)``."""
    a = np.array([len(x) for x in shorts], dtype=np.int64)
    b = np.array([len(x) for x in longs], dtype=np.int64)
    ls, ll = np.minimum(a, b), np.maximum(a, b)
    w = np.arange(2 * MAXLEN - 1)[None, :]
    start = w - (ls[:, None] - 1)
    lw = np.minimum(ll[:, None], start + ls[:, None]) - np.clip(start, 0, None)
    live = (w < (ls - 1 + np.clip(ll, 1, None))[:, None]) & (ls[:, None] > 0)
    steps = int(np.clip(lw, 0, None)[live].sum())
    n_table = len(set(shorts) | set(longs))
    return 68.0 * n_table + 12.0 * len(ls), float(STEP_OPS * steps + MASK_OPS * ls.sum())


def ratio_matrix_counts(strings) -> tuple[float, float]:
    """``(bytes, operations)`` of one ``ratio_matrix`` launch over a table
    of ``n`` strings: the n(n+1)/2 pairs i <= j."""
    n = len(strings)
    bases = float(sum(len(x) for x in strings))
    return 68.0 * n + 4.0 * n * n, STEP_OPS * (n + 1) * bases / 2 + MASK_OPS * bases


COUNTS = {"partial_ratio": partial_ratio_counts, "ratio_matrix": ratio_matrix_counts}


def roofline_pct(kernel: str, calls: list, kernel_seconds: float) -> float | None:
    """100 x the least time of every launch of ``kernel`` over the time the
    trace gives the kernel; None when nothing was launched or timed.
    ``calls`` are those of ``probes.batched_scores``, ``(kernel, strings...,
    scores)``: one launch each."""
    launches = [c[1:-1] for c in calls if c[0] == kernel]
    if not launches or not kernel_seconds:
        return None
    least = sum(least_seconds(*COUNTS[kernel](*args)) for args in launches)
    return 100.0 * least / kernel_seconds
