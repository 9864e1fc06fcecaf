"""Edit-distance similarity scoring (rapidfuzz-compatible semantics).

Replaces the vendored rapidfuzz-cpp (reference
``include/post_processing.h:114,135``):

* ``ratio(a, b)``   = 100 * (1 - indel_distance / (len(a)+len(b))), where
  indel distance counts insertions+deletions only (a substitution costs 2)
  — exactly rapidfuzz's ``fuzz::ratio``.
* ``partial_ratio(a, b)`` = best ``ratio`` of the shorter string against
  any alignment window of the longer one.

The LCS inside ``ratio`` uses Hyyrö's bit-parallel algorithm (O(n·m/w));
spacer-scale strings (≤ 50 bp) need a single machine word. Device-side
bulk scoring with the same semantics lives in ``report/batched_fuzz.py``
(parity-tested against this module).
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=1 << 16)
def _match_masks(s: str) -> dict[str, int]:
    masks: dict[str, int] = {}
    for i, ch in enumerate(s):
        masks[ch] = masks.get(ch, 0) | (1 << i)
    return masks


def lcs_length(a: str, b: str) -> int:
    """Length of the longest common subsequence (bit-parallel)."""
    m = len(a)
    if m == 0 or len(b) == 0:
        return 0
    masks = _match_masks(a)
    full = (1 << m) - 1
    s = full
    for ch in b:
        mv = masks.get(ch, 0)
        u = s & mv
        s = ((s + u) | (s - u)) & full
    return m - bin(s).count("1")


def indel_distance(a: str, b: str) -> int:
    return len(a) + len(b) - 2 * lcs_length(a, b)


def ratio(a: str, b: str) -> float:
    """rapidfuzz ``fuzz::ratio`` semantics, in [0, 100]."""
    total = len(a) + len(b)
    if total == 0:
        return 100.0
    return 100.0 * (2.0 * lcs_length(a, b)) / total


def partial_ratio(a: str, b: str) -> float:
    """rapidfuzz ``fuzz::partial_ratio`` semantics.

    The shorter string is scored against every alignment window of the
    longer (including clipped edge windows); the best score wins.
    """
    shorter, longer = (a, b) if len(a) <= len(b) else (b, a)
    ls, ll = len(shorter), len(longer)
    if ls == 0:
        return 100.0 if ll == 0 else 0.0
    if ls == ll:
        return ratio(shorter, longer)
    best = 0.0
    for start in range(-(ls - 1), ll):
        window = longer[max(0, start) : max(0, start + ls)]
        if not window:
            continue
        score = ratio(shorter, window)
        if score > best:
            best = score
            if best >= 100.0:
                break
    return best
