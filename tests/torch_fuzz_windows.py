"""Inputs for the ``partial_ratio`` checks of the PyTorch port, and the
expanded-window route its fused kernel is held against.

Shared by ``tests/test_torch_fuzz.py`` and ``chip_smoke.py``; imports
numpy and the port only.

The expanded route is how ``mcaat_tpu.report.batched_fuzz.partial_ratio_pairs``
computes the score: every alignment window of every pair is cut out on
the host and becomes a lane of a batched ``ratio`` call, and the
per-pair maximum is reduced on the host.
"""

from __future__ import annotations

import numpy as np

from mcaat_tpu_torch.report.batched_fuzz import encode_batch

EDGE_LENGTHS = (0, 1, 2, 31, 32, 33, 63, 64)  # word edges of the 64-bit DP row


def rand_dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def expand_windows(shorts: list[str], longs: list[str]):
    """``(a_list, b_list, owner)``: one lane per non-empty alignment window
    of each pair (the shorter string against a window of the longer;
    ``shorts[i]`` is windowed over ``longs[i]`` when the lengths tie)."""
    a_list, b_list, owner = [], [], []
    for idx, (a, b) in enumerate(zip(shorts, longs)):
        s, l = (a, b) if len(a) <= len(b) else (b, a)
        ls, ll = len(s), len(l)
        if ls == 0:
            a_list.append(s)
            b_list.append(l)
            owner.append(idx)
            continue
        for start in range(-(ls - 1), max(ll, 1)):
            win = l[max(0, start) : max(0, start + ls)]
            if not win:
                continue
            a_list.append(s)
            b_list.append(win)
            owner.append(idx)
    return a_list, b_list, owner


def expanded_partial_ratio(shorts: list[str], longs: list[str], ratio_fn) -> np.ndarray:
    """``partial_ratio`` per pair by the expanded route. ``ratio_fn`` maps
    numpy ``(a_codes, a_lengths, b_codes, b_lengths)`` to the float32
    ``ratio`` of each lane as a numpy array."""
    a_list, b_list, owner = expand_windows(shorts, longs)
    r = ratio_fn(*encode_batch(a_list), *encode_batch(b_list))
    out = np.zeros(len(shorts), dtype=np.float32)
    for lane, idx in enumerate(owner):
        out[idx] = max(out[idx], r[lane])
    return out


def edge_pairs(rng, short_lengths=EDGE_LENGTHS, long_lengths=EDGE_LENGTHS):
    """``(shorts, longs)`` over every length pair of the two lists: random
    bases in both argument orders, and the first string planted inside
    the second (score 100) where it fits."""
    shorts, longs = [], []
    for ls in short_lengths:
        for ll in long_lengths:
            a, b = rand_dna(rng, ls), rand_dna(rng, ll)
            shorts += [a, b]
            longs += [b, a]
            if ls <= ll:
                at = int(rng.integers(0, ll - ls + 1))
                shorts.append(a)
                longs.append(b[:at] + a + b[at + ls :])
    return shorts, longs
