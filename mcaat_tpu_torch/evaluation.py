"""Benchmark-mode evaluation against expected sequences.

≙ reference ``src/evaluation.cpp`` / ``include/evaluation.h``: plain
Levenshtein similarity (1 - d/max_len), duplicate-spacer counting, greedy
best-match per found system.
"""

from __future__ import annotations

import numpy as np


def get_levenshtein_distance(s1: str, s2: str) -> int:
    """Unit-cost Levenshtein distance (vectorized row DP)."""
    if not s1:
        return len(s2)
    if not s2:
        return len(s1)
    a = np.frombuffer(s1.encode(), dtype=np.uint8)
    b = np.frombuffer(s2.encode(), dtype=np.uint8)
    n = len(a)
    idx = np.arange(n + 1, dtype=np.int32)
    prev = idx.copy()
    for y in range(1, len(b) + 1):
        sub = prev[:-1] + (a != b[y - 1])
        dele = prev[1:] + 1
        c = np.concatenate(([np.int32(y)], np.minimum(sub, dele)))
        # insertion closure via prefix-min scan:
        # cur[x] = min_{j<=x}(c[j] + (x - j))
        prev = np.minimum.accumulate(c - idx) + idx
    return int(prev[-1])


def get_string_similarity(s1: str, s2: str) -> float:
    """1 - d / max(len); ≙ evaluation.cpp:50-55."""
    d = get_levenshtein_distance(s1, s2)
    max_size = max(len(s1), len(s2))
    if max_size == 0:
        return 1.0
    return 1.0 - d / max_size


def get_number_of_duplicate_spacers(spacers: list[str], expected_sequence: str) -> int:
    """Count extra (overlapping) occurrences of each spacer; ≙ :57-78."""
    result = 0
    for spacer in spacers:
        count = 0
        pos = 0
        while True:
            pos = expected_sequence.find(spacer, pos)
            if pos < 0:
                break
            count += 1
            pos += 1
        if count > 1:
            result += count - 1
    return result


def get_most_similar_sequence(sequence: str, choices: list[str]) -> str:
    """Greedy best match; ≙ :80-106."""
    if not choices:
        return ""
    best_sim = -1.0
    best = ""
    for choice in choices:
        sim = get_string_similarity(sequence, choice)
        if sim > best_sim:
            best_sim = sim
            best = choice
    return best
