"""Repeat/spacer extraction from ordered cycles.

Faithful reimplementation of ``get_systems`` (reference
``src/tmp_utils.cpp:201-323``): the repeat/spacer boundary is found by
scanning cycle positions for base branch points (with point-mutation
tolerance), the repeat length is ``ext_left + ext_right - k`` (the
reference's arithmetic, tmp_utils.cpp:266 — preserved verbatim including
its quirks, SURVEY §7.3 risk 3), each cycle is rotated so the repeat
leads, and the consensus repeat is the most frequent per-cycle repeat.

All base accesses are direct bit ops on the packed k-mer table (a node's
contributed base is the LAST base of its label, ``kmers[v] & 3``; the
branch scans need the FIRST base, ``kmers[v] >> 2(k-1)``) — no string
labels are ever materialized, unlike the reference's per-node GetLabel
buffers.
"""

from __future__ import annotations

import numpy as np

from mcaat_tpu_torch.graph.dbg import HostDBG

_DECODE = np.frombuffer(b"ACGT", dtype="S1")


def get_systems(
    graph: HostDBG, ordered_cycles: list[list[int]]
) -> tuple[str, list[str], str]:
    """Returns (consensus_repeat, spacers, full_sequence)."""
    k = graph.k
    km = graph.kmers
    smallest = min(len(c) for c in ordered_cycles)
    cyc_arrs = [np.asarray(c, dtype=np.int64) for c in ordered_cycles]
    first_shift = np.int64(2 * (k - 1))

    # Repeat extension to the right (ref tmp_utils.cpp:212-237):
    # scan forward; a position where the *first* base of the labels
    # branches ends the repeat unless the very next position re-converges
    # (point mutation). branch[i] == True iff cycles disagree at column i.
    firsts = np.stack(
        [(km[c[:smallest]] >> first_shift) & 3 for c in cyc_arrs]
    )  # [C, smallest]
    branch_f = (firsts != firsts[0]).any(axis=0)
    extension_to_right = 0
    for i in range(smallest - 1):
        if branch_f[i] and branch_f[i + 1]:
            extension_to_right = i
            break

    # Repeat extension to the left (ref tmp_utils.cpp:239-264): scan
    # backward from each cycle's end comparing the *last* base.
    lasts = np.stack(
        [km[c[len(c) - smallest :][::-1]] & 3 for c in cyc_arrs]
    )  # [C, smallest]; column i == base of c[len(c)-i-1]
    branch_l = (lasts != lasts[0]).any(axis=0)
    extension_to_left = 0
    for i in range(smallest - 1):
        if branch_l[i] and branch_l[i + 1]:
            extension_to_left = i
            break

    repeat_length = extension_to_left + extension_to_right - k  # ref :266

    # Rotate each cycle so the repeat leads; first repeat_length nodes
    # contribute to the repeat, the rest to the spacer (ref :268-290).
    spacers: list[str] = []
    repeats: list[str] = []
    for c in cyc_arrs:
        n = len(c)
        offset_repeat = n - extension_to_left
        idx = (offset_repeat + np.arange(n)) % n
        chars = _DECODE[(km[c[idx]] & 3).astype(np.int64)]
        n_rep = min(max(repeat_length, 0), n)
        repeats.append(chars[:n_rep].tobytes().decode())
        spacers.append(chars[n_rep:].tobytes().decode())

    # Consensus = most frequent repeat (ref :292-305). Tie-break is the
    # reference's first-seen-in-map order; we use first-seen order.
    repeat_count: dict[str, int] = {}
    for r in repeats:
        repeat_count[r] = repeat_count.get(r, 0) + 1
    consensus_repeat = ""
    max_count = 0
    for r, c in repeat_count.items():
        if c > max_count:
            max_count = c
            consensus_repeat = r

    # full_sequence: (consensus repeat, spacer) pairs for cycles whose
    # repeat equals the consensus, plus a trailing consensus repeat
    # (ref :307-321).
    parts: list[str] = []
    for r, s in zip(repeats, spacers):
        if r == consensus_repeat:
            parts.append(r)
            parts.append(s)
    parts.append(consensus_repeat)
    full_sequence = "".join(parts)

    return consensus_repeat, spacers, full_sequence
