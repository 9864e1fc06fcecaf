"""Node occurrence counting across cycles.

Functional equivalent of the reference's ``NodeCounter``
(``include/node_counter.h:7-47``) — a DEVELOP-only diagnostic struct that
is compiled out of both reference mains (its body sits under ``#ifdef
DEVELOP``, ``node_counter.h:12``, and its count map is keyed/updated
inconsistently). We implement the documented intent (header comment,
``node_counter.h:8-11``): count each node's occurrences across all cycles
and optionally keep only the nodes that occur exactly once.
"""

from __future__ import annotations

from collections import Counter


def count_nodes(cycles: dict[int, list[int]]) -> dict[int, int]:
    """node id -> number of occurrences across all cycles (insertion-stable)."""
    counts: Counter[int] = Counter()
    for nodes in cycles.values():
        counts.update(nodes)
    return dict(counts)


def unique_nodes(cycles: dict[int, list[int]]) -> dict[int, int]:
    """Only the nodes occurring exactly once across all cycles.

    ≙ NodeCounter::filter_only_unique_nodes (node_counter.h:27-35).
    """
    return {n: c for n, c in count_nodes(cycles).items() if c == 1}


class NodeCounter:
    """Literal-shape port of the reference struct (include/node_counter.h),
    including its position-keyed count map (the reference keys ``counts``
    by the node's index within its cycle, not by node id — preserved
    as-is; the documented-intent counting lives in :func:`count_nodes`).
    """

    def __init__(self, input_cycles: dict[int, list[int]]):
        self.input_cycles = input_cycles
        self.counts: dict[int, list] = {}
        self._count_nodes()

    def _count_nodes(self) -> None:
        for _cid, nodes in self.input_cycles.items():
            for i, node_id in enumerate(nodes):
                entry = self.counts.setdefault(i, [0, 0])
                entry[0] += 1
                entry[1] = node_id

    def filter_only_unique_nodes(self) -> None:
        self.counts = {k: v for k, v in self.counts.items() if v[0] == 1}

    def get_counts(self) -> dict[int, list]:
        return self.counts
