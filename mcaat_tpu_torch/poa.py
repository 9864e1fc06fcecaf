"""Partial-order-alignment consensus (replaces the vendored spoa, N7).

The reference uses ``spoa::AlignmentEngine::Create(kNW, 3, -5, -3)`` +
``Graph::AddAlignment`` + ``GenerateConsensus``
(``src/phage_curator.cpp:385-396``). This is a self-contained progressive
POA: sequences align to a DAG with Needleman-Wunsch over the DAG's
topological order (match +3, mismatch -5, gap -3), alignments are folded
into the graph with edge weights, and the consensus is the
maximum-weight path.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

_log = logging.getLogger(__name__)

NEG = float("-inf")


@dataclass
class PoaGraph:
    match: int = 3
    mismatch: int = -5
    gap: int = -3
    bases: list[str] = field(default_factory=list)
    edges: dict[tuple[int, int], int] = field(default_factory=dict)
    in_edges: list[list[int]] = field(default_factory=list)

    def _add_node(self, base: str) -> int:
        self.bases.append(base)
        self.in_edges.append([])
        return len(self.bases) - 1

    def _add_edge(self, u: int, v: int, w: int = 1) -> None:
        if (u, v) not in self.edges:
            self.edges[(u, v)] = 0
            self.in_edges[v].append(u)
        self.edges[(u, v)] += w

    def _topo_order(self) -> list[int]:
        # nodes are created in a forward direction only (edges u < v is NOT
        # guaranteed after branching, so do a proper Kahn sort)
        n = len(self.bases)
        indeg = [0] * n
        out_adj: list[list[int]] = [[] for _ in range(n)]
        for (u, v), _w in self.edges.items():
            indeg[v] += 1
            out_adj[u].append(v)
        stack = sorted([i for i in range(n) if indeg[i] == 0], reverse=True)
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in sorted(out_adj[u], reverse=True):
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        return order

    def align(self, seq: str) -> list[tuple[int | None, int | None]]:
        """Global alignment of seq to the graph.

        Returns [(node_id | None, seq_pos | None)] pairs (None = gap).
        """
        order = self._topo_order()
        rank = {node: r for r, node in enumerate(order)}
        n, m = len(order), len(seq)
        # dp[r+1][j+1]: best score aligning graph-prefix (by rank) to seq[:j+1]
        dp = [[NEG] * (m + 1) for _ in range(n + 1)]
        bt: list[list[tuple[int, int, int | None, int | None] | None]] = [
            [None] * (m + 1) for _ in range(n + 1)
        ]
        dp[0][0] = 0.0
        for j in range(1, m + 1):
            dp[0][j] = dp[0][j - 1] + self.gap
            bt[0][j] = (0, j - 1, None, j - 1)
        for r, node in enumerate(order):
            preds = [rank[p] + 1 for p in self.in_edges[node]]
            if not preds:
                preds = [0]
            for j in range(0, m + 1):
                best = NEG
                best_bt = None
                for pr in preds:
                    # node aligned to seq[j-1]
                    if j > 0 and dp[pr][j - 1] != NEG:
                        s = dp[pr][j - 1] + (
                            self.match
                            if seq[j - 1] == self.bases[node]
                            else self.mismatch
                        )
                        if s > best:
                            best, best_bt = s, (pr, j - 1, node, j - 1)
                    # node skipped (gap in sequence)
                    if dp[pr][j] != NEG:
                        s = dp[pr][j] + self.gap
                        if s > best:
                            best, best_bt = s, (pr, j, node, None)
                # seq char inserted (gap in graph)
                if j > 0 and dp[r + 1][j - 1] != NEG:
                    s = dp[r + 1][j - 1] + self.gap
                    if s > best:
                        best, best_bt = s, (r + 1, j - 1, None, j - 1)
                if best > dp[r + 1][j]:
                    dp[r + 1][j] = best
                    bt[r + 1][j] = best_bt

        # find best end state: any node with no outgoing edge, full seq
        has_out = [False] * len(self.bases)
        for (u, _v) in self.edges:
            has_out[u] = True
        end_r, end_score = 0, dp[0][m]
        for r, node in enumerate(order):
            if not has_out[node] and dp[r + 1][m] > end_score:
                end_score = dp[r + 1][m]
                end_r = r + 1
        # backtrack
        path: list[tuple[int | None, int | None]] = []
        r, j = end_r, m
        while not (r == 0 and j == 0):
            step = bt[r][j]
            if step is None:
                break
            pr, pj, node, pos = step
            path.append((node, pos))
            r, j = pr, pj
        path.reverse()
        return path

    def add_sequence(self, seq: str) -> None:
        if not seq:
            return
        if not self.bases:
            prev = None
            for ch in seq:
                node = self._add_node(ch)
                if prev is not None:
                    self._add_edge(prev, node)
                prev = node
            return
        alignment = self.align(seq)
        prev: int | None = None
        for node, pos in alignment:
            if pos is None:
                continue  # graph node skipped
            ch = seq[pos]
            if node is not None and self.bases[node] == ch:
                cur = node
            else:
                cur = self._add_node(ch)
            if prev is not None:
                self._add_edge(prev, cur)
            prev = cur

    def consensus(self) -> str:
        """Maximum-weight path through the DAG."""
        if not self.bases:
            return ""
        order = self._topo_order()
        score = {node: 0.0 for node in order}
        back: dict[int, int | None] = {node: None for node in order}
        for node in order:
            for p in self.in_edges[node]:
                s = score[p] + self.edges[(p, node)]
                if s > score[node]:
                    score[node] = s
                    back[node] = p
        end = max(order, key=lambda nd: score[nd])
        out = []
        cur: int | None = end
        while cur is not None:
            out.append(self.bases[cur])
            cur = back[cur]
        return "".join(reversed(out))


def compute_consensus(sequences: list[str], match=3, mismatch=-5, gap=-3) -> str:
    """≙ ComputeConsensusForCurrentGroup (src/phage_curator.cpp:385-396).

    Native C++ fast path when built (result-identical port, see
    native/mcaat_host.cpp); this Python implementation is the fallback
    and the semantic model for the parity test.
    """
    if not sequences:
        return ""
    from mcaat_tpu_torch.native import poa_consensus

    res = poa_consensus(sequences, match=match, mismatch=mismatch, gap=gap)
    if res is not None:
        _log.info("POA consensus of %d sequences: native", len(sequences))
        return res
    # a host library, not the device: the fallback is logged, not silent
    _log.warning(
        "POA consensus of %d sequences: the native library is unavailable, "
        "using the Python implementation", len(sequences),
    )
    return compute_consensus_py(sequences, match=match, mismatch=mismatch, gap=gap)


def compute_consensus_py(sequences: list[str], match=3, mismatch=-5, gap=-3) -> str:
    """Pure-Python progressive POA (the native path's semantic model)."""
    if not sequences:
        return ""
    g = PoaGraph(match=match, mismatch=mismatch, gap=gap)
    for s in sequences:
        g.add_sequence(s)
    return g.consensus()
