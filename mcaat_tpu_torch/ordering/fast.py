"""Vectorized constraint pipeline for spacer ordering.

Numerically identical to the tuple-list implementation in
``ordering.ordering`` (which mirrors the reference line by line), but
built on numpy: constraints are generated as arrays per read
(triangular index pairs over the *unmerged* in-cycle index sequence —
the reference's quirk) and aggregated once into (unique edge, weight)
form. The MST/greedy-resolution/toposort stages consume weights instead
of re-counting repeated tuples, which removes the O(#constraints)
Python loops — the reference generates hundreds of thousands of
quadratic pair constraints per subproblem (src/spacer_ordering.cpp:400).
"""

from __future__ import annotations

import numpy as np

from mcaat_tpu_torch.ordering.ordering import (
    NOT_IN_ANY_CYCLE_INDEX,
    get_all_cycle_indices,
    get_node_to_unique_cycle_map,
)


def _index_lut(node_to_cycle_map: dict[int, int]):
    keys = np.fromiter(node_to_cycle_map.keys(), dtype=np.int64)
    vals = np.fromiter(
        (node_to_cycle_map[k] for k in keys), dtype=np.int64, count=len(keys)
    )
    order = np.argsort(keys)
    return keys[order], vals[order]


_TRIU_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _triu(m: int) -> tuple[np.ndarray, np.ndarray]:
    r = _TRIU_CACHE.get(m)
    if r is None:
        r = np.triu_indices(m, 1)
        _TRIU_CACHE[m] = r
    return r


def generate_constraints_arrays(
    reads: list[list[int]], node_to_cycle_map: dict[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """All constraints as (unique_edges [M,2] int64, weights [M] int64).

    Semantics: per read, every in-order pair of distinct in-cycle indices
    over the unmerged sequence (≙ generate_constraints_from_read), plus
    the first merged transition when both read endpoints are mapped
    (≙ generate_out_of_cycles_constraints_from_read).
    """
    from mcaat_tpu_torch.reads.chains import Chains

    if not node_to_cycle_map:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    keys, vals = _index_lut(node_to_cycle_map)
    # flat chains come in flat (Chains) — one batched lookup for all reads
    chains = Chains.from_lists(reads)
    chains = chains.select(np.nonzero(chains.lengths() > 0)[0])
    if len(chains) == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    flat = chains.flat
    offs = chains.offsets
    pos = np.searchsorted(keys, flat)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit_all = keys[pos_c] == flat
    vals_all = vals[pos_c]

    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    for r in range(len(chains)):
        lo, hi = offs[r], offs[r + 1]
        hit = hit_all[lo:hi]
        seq = vals_all[lo:hi][hit]  # in-cycle indices, read order (unmerged)
        m = len(seq)
        if m >= 2:
            iu, ju = _triu(m)
            a, b = seq[iu], seq[ju]
            neq = a != b
            srcs.append(a[neq])
            dsts.append(b[neq])
        # out-of-cycles constraint: both endpoints mapped
        if m and hit[0] and hit[-1]:
            full = np.where(hit, vals_all[lo:hi], NOT_IN_ANY_CYCLE_INDEX)
            keep = np.ones(len(full), dtype=bool)
            keep[1:] = full[1:] != full[:-1]
            merged = full[keep]
            if len(merged) > 1:
                srcs.append(np.asarray([merged[0]], dtype=np.int64))
                dsts.append(np.asarray([merged[1]], dtype=np.int64))
    if not srcs:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    edges = np.stack(
        [np.concatenate(srcs), np.concatenate(dsts)], axis=1
    )
    # aggregate to unique rows + weights
    key = edges[:, 0] << np.int64(33) | edges[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    out = np.stack([uniq >> np.int64(33), uniq & ((1 << 33) - 1)], axis=1)
    return out, counts.astype(np.int64)


def maximal_spanning_tree_w(
    edges: np.ndarray, weights: np.ndarray
) -> set[tuple[int, int]]:
    """Kruskal, weight desc then edge desc (≙ reference sort order)."""
    parent: dict[int, int] = {}
    rank: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x: int, y: int) -> bool:
        rx, ry = find(x), find(y)
        if rx == ry:
            return False
        if rank.setdefault(rx, 0) < rank.setdefault(ry, 0):
            parent[rx] = ry
        elif rank[rx] > rank[ry]:
            parent[ry] = rx
        else:
            parent[ry] = rx
            rank[rx] += 1
        return True

    order = np.lexsort((edges[:, 1], edges[:, 0], weights))[::-1]
    mst: set[tuple[int, int]] = set()
    for i in order:
        u, v = int(edges[i, 0]), int(edges[i, 1])
        if union(u, v):
            mst.add((u, v))
    return mst


def order_cycles_fast(
    reads: list[list[int]],
    cycles: list[list[int]],
    verbose: bool = True,
) -> tuple[list[int], float, float]:
    """Drop-in replacement for ``ordering.order_cycles`` (same results)."""
    node_to_cycle_map = get_node_to_unique_cycle_map(cycles)
    all_cycle_indices = get_all_cycle_indices(node_to_cycle_map)
    edges, weights = generate_constraints_arrays(reads, node_to_cycle_map)
    total_before = int(weights.sum())
    if verbose:
        print(f"      ▸ {total_before} constraints derived")

    heuristic = {node: 0 for node in all_cycle_indices}

    # greedy cycle resolution (≙ resolve_cycles_greedy): keep MST rows and
    # sentinel rows; removed rows debit the target's heuristic by weight
    mst = maximal_spanning_tree_w(edges, weights)
    sent = NOT_IN_ANY_CYCLE_INDEX
    keep_mask = np.zeros(len(edges), dtype=bool)
    for i in range(len(edges)):
        u, v = int(edges[i, 0]), int(edges[i, 1])
        if (u, v) in mst or u == sent or v == sent:
            keep_mask[i] = True
        else:
            heuristic[v] = heuristic.get(v, 0) - int(weights[i])
    kept_edges = edges[keep_mask]
    kept_weights = weights[keep_mask]
    total_after = int(kept_weights.sum())
    conf_res = total_after / total_before if total_before else 1.0
    if verbose:
        print(
            f"      ▸ {total_after} constraints remain after resolving "
            f"cycles (confidence = {conf_res * 100:.2f}%)"
        )

    # toposort (≙ solve_constraints_with_topological_sort), weighted form
    edges_d: dict[tuple[int, int], int] = {}
    affection = {node: 0 for node in all_cycle_indices}
    has_incoming: set[int] = set()
    for i in range(len(kept_edges)):
        u, v = int(kept_edges[i, 0]), int(kept_edges[i, 1])
        w = int(kept_weights[i])
        if u != sent and v != sent:
            edges_d[(u, v)] = edges_d.get((u, v), 0) + w
            has_incoming.add(v)
        elif u == sent:
            if v in affection:
                affection[v] += w
        else:
            if u in affection:
                affection[u] -= w

    possible_start_nodes = [n for n in all_cycle_indices if n not in has_incoming]
    total_order: list[int] = []
    confidence = 0.0
    while possible_start_nodes:
        best_i = 0
        best_value = float("-inf")
        total_abs = 0.0
        for i, node in enumerate(possible_start_nodes):
            value = float(affection.get(node, 0)) + float(heuristic.get(node, 0))
            if value >= best_value:
                best_value = value
                best_i = i
            total_abs += abs(value)
        if total_abs > 0:
            confidence += abs(best_value) / total_abs
        start_node = possible_start_nodes.pop(best_i)
        total_order.append(start_node)
        candidates = []
        for edge in list(edges_d):
            if edge[0] == start_node:
                candidates.append(edge[1])
                heuristic[edge[1]] = heuristic.get(edge[1], 0) + edges_d[edge]
                del edges_d[edge]
        for cand in candidates:
            if not any(to == cand for (_f, to) in edges_d):
                possible_start_nodes.append(cand)
    if total_order:
        confidence /= len(total_order)
    return total_order, conf_res, confidence
