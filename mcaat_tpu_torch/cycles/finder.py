"""Bounded multicycle enumeration (the "FBCE" core algorithm).

Port of ``mcaat_tpu/cycles/finder.py``: a reimplementation of
``CycleFinder::FindCycle`` / ``FindCycleUtil`` /
``FindApproximateCRISPRArrays`` (reference
``src/cycle_finder.cpp:131-492``) — Johnson-style bounded-length cycle
enumeration with a lock/relax mechanism, run per start node.

Pruning, the candidate scan and the reachability probes run on the
device (``prune/``, ``cycles/start_nodes.py``); the per-start-node DFS
touches only the small neighbourhood of real CRISPR candidates and runs
on the host, in ``native/mcaat_host.cpp`` when the library loads, else
in the Python :class:`CycleFinder` below. The semantics (neighbour
admission, lock/relax, visited marking, bucket order, the clean abort at
500 cycles per start node) are those documented in the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mcaat_tpu_torch.graph.dbg import DBG
from mcaat_tpu_torch.prune.prune import prune_graph
from mcaat_tpu_torch.cycles.start_nodes import select_start_nodes

CLUSTER_BOUNDS = 500  # src/cycle_finder.cpp:132
MULT_RATIO_LIMIT = 500  # src/cycle_finder.cpp:45
STEP_LIMIT = 10_000_000  # src/cycle_finder.cpp:149


@dataclass
class CycleFinder:
    """Host-side enumerator over a pruned graph's numpy adjacency."""

    out: np.ndarray  # int32 [N, 4]
    in_: np.ndarray  # int32 [N, 4]
    valid: np.ndarray  # bool [N]
    mult: np.ndarray  # int32 [N]
    cycle_min_length: int
    cycle_max_length: int
    visited: np.ndarray = field(default=None)  # bool [N]

    def __post_init__(self):
        if self.visited is None:
            self.visited = np.zeros(self.out.shape[0], dtype=bool)

    # -- neighbour queries (≙ _GetOutgoings/_GetIncomings with background check)
    def _admissible(self, nbrs, node: int, start_mult: int) -> list[int]:
        res = []
        for nb in nbrs:
            nb = int(nb)
            if nb < 0 or not self.valid[nb]:
                continue
            if self.visited[nb]:
                continue
            if start_mult // int(self.mult[nb]) > MULT_RATIO_LIMIT:
                continue
            if nb == node:
                continue
            res.append(nb)
        res.sort()
        return res

    def _outgoings(self, node: int, start_mult: int) -> list[int]:
        if not self.valid[node]:
            return []
        return self._admissible(self.out[node], node, start_mult)

    def _incomings(self, node: int, start_mult: int) -> list[int]:
        if not self.valid[node]:
            return []
        return self._admissible(self.in_[node], node, start_mult)

    # -- the bounded DFS with lock/relax (≙ FindCycle) ------------------------
    def find_cycles_from(self, start: int) -> list[list[int]]:
        max_len = self.cycle_max_length
        min_len = self.cycle_min_length
        start_mult = int(self.mult[start])

        path: list[int] = [start]
        lock: dict[int, int] = {start: 0}
        stack: list[list[int]] = [self._outgoings(start, start_mult)]
        backtrack: list[int] = [max_len]
        cycles: list[list[int]] = []
        steps = 0

        while stack:
            steps += 1
            if steps > STEP_LIMIT:
                break
            neighbors = stack[-1]
            advanced = False
            for pos, nb in enumerate(neighbors):
                if nb == start:
                    backtrack[-1] = 1
                    if len(path) > min_len:
                        cycles.append(list(path))
                        if len(cycles) >= CLUSTER_BOUNDS:
                            return []  # tangle: abort (see module docstring)
                elif len(path) < lock.get(nb, max_len):
                    neighbors.pop(pos)
                    path.append(nb)
                    backtrack.append(max_len)
                    lock[nb] = len(path)
                    stack.append(self._outgoings(nb, start_mult))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                v = path.pop()
                bl = backtrack.pop()
                if backtrack:
                    backtrack[-1] = min(backtrack[-1], bl)
                if bl < max_len:
                    # relax locks of ancestors (Johnson-style unblocking,
                    # bounded to cycle_max_length; src/cycle_finder.cpp:191-210)
                    relax_stack = [(bl, v)]
                    path_set = set(path)
                    while relax_stack:
                        rbl, u = relax_stack.pop()
                        if lock.get(u, max_len) < max_len - rbl + 1:
                            lock[u] = max_len - rbl + 1
                            for w in self._incomings(u, start_mult):
                                if w not in path_set:
                                    relax_stack.append((rbl + 1, w))

        for cyc in cycles:
            for node in cyc:
                self.visited[node] = True
        return cycles

    # -- full enumeration over bucketed start nodes (≙ FindApproximateCRISPRArrays)
    def enumerate(
        self, buckets: dict[int, list[int]], verbose: bool = True
    ) -> dict[int, list[list[int]]]:
        results: dict[int, list[list[int]]] = {}
        cumulative = 0
        for key in sorted(buckets, reverse=True):
            at_bucket_start = cumulative
            nodes = sorted(buckets[key])
            for start in nodes:
                if self.visited[start]:
                    continue
                cycles = self.find_cycles_from(start)
                cumulative += len(cycles)
                results[start] = cycles
            if verbose:
                print(
                    f"Bucket log2_mult={key}: processed {len(nodes)} nodes, "
                    f"found {cumulative - at_bucket_start} cycles "
                    f"(cumulative {cumulative})"
                )
        if verbose:
            print(
                f"Cycle enumeration completed: total cycles={cumulative}, "
                f"result nodes={len(results)}"
            )
        return results


# Above this node count only the candidate neighbourhood crosses to the
# host for enumeration (see cycles/neighborhood.py). Module attributes,
# read at call time, so tests can lower them to force the big-graph
# branches at small sizes.
NEIGHBORHOOD_MIN_NODES = 200_000

# Above this node count tip clipping is deferred to the extracted
# candidate neighbourhood ("lazy clip"); output-preserving, see the
# argument at mcaat_tpu/cycles/finder.py::LAZY_CLIP_MIN_NODES. The
# ordering stage completes the deferred clip on its condensed region
# (pipeline.spacer_ordering_step).
LAZY_CLIP_MIN_NODES = 1_000_000

# Lazy clipping presumes enumeration runs on the (clipped) extracted
# neighbourhood, never on an unclipped full graph.
assert LAZY_CLIP_MIN_NODES >= NEIGHBORHOOD_MIN_NODES


def enumerate_on_arrays(
    out: np.ndarray,
    in_: np.ndarray,
    valid: np.ndarray,
    mult: np.ndarray,
    buckets: dict[int, list[int]],
    cycle_min_length: int,
    cycle_max_length: int,
    verbose: bool = True,
) -> dict[int, list[list[int]]]:
    """Host enumeration over explicit adjacency arrays (native fast path
    with the Python fallback; same deterministic order and semantics)."""
    from mcaat_tpu_torch.native import enumerate_cycles as native_enumerate

    ordered_starts = [
        s for key in sorted(buckets, reverse=True) for s in sorted(buckets[key])
    ]
    results = native_enumerate(
        out, in_, valid, mult,
        np.asarray(ordered_starts, dtype=np.int64),
        cycle_min_length, cycle_max_length,
    )
    if results is None:
        finder = CycleFinder(
            out=out, in_=in_, valid=valid, mult=mult,
            cycle_min_length=cycle_min_length,
            cycle_max_length=cycle_max_length,
        )
        results = finder.enumerate(buckets, verbose=verbose)
    elif verbose:
        total = sum(len(c) for c in results.values())
        print(
            f"Cycle enumeration completed (native): total cycles={total}, "
            f"result nodes={len(results)}"
        )
    return results


def _to_global(gids: np.ndarray, results_loc: dict) -> dict[int, list[list[int]]]:
    return {
        int(gids[s]): [[int(gids[v]) for v in cyc] for cyc in cycles]
        for s, cycles in results_loc.items()
    }


def enumerate_from_buckets(
    graph: DBG,
    buckets: dict[int, list[int]],
    cycle_min_length: int,
    cycle_max_length: int,
    verbose: bool = True,
    min_nodes_for_extraction: int = NEIGHBORHOOD_MIN_NODES,
) -> dict[int, list[list[int]]]:
    """Cycle enumeration with device-side neighbourhood extraction: for
    large graphs only the forward-reachable set of the start nodes
    crosses to the host; results map back to global ids."""
    from mcaat_tpu_torch.cycles.neighborhood import extract_subgraph, touched_mask

    starts_all = np.asarray(
        sorted(s for nodes in buckets.values() for s in nodes), dtype=np.int64
    )
    if len(starts_all) == 0:
        return {}
    n = graph.size
    if n >= min_nodes_for_extraction:
        mask = touched_mask(graph.out, graph.valid, starts_all, cycle_max_length, n)
        if mask is not None:
            out_h, in_h, valid_h, mult_h, gids = extract_subgraph(graph, mask)
            if verbose:
                print(
                    f"Neighborhood extraction: {len(gids)}/{n} nodes "
                    f"touched by {len(starts_all)} start nodes"
                )
            loc_of = {int(g): i for i, g in enumerate(gids)}
            buckets_loc = {
                key: [loc_of[s] for s in nodes] for key, nodes in buckets.items()
            }
            results_loc = enumerate_on_arrays(
                out_h, in_h, valid_h, mult_h, buckets_loc,
                cycle_min_length, cycle_max_length, verbose=verbose,
            )
            return _to_global(gids, results_loc)
        if verbose:
            print("Neighborhood extraction overflowed; using full graph")
    h = graph.to_host()
    return enumerate_on_arrays(
        h.out, h.in_, h.valid, h.mult, buckets,
        cycle_min_length, cycle_max_length, verbose=verbose,
    )


def find_cycles(
    graph: DBG,
    threshold_multiplicity: int = 20,
    cycle_min_length: int = 27,
    cycle_max_length: int = 77,
    verbose: bool = True,
    full_prune: bool = False,
) -> tuple[DBG, dict[int, list[list[int]]]]:
    """Prune + start-node scan (device) + cycle enumeration (host).

    Returns the pruned graph and ``{start_node: [cycles]}`` (each cycle a
    node-id list beginning at its start node), the analog of
    ``CycleFinder::results`` (reference include/cycle_finder.h:60).

    Large graphs take the compact path: after the static candidate scan
    the union forward-reachable set is extracted once, and the tip clip
    (deferred at ``LAZY_CLIP_MIN_NODES``), the self-reach probes and the
    enumeration run on that subgraph.
    """
    from mcaat_tpu_torch.cycles.neighborhood import extract_subgraph, touched_mask
    from mcaat_tpu_torch.cycles.start_nodes import (
        bucket_start_nodes,
        candidate_ids,
        self_reachable_batch,
    )
    from mcaat_tpu_torch.prune.prune import clip_tips, invalidate_low_multiplicity
    from mcaat_tpu_torch.utils.profiling import count, span

    dev = graph.device
    sync_dev = dev if verbose else None

    lazy_clip = not full_prune and graph.size >= LAZY_CLIP_MIN_NODES
    if lazy_clip:
        with span("mult_filter", device=sync_dev):
            graph, n_mult = invalidate_low_multiplicity(graph)
        if verbose:
            print(
                f"Graph size: {graph.size} nodes; "
                f"tip clipping deferred to the candidate neighborhood"
            )
            print(f"Pre-filter: invalidated {n_mult} node(s) with multiplicity <= 1.")
    else:
        with span("prune", device=sync_dev):
            graph = prune_graph(graph, verbose=verbose)
    n = graph.size
    if n >= NEIGHBORHOOD_MIN_NODES:
        with span("candidate_scan", device=sync_dev):
            cand = candidate_ids(graph, threshold_multiplicity)
            count(candidates=len(cand))
        if verbose:
            print(f"ChunkStartNodes: {len(cand)} candidates pass the static filter")
        if len(cand) == 0:
            return graph, {}
        with span("touched_mask", device=sync_dev):
            mask = touched_mask(graph.out, graph.valid, cand, cycle_max_length, n)
        if mask is not None:
            with span("extraction", device=sync_dev):
                out_h, in_h, valid_h, mult_h, gids = extract_subgraph(graph, mask)
                if verbose:
                    print(
                        f"Neighborhood extraction: {len(gids)}/{n} nodes "
                        f"touched by {len(cand)} start nodes"
                    )
                sub = DBG.from_numpy(
                    graph.k, np.zeros(len(gids), np.int64), mult_h, out_h, in_h,
                    valid_h, dev,
                )
            if lazy_clip:
                # deferred tip clip, at neighbourhood scale
                with span("neighborhood_clip", device=sync_dev):
                    sub, n_clipped = clip_tips(sub)
                    valid_h = sub.valid.cpu().numpy()
                if verbose:
                    print(f"Neighborhood tip clip: {n_clipped} node(s) clipped")
            with span("self_reach", device=sync_dev):
                loc_cand = np.searchsorted(gids, cand).astype(np.int64)
                reach = self_reachable_batch(sub, loc_cand, cycle_max_length)
                kept_loc = loc_cand[reach]
                count(start_nodes=len(kept_loc))
            with span("enumeration", device=sync_dev):
                buckets_loc = bucket_start_nodes(kept_loc, mult_h[kept_loc], verbose=verbose)
                results_loc = enumerate_on_arrays(
                    out_h, in_h, valid_h, mult_h, buckets_loc,
                    cycle_min_length, cycle_max_length, verbose=verbose,
                )
                return graph, _to_global(gids, results_loc)
        if verbose:
            print("Neighborhood extraction overflowed; using full graph")
        if lazy_clip:
            with span("global_clip", device=sync_dev):
                graph, _ = clip_tips(graph)
    with span("start_nodes", device=sync_dev):
        buckets = select_start_nodes(
            graph, threshold_multiplicity, cycle_max_length, verbose=verbose
        )
        count(start_nodes=sum(len(v) for v in buckets.values()))
    with span("enumeration", device=sync_dev):
        results = enumerate_from_buckets(
            graph, buckets, cycle_min_length, cycle_max_length, verbose=verbose
        )
    return graph, results


def cycles_map_to_cycles(results: dict[int, list[list[int]]]) -> list[list[int]]:
    """Flatten {start: [cycles]} deterministically (≙ src/tmp_utils.cpp:26-38)."""
    flat: list[list[int]] = []
    for start in sorted(results):
        flat.extend(results[start])
    return flat
