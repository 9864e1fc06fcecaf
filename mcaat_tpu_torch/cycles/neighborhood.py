"""Candidate-neighborhood and cycle-region extraction (torch).

Port of ``mcaat_tpu/cycles/neighborhood.py``. The per-start-node DFS
(``cycles/finder.py``) only walks nodes forward-reachable from a start
node within ``cycle_max_length`` steps, so restricting the graph to the
union forward-reachable set of all start nodes is exactly
output-preserving (see the JAX module for the argument). A device union
BFS computes that set; only the touched rows cross to the host, remapped
to compact local ids. The ordering stage's undirected ``read_len``-hop
region growth works the same way.

The visited sets are bool ``[N + 1]`` tensors whose last slot takes the
dead frontier entries (id ``N``) and is sliced off; the JAX package
packed them into uint32 bitsets. Each BFS level is one iteration of a
Python loop that ends with one host sync on its stop condition, counted
as ``bfs_levels`` (``utils/profiling.py::count``).
"""

from __future__ import annotations

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG, _bucket_size
from mcaat_tpu_torch.utils.profiling import count


def _gather_rows(adj_flat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(torch.int64)
    return adj_flat[(ids * 4)[:, None] + torch.arange(4, device=adj_flat.device)]


def _fresh(flat: torch.Tensor, visited: torch.Tensor, N: int) -> torch.Tensor:
    """Sorted candidate ids -> N where duplicated, already visited or
    dead (``visited[N]`` is always False, so dead entries need the
    explicit ``>= N`` test)."""
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[1:] = (flat[1:] == flat[:-1]) & (flat[1:] < N)
    return torch.where(dup | visited[flat] | (flat >= N), N, flat)


def _union_reach_kernel(
    out: torch.Tensor,  # int32 [4N] flat adjacency
    valid: torch.Tensor,  # bool  [N]
    seeds: torch.Tensor,  # int64 [S], -1 padded, unique
    max_depth: int,
    cap: int,
):
    """Union BFS from all seeds; returns (touched bool[N], overflow bool).

    One shared frontier (compacted id list, capacity ``cap``) and one
    visited set: per-level cost follows the true frontier size,
    deduplicated across seeds.
    """
    N = out.shape[0] // 4
    dev = out.device
    seeds_live = (seeds >= 0) & valid[torch.clamp(seeds, min=0)]
    seeds_sorted = torch.sort(torch.where(seeds_live, seeds, N)).values
    visited = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    visited[seeds_sorted] = True
    visited[N] = False
    frontier = torch.full((cap,), N, dtype=torch.int64, device=dev)
    take = min(cap, seeds_sorted.shape[0])
    frontier[:take] = seeds_sorted[:take]
    overflow = (seeds_sorted < N).sum() > cap
    four = torch.arange(4, device=dev)

    for _depth in range(max_depth):
        count(bfs_levels=1)
        if not bool((frontier[0] < N) & ~overflow):
            break
        f_live = frontier < N
        f_idx = torch.clamp(frontier, max=N - 1)
        nbrs = out[(f_idx * 4)[:, None] + four].to(torch.int64)  # [cap, 4]
        nbrs_c = torch.clamp(nbrs, min=0)
        ok = (nbrs >= 0) & f_live[:, None] & valid[nbrs_c]
        flat = torch.sort(torch.where(ok, nbrs_c, N).reshape(-1)).values
        flat = torch.sort(_fresh(flat, visited, N)).values
        overflow = overflow | ((flat < N).sum() > cap)
        frontier = flat[:cap]
        visited[frontier] = True
        visited[N] = False
    return visited[:N], bool(overflow)


def touched_mask(
    graph_out, graph_valid, seeds: np.ndarray, radius: int, n_nodes: int
) -> np.ndarray | None:
    """Union forward-reachable mask from ``seeds`` within ``radius`` steps.

    Tiered frontier capacities; returns None if even the largest tier
    overflows (caller falls back to the full-graph path).
    """
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    if len(seeds) == 0:
        return np.zeros(n_nodes, dtype=bool)
    seeds_t = torch.as_tensor(seeds, device=graph_out.device)
    cap0 = _bucket_size(max(4 * len(seeds), 4096))
    for cap in (cap0, cap0 * 16, cap0 * 256):
        if cap > 4 * n_nodes:
            cap = _bucket_size(4 * n_nodes)
        visited, overflow = _union_reach_kernel(
            graph_out, graph_valid, seeds_t, radius, cap
        )
        if not overflow:
            return visited.cpu().numpy()
        if cap >= 4 * n_nodes:
            break
    return None


def remap_to_local(gids: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Global ids -> compact local ids (rank in the sorted ``gids``);
    entries outside ``gids`` (and negatives) become -1.

    PRECONDITION: ``gids`` must be sorted ascending and duplicate-free
    (every caller passes ``np.nonzero`` outputs). Bulk lookups take a
    dense map when the id range keeps it under 2 GB; sparse or huge
    ranges fall back to searchsorted."""
    if len(gids) == 0:
        return np.full(a.shape, -1, dtype=np.int32)
    hi = int(gids[-1]) + 1
    assert len(gids) <= hi, "remap_to_local: gids not sorted-unique"
    if a.size >= 4 * len(gids) and hi <= (1 << 29):
        # store local+1 so untouched zeros decode to the -1 miss sentinel
        dense = np.zeros(hi, dtype=np.int32)
        dense[gids] = np.arange(1, len(gids) + 1, dtype=np.int32)
        ok = (a >= 0) & (a < hi)
        res = dense[np.where(ok, a, 0)]
        res -= 1
        res[~ok] = -1
        return res
    pos = np.searchsorted(gids, np.maximum(a, 0))
    pos_c = np.minimum(pos, len(gids) - 1)
    hit = (a >= 0) & (gids[pos_c] == np.maximum(a, 0))
    return np.where(hit, pos_c, -1).astype(np.int32)


def extract_subgraph(graph: DBG, mask: np.ndarray):
    """Compact the masked rows into host arrays with remapped local ids.

    Returns ``(out[M,4], in_[M,4], valid[M], mult[M], global_ids[M])``;
    adjacency entries leaving the mask become -1. ``global_ids`` is
    sorted ascending, so local-id order == global-id order.
    """
    gids = np.nonzero(mask)[0].astype(np.int64)
    sel = torch.as_tensor(gids, device=graph.device)
    sub_out = _gather_rows(graph.out, sel).cpu().numpy()
    sub_in = _gather_rows(graph.in_, sel).cpu().numpy()
    return (
        remap_to_local(gids, sub_out),
        remap_to_local(gids, sub_in),
        graph.valid[sel].cpu().numpy(),
        graph.mult[sel].cpu().numpy(),
        gids,
    )


def _undirected_region_steps(
    out: torch.Tensor,  # int32 [4N]
    in_: torch.Tensor,  # int32 [4N]
    valid: torch.Tensor,  # bool  [N]
    frontier: torch.Tensor,  # int64 [cap] sorted, N-padded (valid nodes only)
    visited: torch.Tensor,  # bool  [N + 1] reached set (slot N always False)
    levels: int,
    cap: int,
):
    """``levels`` levels of undirected bounded growth (cost ∝ cap·levels).

    Semantics of keep_crispr_regions_extended_by_k's growth (reference
    src/spacer_ordering.cpp:96-129): invalid neighbours join the reached
    set but only valid nodes expand. Functional: the inputs are not
    changed, so a caller can retry a phase that overflowed from the same
    state. Returns ``(frontier', visited', overflow)``.
    """
    N = out.shape[0] // 4
    visited = visited.clone()
    four = torch.arange(4, device=out.device)
    overflow = torch.zeros((), dtype=torch.bool, device=out.device)
    for _depth in range(levels):
        count(bfs_levels=1)
        if not bool((frontier[0] < N) & ~overflow):
            break
        f_live = frontier < N
        slots = (torch.clamp(frontier, max=N - 1) * 4)[:, None] + four
        nbrs = torch.cat([out[slots], in_[slots]], dim=1).to(torch.int64)  # [cap, 8]
        ok = (nbrs >= 0) & f_live[:, None]
        flat = torch.sort(torch.where(ok, torch.clamp(nbrs, min=0), N).reshape(-1)).values
        fresh = _fresh(flat, visited, N)
        # every fresh node is reached, valid or not ...
        visited[fresh] = True
        visited[N] = False
        # ... but only valid ones enter the next frontier
        fresh_v = torch.where(valid[torch.clamp(fresh, max=N - 1)], fresh, N)
        fresh_v = torch.sort(fresh_v).values
        overflow = overflow | ((fresh_v < N).sum() > cap)
        frontier = _resize(fresh_v, cap, N)
    return frontier, visited, bool(overflow)


def _resize(frontier: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """Sorted, fill-padded frontier cut or padded to ``cap`` entries."""
    cur = frontier.shape[0]
    if cap <= cur:
        return frontier[:cap]
    pad = torch.full((cap - cur,), fill, dtype=frontier.dtype, device=frontier.device)
    return torch.cat([frontier, pad])


# levels per phase: between phases the frontier capacity is re-sized to
# the live frontier, so a saturated region stops paying seed-sized gathers
_REGION_PHASE_LEVELS = 6


def undirected_region_mask(
    graph: DBG, seeds: np.ndarray, hops: int, verbose: bool = False
) -> np.ndarray:
    """Undirected ``hops``-hop expansion of ``seeds`` (bool [N]): invalid
    neighbours join the reached set but only valid nodes expand (reference
    src/spacer_ordering.cpp:96-129). Runs in phases with a compacted
    frontier whose capacity follows the live frontier between phases; a
    phase that overflows retries with 8x capacity from the same state,
    and the host loop is the last fallback.
    """
    n = graph.size
    dev = graph.device
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    if len(seeds) == 0:
        return np.zeros(n, dtype=bool)
    seeds_t = torch.as_tensor(seeds, device=dev)
    visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    visited[seeds_t] = True
    frontier = torch.sort(seeds_t[graph.valid[seeds_t]]).values
    count = int(frontier.shape[0])
    full_cap = _bucket_size(4 * n)

    remaining = hops
    while remaining > 0 and count > 0:
        cap = min(_bucket_size(max(4 * count, 4096)), full_cap)
        if count > 32_768:
            levels = 2
        elif cap <= 16_384:
            levels = 4 * _REGION_PHASE_LEVELS
        else:
            levels = _REGION_PHASE_LEVELS
        levels = min(levels, remaining)
        while True:
            frontier = _resize(frontier, cap, n)
            nxt, vis_next, overflow = _undirected_region_steps(
                graph.out, graph.in_, graph.valid, frontier, visited, levels, cap
            )
            if not overflow:
                visited, frontier = vis_next, nxt
                count = int((nxt < n).sum())
                remaining -= levels
                if verbose:
                    print(
                        f"      region phase: {levels} levels cap={cap} "
                        f"frontier={count}",
                        flush=True,
                    )
                break
            if cap >= full_cap:
                # even the full-graph tier overflowed: the host loop picks
                # up from the already-reached state
                f = frontier.cpu().numpy()
                return _undirected_region_mask_host(
                    graph, f[f < n], remaining,
                    reached=visited[:n].cpu().numpy(),
                )
            cap = min(_bucket_size(cap * 8), full_cap)
    return visited[:n].cpu().numpy()


def _undirected_region_mask_host(
    graph: DBG, seeds: np.ndarray, hops: int, reached: np.ndarray | None = None
) -> np.ndarray:
    """Per-level host-loop fallback (same semantics, no frontier cap).

    ``reached`` continues from a partially grown state: ``seeds`` is then
    the live frontier, already in it.
    """
    n = graph.size
    valid_h = graph.valid.cpu().numpy()
    if reached is None:
        reached = np.zeros(n, dtype=bool)
    seeds = np.asarray(seeds, dtype=np.int64)
    reached[seeds] = True
    frontier = seeds[valid_h[seeds]]
    for _ in range(hops):
        if len(frontier) == 0:
            break
        fr = torch.as_tensor(frontier, device=graph.device)
        o = _gather_rows(graph.out, fr).cpu().numpy().ravel()
        i = _gather_rows(graph.in_, fr).cpu().numpy().ravel()
        nbrs = np.concatenate([o, i])
        nbrs = nbrs[nbrs >= 0]
        new = np.unique(nbrs)
        new = new[~reached[new]]
        reached[new] = True
        frontier = new[valid_h[new]]
    return reached


def extract_region_graph(graph: DBG, mask: np.ndarray):
    """Compact the masked rows into a full DBG on the same device (k-mers
    kept for labels) + the ascending global-id map."""
    gids = np.nonzero(mask)[0].astype(np.int64)
    sel = torch.as_tensor(gids, device=graph.device)
    out_rows = _gather_rows(graph.out, sel).cpu().numpy()
    in_rows = _gather_rows(graph.in_, sel).cpu().numpy()
    compact = DBG(
        k=graph.k,
        kmers=graph.kmers[sel],
        mult=graph.mult[sel],
        out=torch.as_tensor(remap_to_local(gids, out_rows).reshape(-1), device=graph.device),
        in_=torch.as_tensor(remap_to_local(gids, in_rows).reshape(-1), device=graph.device),
        valid=graph.valid[sel],
    )
    return compact, gids


def remap_chains(gids: np.ndarray, cycles: list[list[int]], reads):
    """Remap cycle/read node chains into compact local ids; out-of-region
    entries get unique negative surrogates (-2 - first-appearance rank),
    distinct from the -1 miss sentinel, preserving equality structure.
    ``reads`` comes back as ``Chains`` over the same offsets."""
    from mcaat_tpu_torch.reads.chains import Chains

    reads = Chains.from_lists(reads)
    lens_c = [len(c) for c in cycles]
    flat = np.concatenate(
        [np.asarray(c, dtype=np.int64) for c in cycles]
        + [reads.flat, np.zeros(0, dtype=np.int64)]
    )
    out = remap_to_local(gids, flat).astype(np.int64)
    miss = (out < 0) & (flat >= 0)
    if miss.any():
        miss_vals = flat[miss]
        _vals, first_idx, inv = np.unique(
            miss_vals, return_index=True, return_inverse=True
        )
        rank = np.argsort(np.argsort(first_idx, kind="stable"), kind="stable")
        out[miss] = -2 - rank[inv]
    cyc_res = []
    off = 0
    for ln in lens_c:
        cyc_res.append(out[off : off + ln].tolist())
        off += ln
    return cyc_res, reads.with_flat(out[off:])
