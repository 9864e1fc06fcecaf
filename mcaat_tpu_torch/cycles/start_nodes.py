"""Start-node selection: vectorized candidate filter + batched bounded BFS.

Port of ``mcaat_tpu/cycles/start_nodes.py``, which replaces
``CycleFinder::ChunkStartNodes`` + ``DepthLevelSearch`` (reference
``src/cycle_finder.cpp:248-343,387-427``).

Candidate predicate (src/cycle_finder.cpp:398-411):
  valid ∧ in-degree ≥ 2 ∧ mult > threshold_multiplicity ∧ no self-loop,
then keep only candidates that can reach themselves within
``cycle_max_length`` steps. That probe is a batched frontier BFS: B
candidate lanes advance together, each level one gather
``out[frontier] -> [B, F, 4]``, a per-lane sort for dedup, and a per-lane
visited bitset. Lanes whose level overflows the frontier cap F retry
with a 16x cap, then fall back to an exact host BFS.

The bitset words are int64 holding 32 bits each: torch has no uint32
``index_add_``, and the new bits of a level are deduplicated, so adding
them equals OR-ing them. The level loop is a Python loop with one
``.any()`` sync per level (at most ``cycle_max_length`` per batch).
"""

from __future__ import annotations

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG
from mcaat_tpu_torch.utils.profiling import count


def _self_reach_kernel(
    out: torch.Tensor,  # int32 [4N] flat adjacency
    valid: torch.Tensor,  # bool  [N]
    starts: torch.Tensor,  # int64 [B], -1 padded
    max_depth: int,
    frontier_cap: int,
):
    N = out.shape[0] // 4
    B = starts.shape[0]
    F = frontier_cap
    W = (N + 31) // 32
    dev = out.device
    live_lane = starts >= 0
    starts_c = torch.clamp(starts, min=0)

    frontier = torch.full((B, F), N, dtype=torch.int64, device=dev)
    frontier[:, 0] = torch.where(live_lane, starts_c, N)
    visited = torch.zeros(B * W, dtype=torch.int64, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    row_base = (torch.arange(B, device=dev) * W)[:, None]
    four = torch.arange(4, device=dev)

    for _depth in range(max_depth):
        # early exit: every lane either found its cycle or its frontier died
        count(bfs_levels=1)
        if not bool((~found & (frontier[:, 0] < N)).any()):
            break
        # found lanes stop expanding (kill their frontier)
        frontier = torch.where(found[:, None], N, frontier)
        f_live = frontier < N
        f_idx = torch.clamp(frontier, max=N - 1)
        nbrs = out[(f_idx * 4)[:, :, None] + four].to(torch.int64)  # [B, F, 4]
        nbrs_c = torch.clamp(nbrs, min=0)
        nbr_live = (nbrs >= 0) & f_live[..., None] & valid[nbrs_c]
        # cycle closure: any neighbour equals the lane's start node
        closes = nbr_live & (nbrs_c == starts_c[:, None, None])
        found = found | closes.reshape(B, -1).any(dim=1)

        flat = torch.where(nbr_live, nbrs_c, N).reshape(B, 4 * F)
        flat = torch.sort(flat, dim=1).values
        dup = torch.cat(
            [
                torch.zeros((B, 1), dtype=torch.bool, device=dev),
                (flat[:, 1:] == flat[:, :-1]) & (flat[:, 1:] < N),
            ],
            dim=1,
        )
        word = torch.clamp(flat >> 5, max=W - 1)
        bit = torch.ones_like(flat) << (flat & 31)
        got = visited[(row_base + word).reshape(-1)].reshape(B, 4 * F)
        seen = (got & bit) != 0
        # drop dups + seen entries and compact with one more sort
        flat = torch.where(dup | seen, N, flat)
        flat = torch.sort(flat, dim=1).values
        n_new = (flat < N).sum(dim=1)
        overflow = overflow | (n_new > F)
        frontier = flat[:, :F]
        # mark visited (bits are fresh, so add == or; dead slots add 0)
        w2 = torch.clamp(frontier >> 5, max=W - 1)
        b2 = torch.where(frontier < N, torch.ones_like(frontier) << (frontier & 31), 0)
        visited.index_add_(0, (row_base + w2).reshape(-1), b2.reshape(-1))
    return found & live_lane, overflow & live_lane


def self_reachable_batch(
    graph: DBG,
    starts: np.ndarray,
    max_depth: int,
    batch: int = 512,
    frontier_cap: int = 64,
) -> np.ndarray:
    """For each start node: can it reach itself in ≤ max_depth valid steps?

    Exact and tiered: the first pass runs with a small frontier; lanes
    that overflow retry with a 16x frontier, and anything still
    overflowing falls back to an exact host BFS.
    """
    starts = np.asarray(starts, dtype=np.int64)
    n = len(starts)
    result = np.zeros(n, dtype=bool)
    if n == 0:
        return result
    dev = graph.device
    cap1 = min(frontier_cap, _pow2ceil(graph.size))
    cap2 = min(frontier_cap * 16, _pow2ceil(graph.size))
    batch = min(batch, _pow2ceil(n))
    # per-lane bitset is N/32 int64 words; cap the total at 1 GiB
    words_per_lane = (graph.size + 31) // 32
    max_lanes = max(int((1 << 27) // max(words_per_lane, 1)), 16)
    batch = min(batch, 1 << (max_lanes.bit_length() - 1))  # pow2 floor

    def run(sel: np.ndarray, lanes: int, cap: int):
        pad = np.full(lanes - len(sel), -1, dtype=np.int64)
        starts_b = torch.as_tensor(np.concatenate([starts[sel], pad]), device=dev)
        found, overflow = _self_reach_kernel(
            graph.out, graph.valid, starts_b, max_depth, cap
        )
        return found[: len(sel)].cpu().numpy(), overflow[: len(sel)].cpu().numpy()

    retry: list[int] = []
    for lo in range(0, n, batch):
        sel = np.arange(lo, min(lo + batch, n))
        found, overflow = run(sel, batch, cap1)
        result[sel] = found
        retry.extend(sel[overflow & ~found].tolist())

    if retry and cap2 > cap1:
        still: list[int] = []
        retry_np = np.asarray(retry, dtype=np.int64)
        rbatch = min(batch, _pow2ceil(len(retry)))
        for lo in range(0, len(retry_np), rbatch):
            sel = retry_np[lo : lo + rbatch]
            found, overflow = run(sel, rbatch, cap2)
            result[sel] = found
            still.extend(sel[overflow & ~found].tolist())
        retry = still

    if retry:
        out_h = graph.out.cpu().numpy().reshape(-1, 4)
        valid_h = graph.valid.cpu().numpy()
        for i in retry:
            result[i] = _self_reach_host(out_h, valid_h, int(starts[i]), max_depth)
    return result


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _self_reach_host(
    out: np.ndarray, valid: np.ndarray, start: int, max_depth: int
) -> bool:
    """Exact host BFS fallback (mirrors DLS semantics, src/cycle_finder.cpp:248)."""
    frontier = {start}
    seen: set[int] = set()
    for _ in range(max_depth):
        nxt: set[int] = set()
        for v in frontier:
            for nb in out[v]:
                nb = int(nb)
                if nb < 0 or not valid[nb]:
                    continue
                if nb == start:
                    return True
                if nb not in seen:
                    seen.add(nb)
                    nxt.add(nb)
        if not nxt:
            return False
        frontier = nxt
    return False


def _candidate_mask(out, in_, valid, mult, threshold_multiplicity: int) -> torch.Tensor:
    """The static candidate predicate over the whole graph in one pass
    (src/cycle_finder.cpp:398-411): valid, in-degree >= 2, multiplicity
    above the threshold, no self-loop. The form :func:`candidate_ids`
    (which gathers the slots of the cheap half's survivors only) is
    tested against."""
    from mcaat_tpu_torch.graph.dbg import _degree

    ids = torch.arange(out.shape[0] // 4, device=out.device)
    self_loop = (out.view(-1, 4).to(torch.int64) == ids[:, None]).any(dim=1)
    return valid & (_degree(in_, valid) >= 2) & (mult > threshold_multiplicity) & ~self_loop


def _precand_order(valid, mult, threshold_multiplicity: int):
    """The cheap half of the predicate (valid & mult > thr): the passing
    node ids in ascending order, and their count. (The JAX version
    returns a full stable argsort whose first ``count`` entries are
    these ids.)"""
    pre = valid & (mult > threshold_multiplicity)
    ids = torch.nonzero(pre).flatten()
    return ids, int(ids.shape[0])


def _cand_refine(out, in_, valid, ids):
    """indeg>=2 & no-self-loop for a small id set (4 slot gathers)."""
    ids = ids.to(torch.int64)
    base = ids * 4
    indeg = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
    self_loop = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for b in range(4):
        ib = in_[base + b].to(torch.int64)
        indeg = indeg + ((ib >= 0) & valid[torch.clamp(ib, min=0)])
        self_loop = self_loop | (out[base + b].to(torch.int64) == ids)
    return (indeg >= 2) & ~self_loop


def candidate_ids(graph: DBG, threshold_multiplicity: int) -> np.ndarray:
    """Two-stage static candidate scan (src/cycle_finder.cpp:398-411):
    compact the O(N) cheap half (valid & mult>thr), then gather the
    in/out slots of the survivors only. Ascending candidate ids."""
    ids, c = _precand_order(graph.valid, graph.mult, threshold_multiplicity)
    if c == 0:
        return np.empty(0, dtype=np.int64)
    keep = _cand_refine(graph.out, graph.in_, graph.valid, ids)
    return ids[keep].cpu().numpy().astype(np.int64)


def select_start_nodes(
    graph: DBG,
    threshold_multiplicity: int,
    cycle_max_length: int,
    verbose: bool = True,
) -> dict[int, list[int]]:
    """Candidate scan + DLS filter; returns {log2-mult bucket: [node ids]}.

    Bucketing matches the reference: key = ceil(log2(multiplicity)),
    processed in descending order (src/cycle_finder.cpp:414-416,468).
    """
    cand = candidate_ids(graph, threshold_multiplicity)
    if verbose:
        print(f"ChunkStartNodes: {len(cand)} candidates pass the static filter")
    reach = self_reachable_batch(graph, cand, cycle_max_length)
    kept = cand[reach]
    mult = graph.mult[torch.as_tensor(kept, device=graph.device)].cpu().numpy()
    return bucket_start_nodes(kept, mult, verbose=verbose)


def bucket_start_nodes(
    kept: np.ndarray, mult: np.ndarray, verbose: bool = True
) -> dict[int, list[int]]:
    """Bucket surviving start nodes by ceil(log2(multiplicity))
    (src/cycle_finder.cpp:414-416)."""
    buckets: dict[int, list[int]] = {}
    for node, m in zip(np.asarray(kept).tolist(), np.asarray(mult).tolist()):
        key = int(np.ceil(np.log2(m))) if m > 1 else 0
        buckets.setdefault(key, []).append(int(node))
    if verbose:
        total = sum(len(v) for v in buckets.values())
        for key in sorted(buckets, reverse=True):
            print(
                f"Chunked start nodes: multiplicity bucket (log2)={key}, "
                f"nodes={len(buckets[key])}"
            )
        print(f"Start nodes found in chunks: {total}")
    return buckets
