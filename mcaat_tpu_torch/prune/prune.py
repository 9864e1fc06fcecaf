"""Whole-graph vectorized pruning passes (torch).

Port of ``mcaat_tpu/prune/prune.py``, which replaces the reference's
scalar pruning in ``CycleFinder::FindApproximateCRISPRArrays``
(src/cycle_finder.cpp:433-452):

* ``InvalidateMultiplicityOneNodes``: one masked update ``valid &= mult > 1``.
* ``CollectTips`` + ``RecursiveReduction`` (backward clipping of
  dead-end chains): the surviving set is the nodes that can still reach
  a cycle. Computed by pointer doubling over unary chains — every
  degree-1 node points at its successor, ``ptr <- ptr[ptr]`` for
  ceil(log2 N) passes collapses each chain onto its terminal, the branch
  nodes' aliveness is a fixpoint over the small condensed graph (host),
  and one vectorized pass assigns validity. See the JAX module for the
  full argument.
"""

from __future__ import annotations

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG, _degree

# terminal classes
_DEAD = 0  # deg 0 or invalid
_UNARY = 1  # deg 1
_BRANCH = 2  # deg >= 2


def invalidate_low_multiplicity(graph: DBG) -> tuple[DBG, int]:
    """valid &= mult > 1; returns (graph, number invalidated)."""
    kill = graph.valid & (graph.mult <= 1)
    n = int(kill.sum())
    return graph.set_invalid(kill), n


def _clip_tips_fixpoint(out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-level reference fixpoint: drop every valid node of out-degree
    0, again and again, until none is left. O(longest dead chain) passes,
    so it is the semantic model :func:`clip_tips` is tested against, not
    a pipeline path."""
    while True:
        tips = valid & (_degree(out, valid) == 0)
        if not bool(tips.any()):
            return valid
        valid = valid & ~tips


def _chain_collapse(out: torch.Tensor, valid: torch.Tensor, n_passes: int):
    """Pointer-double unary chains onto their terminals.

    Returns ``(ntype [N], ptr [N])``: ntype in {_DEAD,_UNARY,_BRANCH};
    ``ptr`` (int64) is each unary node's chain terminal (self for
    non-unary). A unary node whose terminal is still unary after the
    passes sits on a pure unary cycle (alive).
    """
    N = valid.shape[0]
    deg = _degree(out, valid)
    ntype = torch.where(
        ~valid | (deg == 0), _DEAD, torch.where(deg == 1, _UNARY, _BRANCH)
    ).to(torch.int32)
    out4 = out.view(-1, 4).to(torch.int64)
    adj_ok = (out4 >= 0) & valid[torch.clamp(out4, min=0)]
    # the unique valid successor when deg == 1
    succ = torch.where(adj_ok, out4, -1).amax(dim=1)
    ids = torch.arange(N, device=out.device)
    ptr = torch.where(ntype == _UNARY, succ, ids)
    for _ in range(n_passes):
        ptr = ptr[ptr]
    return ntype, ptr


def _condensed_slots(out: torch.Tensor, valid: torch.Tensor, ntype, ptr):
    """Per out-slot condensed class: -1 dead, -2 alive (unary cycle),
    else the branch-node id the slot's chain terminates at."""
    u = out.to(torch.int64)
    u_c = torch.clamp(u, min=0)
    ok = (u >= 0) & valid[u_c]
    tu = ptr[u_c]
    tclass = ntype[tu]
    res = torch.where(
        ~ok | (tclass == _DEAD), -1, torch.where(tclass == _UNARY, -2, tu)
    )
    return res.to(torch.int32)


def _final_valid(valid, ntype, ptr, alive):
    """Vectorized validity from terminal classes + branch fixpoint result."""
    tclass = ntype[ptr]
    unary_alive = torch.where(
        tclass == _UNARY,
        torch.ones_like(valid),
        torch.where(tclass == _DEAD, torch.zeros_like(valid), alive[ptr]),
    )
    return torch.where(
        ntype == _UNARY,
        valid & unary_alive,
        torch.where(ntype == _BRANCH, valid & alive, torch.zeros_like(valid)),
    )


def clip_tips(graph: DBG) -> tuple[DBG, int]:
    """Tip clipping to fixpoint; returns (graph, number clipped).

    Device: chain collapse (log N gathers) + condensed-slot classes.
    Host: aliveness fixpoint over the (small) branch-node set.
    """
    N = graph.size
    if N == 0:
        return graph, 0
    before = int(graph.valid.sum())
    n_passes = max(int(np.ceil(np.log2(max(N, 2)))) + 1, 1)
    ntype, ptr = _chain_collapse(graph.out, graph.valid, n_passes)
    branch_t = torch.nonzero(ntype == _BRANCH).flatten()
    alive = np.zeros(N, dtype=bool)
    branch = branch_t.cpu().numpy()
    if len(branch) > 0:
        # condensed edges of branch nodes only ([B,4] gather)
        slots = (branch_t[:, None] * 4 + torch.arange(4, device=branch_t.device)).reshape(-1)
        cond_h = (
            _condensed_slots(graph.out[slots], graph.valid, ntype, ptr)
            .cpu()
            .numpy()
            .reshape(-1, 4)
        )
        # remap branch targets to compact branch indices
        of_node = np.full(N, -1, dtype=np.int64)
        of_node[branch] = np.arange(len(branch))
        tgt = np.where(cond_h >= 0, of_node[np.maximum(cond_h, 0)], -1)
        has_cycle_edge = (cond_h == -2).any(axis=1)
        a = np.ones(len(branch), dtype=bool)  # greatest fixpoint: start alive
        while True:
            t_alive = (tgt >= 0) & a[np.maximum(tgt, 0)]
            new_a = has_cycle_edge | t_alive.any(axis=1)
            if (new_a == a).all():
                break
            a = new_a
        alive[branch] = a
    new_valid = _final_valid(
        graph.valid, ntype, ptr, torch.as_tensor(alive, device=graph.device)
    )
    graph = graph.with_valid(new_valid)
    return graph, before - int(new_valid.sum())


def prune_graph(graph: DBG, verbose: bool = True) -> DBG:
    """Full pruning pass in the reference's order (src/cycle_finder.cpp:433-452)."""
    from mcaat_tpu_torch.utils.profiling import span

    with span("mult_filter", device=graph.device if verbose else None):
        tips0 = int((graph.valid & (graph.out_degree() == 0)).sum())
        if verbose:
            print(f"Graph size: {graph.size} nodes; gathered tips: {tips0}")
        graph, n_mult = invalidate_low_multiplicity(graph)
        if verbose:
            print(f"Pre-filter: invalidated {n_mult} node(s) with multiplicity <= 1.")
    with span("clip_tips", device=graph.device if verbose else None):
        graph, n_tips = clip_tips(graph)
        if verbose:
            remaining = int(graph.valid.sum())
            tips_after = int((graph.valid & (graph.out_degree() == 0)).sum())
            print(f"After pruning, tips: {tips_after}, valid edges: {remaining}")
    return graph
