"""Distributed de Bruijn graph: node table + adjacency sharded over kp.

Port of ``mcaat_tpu/parallel/sharded_graph.py``. The single-device
``graph.dbg.DBG`` holds the whole structure of tensors on one card; here
the k-mer space is radix-partitioned by the packed k-mer's top bits over
the mesh's ``kp`` axis, so shard ``s`` owns a contiguous sorted range.

Key property exploited for the build: a 24-mer edge ``e = u·b`` has the
same top bits as its source 23-mer ``u`` (``e >> (48-bits) == u >>
(46-bits)``), so every edge is co-located with its source node and the
*out*-adjacency builds locally. The destination ids and the
*in*-adjacency take one routed round trip: ``(v, source id)`` pairs go to
the owner of ``v``, which fills its in-slots and answers with ``v``'s id.

Global node id = ``shard * T + local_rank`` with one ``T`` for all shards
(the largest live row count, or the ``T`` of a loaded checkpoint). Each
shard's tensors have their exact size: there is no padded tail.

Queries that belong to one shard (adjacency entries, chain pointers) are
routed to their owners with ``all_to_all``
(:func:`_routed_value_gather`). Queries that every process holds in full
(a BFS frontier, the cycle nodes) need no routing: each owner gathers its
own rows and the pieces are concatenated (:func:`routed_gather`,
:func:`frontier_step`), which moves the answers once instead of routing
the same replicated query from every shard.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.kmer.count import (
    _merge_stack_drain,
    _merge_stack_push,
    count_unique,
    derive_nodes_from_edges,
    extract_first_kmer,
    extract_kmers,
    extract_last_kmer,
    revcomp_kmers,
)
from mcaat_tpu_torch.parallel.exchange import (
    Mesh,
    all_gather_dp,
    all_gather_host,
    all_to_all,
    host_replicated,
    host_shards,
    np_dtype,
    psum,
)
from mcaat_tpu_torch.parallel.sharded import (
    _owner_shift,
    _slice_by_owner,
    kmer_bounds,
    route,
    route_back,
    split_rows,
)
from mcaat_tpu_torch.utils import wire
from mcaat_tpu_torch.utils.profiling import count, span

# the largest global id: the tag ``-2 - g`` must still fit int32
_MAX_GID = (1 << 31) - 2


@dataclass
class ShardedDBG:
    """Per-shard tensors: every field is a list with one tensor per local
    slot of the mesh, on that slot's device, at its exact size."""

    k: int
    mesh: Mesh
    kmers: list  # int64 [n_s] sorted
    mult: list  # int32 [n_s]
    out: list  # int32 [4 n_s] flat GLOBAL node ids, -1 absent
    in_: list  # int32 [4 n_s] flat GLOBAL node ids, -1 absent
    valid: list  # bool  [n_s]
    T: int  # the id stride: global id = shard * T + local
    n_live: np.ndarray  # int64 [kp] rows per shard
    route_cap: int = 0  # kept for the checkpoint's meta.json only
    n_parts: int = 1  # row parts the count ran in

    @property
    def shard_capacity(self) -> int:
        return int(self.T)

    @property
    def n_nodes(self) -> int:
        return int(self.n_live.sum())

    def gid_base(self, i: int) -> int:
        """Global id of local slot ``i``'s first row."""
        return self.mesh.local_kp[i] * self.T

    def to_single_device(self):
        """A host-side global view in the JAX package's layout (tests and
        small graphs): ``[kp*T]`` arrays padded per shard with SENTINEL,
        0, -1 and False."""
        return (
            padded_global(self, self.kmers, int(SENTINEL)),
            padded_global(self, self.mult, 0),
            padded_global(self, self.out, -1, row=4).reshape(-1, 4),
            padded_global(self, self.valid, False),
            padded_global(self, self.in_, -1, row=4).reshape(-1, 4),
        )


def padded_global(sg: ShardedDBG, xs: list, fill, row: int = 1) -> np.ndarray:
    """``[kp * T * row]`` host array of a per-slot field, every shard
    padded to ``T`` rows with ``fill``."""
    shards = host_shards(sg.mesh, xs)
    out = np.full(sg.mesh.kp * sg.T * row, fill, dtype=shards[0].dtype)
    for s, a in enumerate(shards):
        out[s * sg.T * row : s * sg.T * row + a.shape[0]] = a
    return out


def _check_gid_range(kp: int, T: int) -> None:
    if kp * T - 1 > _MAX_GID:
        raise ValueError(
            f"sharded graph: kp*T = {kp}*{T} passes the int32 global-id range "
            f"({_MAX_GID + 1}); use more shards per id stride or a smaller input"
        )


def _gid_bounds(kp: int, T: int) -> list[int]:
    return [s * T for s in range(kp + 1)]


def _kp_ints(mesh: Mesh, vals: list[int]) -> np.ndarray:
    """One int per local slot → int64 ``[kp]`` known to every process."""
    mine = np.zeros(mesh.kp, dtype=np.int64)
    for i in mesh.primary:
        mine[mesh.local_kp[i]] = vals[i]
    return np.asarray(psum(mesh, mine), dtype=np.int64)


# ---------------------------------------------------------------------------
# Two-phase distributed build: count → T from the LIVE rows → adjacency
# ---------------------------------------------------------------------------

# Per-part budget on one shard's counting input (the rows fed to one
# per-shard count_unique sort). Measured on an NVIDIA H100 80GB HBM3,
# 700.00 W (scripts/torch_build_peaks.py --sharded 4, PERF.md): with four shards on
# one card a one-part build peaks at 18.85 bytes per window of the whole
# input, which is 75 bytes per row of one shard's count input with all
# four shards' send and receive buffers beside it (the single-device
# count's sort alone is 48.8-49.0). At one shard a card, through the
# distributed exchange (its send and receive buffers on the card), a part
# of 800M rows peaked at 36.44 GiB, 48.9 bytes a row, where 65 had been
# reckoned (chip_smoke.py phase 19, the same card), so 800M rows leave
# room for the resident merge-stack parts. Several shards on one card
# share it: divide by their number (``MCAAT_COUNT_SHARD_ROWS``).
SHARDED_COUNT_SHARD_ROWS = 800_000_000


def _sharded_route_part(mesh: Mesh, rows: list, k: int, add_rc: bool, w_cap: int | None):
    """Route one row part's (k+1)-mer edges and last k-windows to their
    owners.

    An edge shares its top bits with its source k-mer, so every node
    k-mer reaches its owner shard as the prefix of a routed edge or as a
    routed last window; the k-window multiset itself never crosses. With
    ``add_rc`` the reverse strand joins as bit math (its edge multiset is
    the elementwise RC of the forward edges; its last k-window is the RC
    of the forward FIRST window).

    Returns ``(a24, a_l)``: per local slot the routed edge and last-window
    multisets of its kp range.
    """
    kp = mesh.kp
    shift23 = _owner_shift(k, kp)
    shift24 = _owner_shift(k + 1, kp)
    s24, s_l = [], []
    for codes_l, lengths_l in rows:
        km24 = extract_kmers(codes_l, lengths_l, k + 1, w_cap=w_cap).reshape(-1)
        last23 = extract_last_kmer(codes_l, lengths_l, k)
        if add_rc:
            km24 = torch.cat([km24, revcomp_kmers(km24, k + 1)])
            first23 = extract_first_kmer(codes_l, lengths_l, k)
            last23 = torch.cat([last23, revcomp_kmers(first23, k)])
        s24.append(torch.sort(km24).values)
        s_l.append(torch.sort(last23).values)
        del km24, last23
    b24 = [_slice_by_owner(s, kp, shift24) for s in s24]
    b_l = [_slice_by_owner(s, kp, shift23) for s in s_l]
    del s24, s_l
    r24 = all_to_all(mesh, b24, "build_route")
    r_l = all_to_all(mesh, b_l, "build_route")
    del b24, b_l
    a24 = all_gather_dp(mesh, [torch.cat(r) for r in r24], "build_route")
    a_l = all_gather_dp(mesh, [torch.cat(r) for r in r_l], "build_route")
    return a24, a_l


def _sharded_adjacency(mesh: Mesh, u23: list, u24: list, u_id: list, k: int, T: int):
    """Adjacency of every shard, at its exact size.

    Out-edges are co-located with their source (same top bits). Each
    edge's ``(v, source gid * 4 + first base)`` goes to the owner of its
    destination ``v``; the owner fills its in-slot and answers with
    ``v``'s global id, which the source writes into its out-slot.
    Returns ``(out, in_)``, per local slot flat ``[4 n_s]`` int32.
    """
    kp = mesh.kp
    mask_k = (1 << (2 * k)) - 1
    keys, pays = [], []
    for i, e in enumerate(u24):
        base = mesh.local_kp[i] * T
        first = (e >> (2 * k)) & 3
        keys.append(e & mask_k)
        pays.append((u_id[i].to(torch.int64) + base) * 4 + first)
    recv_k, recv_p, plan = route(mesh, keys, kmer_bounds(k, kp), "build_adjacency", extra=pays)
    del keys, pays
    in_, answers = [], []
    for j, tloc in enumerate(u23):
        n = int(tloc.shape[0])
        base = mesh.local_kp[j] * T
        in_j = torch.full((4 * n + 1,), -1, dtype=torch.int32, device=tloc.device)
        ans = []
        for q, p in zip(recv_k[j], recv_p[j]):
            if n == 0:
                ans.append(torch.full(q.shape, -1, dtype=torch.int32, device=q.device))
                continue
            pos = torch.clamp(torch.searchsorted(tloc, q), max=n - 1)
            hit = tloc[pos] == q
            in_j[torch.where(hit, pos * 4 + (p & 3), 4 * n)] = torch.where(
                hit, p >> 2, -1
            ).to(torch.int32)
            ans.append(torch.where(hit, pos + base, -1).to(torch.int32))
        in_.append(in_j[: 4 * n])
        answers.append(ans)
    del recv_k, recv_p
    v_gid = route_back(mesh, plan, answers, -1, "build_adjacency")
    out = []
    for i, e in enumerate(u24):
        n = int(u23[i].shape[0])
        ok = v_gid[i] >= 0
        out_i = torch.full((4 * n + 1,), -1, dtype=torch.int32, device=e.device)
        out_i[torch.where(ok, u_id[i].to(torch.int64) * 4 + (e & 3), 4 * n)] = v_gid[i]
        out.append(out_i[: 4 * n])
    return out, in_


def build_sharded_dbg(
    mesh: Mesh,
    codes,
    lengths,
    k: int = 23,
    add_rc: bool = False,
    count_shard_rows: int | None = None,
    verbose: bool = False,
) -> ShardedDBG:
    """Two-phase distributed build over the ("dp","kp") mesh.

    ``codes``/``lengths`` are THIS PROCESS's read rows (host numpy); a
    one-process caller passes all rows, and in a process group every
    process calls with its own rows.

    Phase 1 (count): the rows go in parts; each part's (k+1)-mer edges
    and last k-windows are routed to their owner shards (``all_to_all``
    over kp, ``all_gather`` over dp) and counted per shard, and the part
    tables reduce through a per-shard binary-counter merge stack
    (``kmer/count.py``), so the window volume may pass what one sort
    holds. ``count_shard_rows`` (or ``MCAAT_COUNT_SHARD_ROWS``) bounds one
    part's per-shard count input.

    Phase 2 (allocate + adjacency): the node table derives per shard from
    the unique edge table, the id stride is ``T = max live rows over the
    shards``, and :func:`_sharded_adjacency` fills out/in.

    Buckets have their exact length, so nothing overflows and nothing is
    retried. The phases are the spans ``count``, ``node_table`` and
    ``adjacency`` (``utils/profiling.py``); ``verbose`` is the JAX
    package's argument and prints nothing here.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    kp = mesh.kp
    n_proc = mesh.n_proc
    n_local = mesh.n_local

    # agree on a common per-process row count and read length
    R, L = codes.shape
    l_true = int(lengths.max()) if lengths.size else 0
    maxes = np.stack(all_gather_host(mesh, np.asarray([R, min(L, l_true)], dtype=np.int64)))
    R_max, L_max = int(maxes[:, 0].max()), int(maxes[:, 1].max())
    w_cap = max(L_max - k, 0)

    budget = count_shard_rows or int(
        os.environ.get("MCAAT_COUNT_SHARD_ROWS", SHARDED_COUNT_SHARD_ROWS)
    )
    wpr = max(L_max - k, 1) * (2 if add_rc else 1)  # (k+1)-windows per row
    rows_budget = max(int(budget * kp // (wpr * max(n_proc, 1))), n_local)
    rows_per_part = max(
        (min(rows_budget, max(R_max, 1)) + n_local - 1) // n_local * n_local, n_local
    )
    n_parts = max((R_max + rows_per_part - 1) // rows_per_part, 1)

    stack24: list = [[] for _ in range(n_local)]
    stack_l: list = [[] for _ in range(n_local)]
    with span("count"):
        n_max = 0
        for pi in range(n_parts):
            lo, hi = min(pi * rows_per_part, R), min((pi + 1) * rows_per_part, R)
            rows = split_rows(mesh, codes[lo:hi], lengths[lo:hi])
            a24, a_l = _sharded_route_part(mesh, rows, k, add_rc, w_cap)
            del rows
            for i in range(n_local):
                u, c, n = count_unique(a24[i])
                a24[i] = None
                _merge_stack_push(stack24[i], u, c)
                n_max = max(n_max, n)
                u, c, _n = count_unique(a_l[i])
                a_l[i] = None
                _merge_stack_push(stack_l[i], u, c)
        count(parts=n_parts, max_unique_edges_per_shard=n_max)

    with span("node_table"):
        u24, u23, c23, u_id = [], [], [], []
        for i, dev in enumerate(mesh.local_devices):
            e, ce, _n = _merge_stack_drain(stack24[i], dev)
            ul, cl, _n = _merge_stack_drain(stack_l[i], dev)
            un, cn, _nn, uid = derive_nodes_from_edges(e, ce, ul, cl)
            u24.append(e)
            u23.append(un)
            c23.append(cn.to(torch.int32))
            u_id.append(uid)
            del ce, ul, cl
        n_live = _kp_ints(mesh, [int(u.shape[0]) for u in u23])
        T = max(int(n_live.max()), 1)
        _check_gid_range(kp, T)
        count(nodes=int(n_live.sum()), stride=T)

    with span("adjacency"):
        out, in_ = _sharded_adjacency(mesh, u23, u24, u_id, k, T)
    del u24, u_id
    return ShardedDBG(
        k=k, mesh=mesh, kmers=u23, mult=c23, out=out, in_=in_,
        valid=[torch.ones(u.shape[0], dtype=torch.bool, device=u.device) for u in u23],
        T=T, n_live=n_live, n_parts=n_parts,
    )


# ---------------------------------------------------------------------------
# Routed gathers
# ---------------------------------------------------------------------------


def _routed_value_gather(mesh: Mesh, values: list, gids: list, T: int, fill,
                         stage: str | None = None) -> list:
    """Gather ``values[g]`` for the GLOBAL ids each slot asks for
    (``gids[i]``; owner ``g // T``): route the ids to their owners, gather
    the owner's local row, route back. Wire cost is O(queries). Returns
    values aligned with ``gids``; ``fill`` for ``gids < 0``."""
    recv, _x, plan = route(mesh, gids, _gid_bounds(mesh.kp, T), stage)
    answers = []
    for j, row in enumerate(recv):
        base = mesh.local_kp[j] * T
        answers.append([values[j][(q - base).to(torch.int64)] for q in row])
    return route_back(mesh, plan, answers, fill, stage)


def _owner_gather(mesh: Mesh, values: list, gids, T: int, row: int, fill,
                  stage: str | None) -> np.ndarray:
    """Rows of ``values`` at replicated GLOBAL ids (host array, the same
    on every process; ``< 0`` dead): each owner gathers its own rows and
    the pieces are concatenated in shard order. ``row`` entries per id
    (1 for a node field, 4 for a flat adjacency)."""
    gids = np.asarray(gids, dtype=np.int64)
    Q = gids.shape[0]
    order = np.argsort(gids, kind="stable")
    gs = gids[order]
    cuts = np.searchsorted(gs, _gid_bounds(mesh.kp, T))
    pieces = {}
    for i in mesh.primary:
        s = mesh.local_kp[i]
        v = values[i]
        loc = torch.as_tensor(gs[cuts[s] : cuts[s + 1]] - s * T, device=v.device)
        if row > 1:
            loc = (loc * row)[:, None] + torch.arange(row, device=v.device)
        pieces[s] = v[loc].cpu().numpy()
    dtype = np_dtype(values[0])
    shape = (Q,) if row == 1 else (Q, row)
    res_sorted = np.full(shape, fill, dtype=dtype)
    if not mesh.distributed:
        for s, a in pieces.items():
            res_sorted[cuts[s] : cuts[s + 1]] = a
        if stage is not None:
            wire.add(stage, 0)  # device to host only: nothing crosses between shards
    else:
        tail = shape[1:]
        mine = (
            np.concatenate([pieces[s] for s in sorted(pieces)])
            if pieces else np.zeros((0,) + tail, dtype=dtype)
        )
        parts = all_gather_host(mesh, mine)
        if stage is not None:
            wire.add(stage, sum(p.nbytes for q, p in enumerate(parts) if q != mesh.proc))
        offs = [0] * mesh.n_proc
        for s in range(mesh.kp):
            p = mesh.slot_proc[s]
            n = int(cuts[s + 1] - cuts[s])
            res_sorted[cuts[s] : cuts[s + 1]] = parts[p][offs[p] : offs[p] + n]
            offs[p] += n
    res = np.empty_like(res_sorted)
    res[order] = res_sorted
    return res


def routed_gather(mesh: Mesh, values: list, gids, T: int,
                  stage: str | None = "routed_gather") -> np.ndarray:
    """``values[g // T][g % T]`` for a replicated ``[Q]`` global-id array
    (``< 0`` dead → zero of the value dtype), on the host. The
    query-proportional alternative to replicating a sharded table."""
    return _owner_gather(mesh, values, gids, T, 1, 0, stage)


def frontier_step(mesh: Mesh, out: list, frontier, T: int,
                  stage: str | None = "frontier") -> np.ndarray:
    """One distributed BFS expansion: replicated global ids → all their
    out-neighbour entries, exactly as stored.

    With a :func:`tag_adjacency`-tagged adjacency the caller reads target
    validity straight off each entry (``>= 0`` valid, ``<= -2`` is
    ``-2 - gid`` of an invalid target, ``-1`` absent); no validity
    collective runs here. With the raw adjacency this is an unfiltered
    expansion. Returns int32 ``[Q, 4]`` (-1 for dead lanes).
    """
    return _owner_gather(mesh, out, frontier, T, 4, -1, stage)


# ---------------------------------------------------------------------------
# Validity-tagged adjacency
# ---------------------------------------------------------------------------


def tag_adjacency(mesh: Mesh, adj: list, valid: list, T: int) -> list:
    """Encode TARGET validity into the adjacency entries: an entry ``g``
    pointing at an invalid node becomes ``-2 - g`` (recoverable), valid
    targets stay ``g``, absent stays ``-1``.

    ONE routed exchange per validity epoch; afterwards every BFS and
    candidate consumer reads neighbour validity locally from the tag. A
    DBG node has at most 4 in-edges, so each target id appears at most 4
    times over the whole out-adjacency.

    Only the present entries are routed (about one slot in four of a
    de Bruijn graph): the route's stable sort keeps an int64 index and
    sort buffers for every entry it is given, which for all 4N slots of a
    shard of 349M nodes asked for 15.67 GiB beside 46.20 GiB in use and
    ran out of memory on an 80 GB H100.
    """
    slots = [torch.nonzero(a >= 0).flatten() for a in adj]
    present = [a[s] for a, s in zip(adj, slots)]
    ok = _routed_value_gather(mesh, valid, present, T, False, "tag_adjacency")
    tagged = []
    for a, s, p, o in zip(adj, slots, present, ok):
        t = torch.full_like(a, -1)
        t[s] = torch.where(o, p, -2 - p).to(torch.int32)
        tagged.append(t)
    return tagged


def decode_tagged(adj: torch.Tensor) -> torch.Tensor:
    """Recover raw global ids from a validity-tagged adjacency
    (``-2-g`` → ``g``; ``-1`` stays absent)."""
    return torch.where(adj <= -2, -2 - adj, adj)


def tagged_adjacency(sg: ShardedDBG, valid: list):
    """``(out, in_)`` tagged with ``valid``, cached on the graph object so
    that the cycle stage and the region condensation (same validity
    epoch) share one tagging pass per array. The cache key is the
    ``valid`` list OBJECT (a new epoch is always a new list);
    :func:`release_tags` frees it when the epoch ends."""
    cache = getattr(sg, "_tag_cache", None)
    if cache is not None and cache[0] is valid:
        return cache[1], cache[2]
    outv = tag_adjacency(sg.mesh, sg.out, valid, sg.T)
    inv = tag_adjacency(sg.mesh, sg.in_, valid, sg.T)
    sg._tag_cache = (valid, outv, inv)
    return outv, inv


def release_tags(sg: ShardedDBG) -> None:
    """Drop the cached tagged adjacency (two more adjacency-sized tensors
    per shard) once its validity epoch has no reader left."""
    sg._tag_cache = None


# ---------------------------------------------------------------------------
# Distributed prune + candidate scan
# ---------------------------------------------------------------------------


def _sharded_chain_collapse(mesh: Mesh, outv: list, valid: list, T: int, n_passes: int):
    """Distributed unary-chain collapse by pointer doubling.

    ``outv`` is the valid-TAGGED adjacency (same ``valid``), so successor
    admissibility is a local sign test. Each doubling pass routes every
    node's pointer target to its owner and gathers the owner's pointer
    (:func:`_routed_value_gather`): O(N) wire per pass. The passes stop
    early once no pointer moved anywhere (one ``psum`` per pass).

    Only graphs under ``cycles.finder.LAZY_CLIP_MIN_NODES`` run this: past
    it the sharded pipeline defers the tip clip to the extracted
    candidate neighbourhood, like the single-device lazy clip.

    Returns ``(ntype, ptr)`` per local slot; ``ptr`` holds GLOBAL ids.
    """
    from mcaat_tpu_torch.prune.prune import _BRANCH, _DEAD, _UNARY

    ntype, ptr = [], []
    for i, o in enumerate(outv):
        o4 = o.view(-1, 4)
        adj_ok = o4 >= 0  # tagged ⇒ target validity is the sign
        deg = adj_ok.sum(dim=1)
        succ = torch.where(adj_ok, o4, -1).amax(dim=1)  # the one valid successor when deg == 1
        nt = torch.where(
            ~valid[i] | (deg == 0), _DEAD, torch.where(deg == 1, _UNARY, _BRANCH)
        ).to(torch.int32)
        gids = torch.arange(o4.shape[0], dtype=torch.int32, device=o.device)
        gids += mesh.local_kp[i] * T
        ntype.append(nt)
        ptr.append(torch.where(nt == _UNARY, succ.to(torch.int32), gids))
    for _ in range(n_passes):
        newp = _routed_value_gather(mesh, ptr, ptr, T, -1, "chain_collapse")
        moved = sum(int((a != b).sum()) for a, b in zip(newp, ptr))
        ptr = newp
        if int(psum(mesh, moved)) == 0:
            break
    return ntype, ptr


def sharded_prune_and_candidates(
    mesh: Mesh,
    mult: list,
    out: list,
    in_: list,
    valid: list,
    T: int,
    threshold_multiplicity: int = 20,
):
    """Distributed pruning + start-node candidate scan.

    Multiplicity ≤ 1 invalidation and the chain collapse run sharded on
    the devices; the condensed branch-node fixpoint runs on the host over
    the collapsed pointers of the branch rows alone (the branch set is
    small, the same split as ``prune.clip_tips``); the final
    classification and the candidate predicate are per-shard again, with
    one routed gather each. Returns ``(valid, candidates)`` per local
    slot.
    """
    from mcaat_tpu_torch.prune.prune import _BRANCH, _DEAD, _UNARY

    kp = mesh.kp
    N = kp * T
    valid0 = [v & (m > 1) for v, m in zip(valid, mult)]
    n_passes = max(int(np.ceil(np.log2(max(N, 2)))) + 1, 1)
    outv0 = tag_adjacency(mesh, out, valid0, T)
    ntype, ptr = _sharded_chain_collapse(mesh, outv0, valid0, T, n_passes)

    # condensed class of the branch rows' out-slots: -1 dead, -2 alive
    # (unary cycle), else the branch node the slot's chain ends at
    branch_l, q = [], []
    for i, nt in enumerate(ntype):
        bl = torch.nonzero(nt == _BRANCH).flatten()
        branch_l.append(bl)
        u = outv0[i][(bl * 4)[:, None] + torch.arange(4, device=bl.device)].reshape(-1)
        q.append(torch.where(u >= 0, u, -1))
    tu = _routed_value_gather(mesh, ptr, q, T, -1, "prune_branch")
    tclass = _routed_value_gather(mesh, ntype, tu, T, _DEAD, "prune_branch")
    cond = [
        torch.where(
            (qq < 0) | (tc == _DEAD), -1, torch.where(tc == _UNARY, -2, t)
        ).to(torch.int32).reshape(-1, 4)
        for qq, tc, t in zip(q, tclass, tu)
    ]
    branch_g = [
        bl + mesh.local_kp[i] * T for i, bl in enumerate(branch_l)
    ]
    counts = _kp_ints(mesh, [int(b.shape[0]) for b in branch_l])
    branch = host_replicated(mesh, branch_g).astype(np.int64)  # ascending
    alive_b = np.zeros(len(branch), dtype=bool)
    if len(branch) > 0:
        cond_h = host_replicated(mesh, cond)  # [B, 4]: only branch rows cross
        tgt = np.where(
            cond_h >= 0,
            np.searchsorted(branch, np.maximum(cond_h, 0)),
            -1,
        )
        has_cycle_edge = (cond_h == -2).any(axis=1)
        a = np.ones(len(branch), dtype=bool)  # greatest fixpoint: start alive
        while True:
            t_alive = (tgt >= 0) & a[np.maximum(tgt, 0)]
            new_a = has_cycle_edge | t_alive.any(axis=1)
            if (new_a == a).all():
                break
            a = new_a
        alive_b = a
    offs = np.concatenate([[0], np.cumsum(counts)])

    # final validity: ntype and aliveness of each node's chain terminal,
    # packed into one routed gather
    packed = []
    alive_l = []
    for i, nt in enumerate(ntype):
        s = mesh.local_kp[i]
        al = torch.zeros(nt.shape[0], dtype=torch.bool, device=nt.device)
        al[branch_l[i]] = torch.as_tensor(alive_b[offs[s] : offs[s + 1]], device=nt.device)
        alive_l.append(al)
        packed.append(nt | (al.to(torch.int32) << 2))
    term = _routed_value_gather(mesh, packed, ptr, T, 0, "prune_final")
    v_out = []
    for i, nt in enumerate(ntype):
        tcl = term[i] & 3
        t_alive = (term[i] >> 2) == 1
        unary_alive = torch.where(
            tcl == _UNARY, torch.ones_like(t_alive),
            torch.where(tcl == _DEAD, torch.zeros_like(t_alive), t_alive),
        )
        v_out.append(
            torch.where(
                nt == _UNARY, valid0[i] & unary_alive,
                torch.where(nt == _BRANCH, valid0[i] & alive_l[i], torch.zeros_like(t_alive)),
            )
        )

    # static candidate predicate (src/cycle_finder.cpp:398-411)
    inv = tag_adjacency(mesh, in_, v_out, T)
    cand = []
    for i, v in enumerate(v_out):
        n = v.shape[0]
        gids = torch.arange(n, dtype=torch.int32, device=v.device) + mesh.local_kp[i] * T
        indeg = (inv[i].view(-1, 4) >= 0).sum(dim=1)
        self_loop = (out[i].view(-1, 4) == gids[:, None]).any(dim=1)
        cand.append(v & (indeg >= 2) & (mult[i] > threshold_multiplicity) & ~self_loop)
    return v_out, cand


# ---------------------------------------------------------------------------
# Per-shard two-stage start-node candidate scan (the at-scale path)
# ---------------------------------------------------------------------------


def _vprecand(valid: list, mult: list, thr: int) -> list:
    """Per-shard cheap half of the predicate: the LOCAL ids passing
    ``valid & mult > thr``, ascending (no communication)."""
    return [torch.nonzero(v & (m > thr)).flatten() for v, m in zip(valid, mult)]


def _vcand_refine(outv: list, inv: list, ids: list, gid_base: list[int]) -> list:
    """indeg ≥ 2 & no-self-loop for small per-shard local-id sets, read
    entirely from the validity-TAGGED local adjacency rows (an in-entry
    ≥ 0 IS a valid in-neighbour)."""
    keep = []
    for o, n_, ids_l, base in zip(outv, inv, ids, gid_base):
        slots = ids_l * 4
        gids = (ids_l + base).to(torch.int32)
        indeg = torch.zeros(ids_l.shape, dtype=torch.int32, device=ids_l.device)
        self_loop = torch.zeros(ids_l.shape, dtype=torch.bool, device=ids_l.device)
        for b in range(4):
            indeg = indeg + (n_[slots + b] >= 0)
            self_loop = self_loop | (decode_tagged(o[slots + b]) == gids)
        keep.append((indeg >= 2) & ~self_loop)
    return keep


def sharded_candidate_ids(
    sg: ShardedDBG, valid: list, outv: list, inv: list, threshold_multiplicity: int
) -> np.ndarray:
    """Start-node candidates (ascending GLOBAL ids) over the sharded
    graph — ≙ CycleFinder::ChunkStartNodes' static predicate
    (src/cycle_finder.cpp:398-411), evaluated per shard with no O(N)
    collective and candidate-proportional downloads: stage 1 compacts
    ``valid & mult > thr`` per shard, stage 2 refines the survivors'
    in/out slots against the validity TAGS."""
    mesh = sg.mesh
    ids = _vprecand(valid, sg.mult, threshold_multiplicity)
    bases = [sg.gid_base(i) for i in range(mesh.n_local)]
    keep = _vcand_refine(outv, inv, ids, bases)
    res = [ids_l[k_l] + base for ids_l, k_l, base in zip(ids, keep, bases)]
    return host_replicated(mesh, res).astype(np.int64)


def sharded_dbg_to_dbg(sg: ShardedDBG, device=None):
    """Compact a ShardedDBG into a single-device ``graph.dbg.DBG``.

    Shards own contiguous sorted k-mer ranges, so the concatenated rows
    are globally sorted; global ids (shard*T + local) are remapped to
    compact ranks. For the callers that want one graph (the debug
    pipeline under a mesh, tests); the release pipeline keeps the graph
    sharded.
    """
    from mcaat_tpu_torch.graph.dbg import DBG

    mesh = sg.mesh
    dev = torch.device(device) if device is not None else mesh.local_devices[0]
    offs = np.concatenate([[0], np.cumsum(sg.n_live)]).astype(np.int64)

    def remap(xs):
        a = host_replicated(mesh, xs).astype(np.int64)
        s = np.maximum(a, 0) // sg.T
        return np.where(a >= 0, a - s * sg.T + offs[s], -1).astype(np.int32)

    return DBG.from_numpy(
        sg.k,
        host_replicated(mesh, sg.kmers),
        host_replicated(mesh, sg.mult),
        remap(sg.out),
        remap(sg.in_),
        host_replicated(mesh, sg.valid),
        dev,
    )
