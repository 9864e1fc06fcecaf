"""De Bruijn graph as a structure of tensors over a sorted k-mer table.

Port of ``mcaat_tpu/graph/dbg.py`` (the single-pass and the parted
build, the single-shot and the chunked adjacency, both build engines and
the three joins). The layout is the same:

* ``kmers``  int64 ``[N]``  — sorted packed 23-mers; node id == rank.
* ``mult``   int32 ``[N]``  — occurrence count (both strands with RC).
* ``out``    int32 ``[4N]`` flat — out-neighbour of node ``v`` per
  appended base ``b`` at slot ``4v+b``, -1 if the (k+1)-mer v·b was
  never observed.
* ``in_``    int32 ``[4N]`` flat — in-neighbour per prepended base.
* ``valid``  bool ``[N]``   — the IsValidEdge/SetInvalidEdge mask.

``DBG`` is a plain dataclass of tensors (there are no weights, so no
``nn.Module``); every tensor lives on the device the build was given.
The port builds exact-size tables; a graph handed over from the JAX
package with :meth:`DBG.from_numpy` may carry bucket padding (SENTINEL
k-mers, ``valid=False``), which every query path masks out.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.io.fastq import decode_kmer
from mcaat_tpu_torch.kmer.count import (
    count_edges_parts,
    count_unique,
    count_unique_with_ids,
    derive_nodes_from_edges,
    extract_first_kmer,
    extract_kmers,
    extract_last_kmer,
    revcomp_kmers,
)


@dataclass
class DBG:
    k: int
    kmers: torch.Tensor  # int64 [N] sorted
    mult: torch.Tensor  # int32 [N]
    out: torch.Tensor  # int32 [4N] flat (slot 4v+b)
    in_: torch.Tensor  # int32 [4N] flat
    valid: torch.Tensor  # bool [N]

    @classmethod
    def from_numpy(cls, k, kmers, mult, out, in_, valid, device) -> "DBG":
        """A graph from the numpy arrays ``mcaat_tpu/checkpoint.py``
        saves (``k``, ``kmers``, ``mult``, ``out``, ``in_``, ``valid``);
        ``out``/``in_`` may be flat ``[4N]`` or ``[N, 4]``."""
        dev = torch.device(device)
        return cls(
            k=int(k),
            kmers=torch.as_tensor(np.array(kmers, dtype=np.int64), device=dev),
            mult=torch.as_tensor(np.array(mult, dtype=np.int32), device=dev),
            out=torch.as_tensor(np.array(out, dtype=np.int32).reshape(-1), device=dev),
            in_=torch.as_tensor(np.array(in_, dtype=np.int32).reshape(-1), device=dev),
            valid=torch.as_tensor(np.array(valid, dtype=bool), device=dev),
        )

    @property
    def size(self) -> int:
        """Number of nodes (== SDBG::size())."""
        return int(self.kmers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.kmers.device

    def lookup(self, query_kmers: torch.Tensor) -> torch.Tensor:
        """Packed k-mers -> node ids, -1 for missing (≙ IndexBinarySearch)."""
        return _lookup(self.kmers, query_kmers)

    def outgoing(self, ids: torch.Tensor) -> torch.Tensor:
        """[Q] -> [Q,4] out-neighbour ids (valid-filtered; -1 elsewhere)."""
        return _neighbors(self.out, self.valid, ids)

    def incoming(self, ids: torch.Tensor) -> torch.Tensor:
        return _neighbors(self.in_, self.valid, ids)

    def out_degree(self) -> torch.Tensor:
        """Valid out-degree of every node, int32 [N]."""
        return _degree(self.out, self.valid)

    def in_degree(self) -> torch.Tensor:
        return _degree(self.in_, self.valid)

    def set_invalid(self, mask: torch.Tensor) -> "DBG":
        """Functional SetInvalidEdge over a boolean mask."""
        return replace(self, valid=self.valid & ~mask)

    def with_valid(self, valid: torch.Tensor) -> "DBG":
        return replace(self, valid=valid)

    def label(self, node_id: int) -> str:
        """k-mer label of a node (≙ fetch_node_label, src/tmp_utils.cpp:83)."""
        return decode_kmer(int(self.kmers[node_id]), self.k)

    def to_host(self) -> "HostDBG":
        """Numpy copy for the host stages (which may mutate ``valid``)."""
        return HostDBG(
            k=self.k,
            kmers=self.kmers.cpu().numpy().copy(),
            mult=self.mult.cpu().numpy().copy(),
            out=self.out.cpu().numpy().reshape(-1, 4).copy(),
            in_=self.in_.cpu().numpy().reshape(-1, 4).copy(),
            valid=self.valid.cpu().numpy().copy(),
        )


@dataclass
class HostDBG:
    """Numpy mirror of the graph for the host-side combinatorial stages
    (and the only graph a forked ordering worker ever sees)."""

    k: int
    kmers: np.ndarray
    mult: np.ndarray
    out: np.ndarray
    in_: np.ndarray
    valid: np.ndarray

    @property
    def size(self) -> int:
        return int(self.kmers.shape[0])

    def label(self, node_id: int) -> str:
        return decode_kmer(int(self.kmers[node_id]), self.k)

    def outgoing_list(self, node: int) -> list[int]:
        """Valid out-neighbours of one node, ascending."""
        return sorted(int(v) for v in self.out[node] if v >= 0 and self.valid[v])

    def incoming_list(self, node: int) -> list[int]:
        return sorted(int(v) for v in self.in_[node] if v >= 0 and self.valid[v])

    def _band_filtered(self, node: int, nbrs: list[int]) -> list[int]:
        m = float(self.mult[node])
        return [v for v in nbrs if m / 2 <= float(self.mult[v]) <= m * 1.2]

    def band_outgoing_list(self, node: int) -> list[int]:
        """Valid out-neighbours within the multiplicity band [m/2, 1.2m]
        (≙ graph_generic_func::_GetOutgoings, reference
        src/graph_generic_func.cpp:7-19); empty for an invalid node."""
        if not self.valid[node]:
            return []
        return self._band_filtered(node, self.outgoing_list(node))

    def band_incoming_list(self, node: int) -> list[int]:
        """≙ graph_generic_func::_GetIncomings (src/graph_generic_func.cpp:21-34)."""
        if not self.valid[node]:
            return []
        return self._band_filtered(node, self.incoming_list(node))


def _lookup(table: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Rank of each query in the sorted ``table``, -1 where absent.
    SENTINEL queries never hit, even against a SENTINEL-padded table."""
    if table.shape[0] == 0:
        return torch.full(query.shape, -1, dtype=torch.int32, device=query.device)
    idx = torch.searchsorted(table, query)
    idx_c = torch.clamp(idx, max=table.shape[0] - 1)
    found = (idx < table.shape[0]) & (table[idx_c] == query) & (query != SENTINEL)
    return torch.where(found, idx_c, -1).to(torch.int32)


def _join_ranks(table: torch.Tensor, queries: list) -> list:
    """For each query array, the index of the last row of the sorted
    ``table`` that is at or below each query (-1 when none is): one
    stable sort of table and queries together. The table comes first in
    the concatenation, so a stable sort puts a table row before the
    queries equal to it, and the running count of table rows, less one,
    lands on the matching row."""
    T = table.shape[0]
    so = torch.sort(torch.cat([table, *queries]), stable=True).indices
    rank = torch.cumsum(so < T, 0) - 1
    rank_orig = torch.empty_like(rank)
    rank_orig[so] = rank
    del so, rank
    out, lo = [], T
    for q in queries:
        out.append(rank_orig[lo : lo + q.shape[0]])
        lo += q.shape[0]
    return out


def _checked_hits(table: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Ranks ``r`` of :func:`_join_ranks` as node ids: -1 unless the
    table row at the rank holds the query (a miss, a SENTINEL query and a
    SENTINEL-padded table tail all give -1)."""
    T = table.shape[0]
    if T == 0:
        return torch.full(q.shape, -1, dtype=torch.int32, device=q.device)
    rc = torch.clamp(r, 0, T - 1)
    hit = (r >= 0) & (table[rc] == q) & (q != SENTINEL)
    return torch.where(hit, rc, -1).to(torch.int32)


def _join_lookup2(table: torch.Tensor, q1: torch.Tensor, q2: torch.Tensor):
    """Ranks of two query arrays in a sorted unique table, one fused
    sort-join: the adjacency build's two endpoint lookups share the node
    table when no source ids came with the edges. Every hit is checked
    against the table, so a prefix or suffix that is no node returns -1
    (as do SENTINEL queries and SENTINEL-padded table tails)."""
    r1, r2 = _join_ranks(table, [q1, q2])
    return _checked_hits(table, q1, r1), _checked_hits(table, q2, r2)


def _join_lookup1(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rank of one query array in a sorted unique table (sort-join), every
    hit checked; misses and SENTINEL return -1. The checked form of
    :func:`_join_lookup1_trusted`, taken by the adjacency's destination
    join under ``MCAAT_VERIFY_ADJ=1``."""
    (r,) = _join_ranks(table, [q])
    return _checked_hits(table, q, r)


def _join_lookup1_trusted(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Sort-join rank of queries known to be present in the sorted unique
    ``table`` (no hit check): the adjacency's destination join, where
    every live edge's suffix is itself a counted k-window.

    The key is ``key << 1 | is_query``, so table rows sort before equal
    queries; SENTINEL (which would overflow the shift) maps to a 2^62
    ceiling above every real 47-bit key and keeps sorting last. A
    SENTINEL query returns -1; callers mask dead rows themselves.
    """
    T = table.shape[0]
    big = 1 << 62
    k2 = torch.cat(
        [
            torch.where(table == SENTINEL, big, table << 1),
            torch.where(q == SENTINEL, big | 1, (q << 1) | 1),
        ]
    )
    sk, so = torch.sort(k2, stable=True)
    rank = torch.cumsum(1 - (sk & 1), 0) - 1
    rank_orig = torch.empty_like(rank)
    rank_orig[so] = rank
    r = rank_orig[T:]
    return torch.where(q != SENTINEL, torch.clamp(r, max=T - 1), -1).to(torch.int32)


def _neighbors(adj: torch.Tensor, valid: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(torch.int64)
    ids_c = torch.clamp(ids, min=0)
    slots = ids_c[..., None] * 4 + torch.arange(4, device=adj.device)
    nbrs = adj[slots]  # [Q, 4]
    nbr_ok = (nbrs >= 0) & valid[torch.clamp(nbrs, min=0).to(torch.int64)]
    nbr_ok &= (ids >= 0)[..., None]
    return torch.where(nbr_ok, nbrs, -1)


def _degree(adj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Valid degree per node from a flat [4N] adjacency."""
    ok = (adj >= 0) & valid[torch.clamp(adj, min=0).to(torch.int64)]
    return ok.view(-1, 4).sum(dim=1, dtype=torch.int32)


def _adjacency_scatter_chunk(
    kmers23: torch.Tensor, edges24: torch.Tensor, u_id: torch.Tensor | None,
    out: torch.Tensor, in_: torch.Tensor, k: int = 23,
) -> None:
    """Join one chunk of the sorted unique (k+1)-mer table against the
    k-mer table and scatter it, in place, into the flat ``[4N+1]``
    accumulators ``out``/``in_``.

    With ``u_id`` (each edge's source node id, from
    ``derive_nodes_from_edges``) only the destination joins: by the
    trusted join, since every live edge's suffix is a counted k-window of
    the same build, or by the checked :func:`_join_lookup1` when the
    environment sets ``MCAAT_VERIFY_ADJ``. Without ``u_id`` nothing is
    known of the edge table, and both endpoints take the checked
    two-sided :func:`_join_lookup2`; an edge with an endpoint that is no
    node is dropped.

    Rows that are not live go to the dump slot ``4N``; each live
    (k+1)-mer maps to its own slot. Slots are int64 (``4N`` passes 2^31
    above about 536M nodes); node ids stay int32."""
    N = kmers23.shape[0]
    mask_k = (1 << (2 * k)) - 1
    v = edges24 & mask_k  # last k bases
    last = edges24 & 3
    first = (edges24 >> (2 * k)) & 3
    if u_id is None:
        u_id, v_id = _join_lookup2(kmers23, (edges24 >> 2) & mask_k, v)
    elif os.environ.get("MCAAT_VERIFY_ADJ"):
        v_id = _join_lookup1(kmers23, v)
    else:
        v_id = _join_lookup1_trusted(kmers23, v)
    v_id = v_id.to(torch.int64)
    u = u_id.to(torch.int64)
    ok = (edges24 != SENTINEL) & (u >= 0) & (v_id >= 0)
    dump = 4 * N
    out[torch.where(ok, u * 4 + last, dump)] = torch.where(ok, v_id, -1).to(torch.int32)
    in_[torch.where(ok, v_id * 4 + first, dump)] = torch.where(ok, u, -1).to(torch.int32)


def build_adjacency_chunked(
    kmers23: torch.Tensor,
    edges24: torch.Tensor,
    u_id: torch.Tensor | None = None,
    k: int = 23,
    chunk_edges: int | None = None,
    sync_dev: torch.device | None = None,
):
    """Flat out/in adjacency ``[4N]`` from the unique (k+1)-mer table, in
    passes of at most ``chunk_edges`` edges (default
    ``ADJ_SINGLE_SHOT_MAX_EDGES``, half of it without ``u_id``, whose
    two-sided join sorts two query rows an edge; a table no larger goes
    in one pass).

    Each pass joins N + C rows instead of N + E, so the peak is the node
    table, one chunk's join and the two accumulators. Every pass sorts
    the node table again, so chunks should be as large as memory allows.
    Chunks of the sorted edge table keep each pass's out-slots sorted.
    Each pass is the span ``adjacency_chunk``, which waits for
    ``sync_dev`` when the profiler is verbose."""
    from mcaat_tpu_torch.utils.profiling import span

    if chunk_edges is None:
        chunk_edges = ADJ_SINGLE_SHOT_MAX_EDGES // (1 if u_id is not None else 2)
    N = kmers23.shape[0]
    E = int(edges24.shape[0])
    out = torch.full((4 * N + 1,), -1, dtype=torch.int32, device=kmers23.device)
    in_ = torch.full((4 * N + 1,), -1, dtype=torch.int32, device=kmers23.device)
    step = max(int(chunk_edges), 1)
    for lo in range(0, E, step):
        with span("adjacency_chunk", device=sync_dev):
            _adjacency_scatter_chunk(
                kmers23, edges24[lo : lo + step],
                None if u_id is None else u_id[lo : lo + step], out, in_, k=k,
            )
    return out[: 4 * N], in_[: 4 * N]


def _reverse_complement_batch(codes: torch.Tensor, lengths: torch.Tensor):
    """Reverse-complement padded 2-bit code rows on the device (the pad
    stays at the tail): ``(codes_rc, lengths)``."""
    R, L = codes.shape
    rev = torch.flip(3 - codes, dims=[1])
    # after the flip each row's live bases sit at the tail; roll them to
    # the front by the row's pad amount
    col = torch.arange(L, device=codes.device, dtype=torch.int64)
    src = torch.clamp(col[None, :] + (L - lengths.to(torch.int64))[:, None], max=max(L - 1, 0))
    live = col[None, :] < lengths[:, None]
    return torch.where(live, torch.gather(rev, 1, src), 0).to(torch.uint8), lengths


def _adjacency_from_instances(
    inst_id: torch.Tensor,  # int32 [R, W] node id of each k-window instance
    codes: torch.Tensor,  # uint8 [R, L]
    lengths: torch.Tensor,  # int32 [R]
    n_keep: int,
    k: int = 23,
):
    """Adjacency by direct instance scatters: no edge dedup, no join.

    Consecutive k-window instances of a read are its (k+1)-mer edges, and
    both endpoints of every observed edge are in the node table (each is
    itself a counted window), so ``out[4*id(p) + base(p+k)] = id(p+1)``
    per instance, and the mirror image for ``in_``. Dead instances go to
    the dump slot ``4N``.

    The stores rely on equal values: an edge seen many times is written
    many times to one slot, always with the same id, so the result is
    fixed whatever order the card takes. (Under
    ``torch.use_deterministic_algorithms(True)`` an indexed store with
    repeats becomes a sort; the function does not switch that mode on.)
    Slots are int64, ids int32."""
    R, W = inst_id.shape
    dev = inst_id.device
    out = torch.full((4 * n_keep + 1,), -1, dtype=torch.int32, device=dev)
    in_ = torch.full((4 * n_keep + 1,), -1, dtype=torch.int32, device=dev)
    if W >= 2:
        pos = torch.arange(W - 1, device=dev, dtype=torch.int32)
        live = pos[None, :] < (lengths[:, None] - k)  # window p+1 still in the read
        u_id = inst_id[:, :-1]
        v_id = inst_id[:, 1:]
        dump = 4 * n_keep
        slot = torch.where(live, u_id.to(torch.int64) * 4 + codes[:, k : k + W - 1], dump)
        out[slot.reshape(-1)] = torch.where(live, v_id, -1).reshape(-1)
        del slot
        slot = torch.where(live, v_id.to(torch.int64) * 4 + codes[:, : W - 1], dump)
        in_[slot.reshape(-1)] = torch.where(live, u_id, -1).reshape(-1)
    return out[: 4 * n_keep], in_[: 4 * n_keep]


def build_dbg(
    kmers23: torch.Tensor,
    counts23: torch.Tensor,
    edges24: torch.Tensor,
    u_id: torch.Tensor | None = None,
    k: int = 23,
    sync_dev: torch.device | None = None,
) -> DBG:
    """Assemble a DBG from the sorted unique k-mer table, its counts and
    the sorted unique (k+1)-mer table (exact sizes; a SENTINEL edge row
    is dead). With ``u_id``, each edge's source node id from
    ``derive_nodes_from_edges``, only the destination joins, and by the
    trusted join; without it both endpoints take the checked two-sided
    join, so any edge table will do (:func:`_adjacency_scatter_chunk`).

    The adjacency goes in one pass up to ``ADJ_SINGLE_SHOT_MAX_EDGES``
    edges and in chunks of that size above it. (The JAX
    package also chunks when the node table alone passes its cutoff; a
    chunk's join still sorts the whole node table, so that gate saves
    nothing here, and every node table comes with at least as many edges
    less the reads' last windows.) ``sync_dev``: the device each pass's
    span waits for when the profiler is verbose."""
    out, in_ = build_adjacency_chunked(kmers23, edges24, u_id, k=k, sync_dev=sync_dev)
    return DBG(
        k=k, kmers=kmers23, mult=counts23.to(torch.int32), out=out, in_=in_,
        valid=torch.ones(kmers23.shape[0], dtype=torch.bool, device=kmers23.device),
    )


def _bucket_size(n: int) -> int:
    """Round up to {1, 1.25, 1.5, 1.75} x a power of two (at least 1024).
    The port sizes frontier capacities with it (as the JAX package
    does); its tables are exact-size."""
    if n <= 1024:
        return 1024
    p = 1 << (n - 1).bit_length() - 1
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        cand = int(p * frac)
        if cand >= n:
            return cand
    return 2 * p


# Device budgets of the graph build, from the peaks measured on an
# NVIDIA H100 80GB HBM3 (85.0 GB; PERF.md, "Build budgets"). They move
# memory and time, never the graph: no part or chunk boundary changes a
# table entry.
#
# Windows (both strands) counted in one pass. The single-pass peak is
# 48.8-49.0 bytes per window (the window sort), so 1.1B windows peak near
# 53.7 GB, 63% of the card. More windows go in row parts of at most this
# many windows. Measured in parts at 2-3B windows: a part's count with the
# resident counted parts beside it (kmer/count.py::DEVICE_PARTS_BUDGET)
# peaked at 53.7-59.1 GB; a merge of two parts takes 52-59 bytes per
# merged row above what is resident (65.4 GB at 1.02B rows), so it is the
# unique tables, not the windows, that bound the parted build. Reads with
# substitution errors leave the window sort the peak: 1.015B windows of
# paired-end reads with 0.5% and 1% substitutions a base (235.9M and
# 334.5M nodes, against 124.7M error-free) peaked at 48.84 bytes a window
# (46.16 GiB; NVIDIA H100 80GB HBM3, 700 W), as the error-free reads did.
SINGLE_PASS_MAX_WINDOWS = 1_100_000_000
# Unique (k+1)-mers joined and scattered in one adjacency pass; larger
# edge tables go in chunks of this size. A pass peaks near 105 bytes per
# node (tables, accumulators, the node table's sort) plus 72 per chunk
# edge: 486M nodes peaked at 58.3 GB in 100M-edge chunks and ran out of
# memory in 350M-edge chunks, and about 540M nodes stay under 75% of the
# card. This, not the window count, is the largest graph one card takes.
# The 239.0M and 339.8M unique (k+1)-mers of the 0.5% and 1% samples above
# went in 3 and 4 chunks under the window sort's peak.
ADJ_SINGLE_SHOT_MAX_EDGES = 100_000_000


# Single-pass build engine. "join": count the unique (k+1)-mers, derive
# the nodes, sort-join the destinations (the pipeline's path, and the only
# one with a parted build). "inst": scatter the adjacency straight from the
# k-window sort's per-instance ids, with no (k+1)-mer dedup and no join.
# The JAX package keeps "inst" off its path for a reason that is the
# TPU's (its compiler serialises a scatter with repeated indices); PERF.md
# has both engines' times on the H100.
BUILD_ENGINE = "join"


def build_dbg_from_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int = 23,
    add_reverse_complement: bool = True,
    chunk_windows: int | None = None,
    engine: str | None = None,
    verbose: bool = False,
    endpoints_out: dict | None = None,
    device: str | torch.device = "cuda",
) -> DBG:
    """End-to-end graph build from a padded read-code matrix.

    Replaces ``SDBGBuild`` (reference ``src/sdbg_build.cpp``): the
    (k+1)-mer windows (plus their reverse complements, as bit math) are
    counted, the node table and each edge's source id are derived from
    the unique edge table, and the adjacency is scattered.

    Up to ``chunk_windows`` windows (default ``SINGLE_PASS_MAX_WINDOWS``;
    0 means no limit) are counted in one pass. Above it the rows go in
    parts of ``chunk_windows // windows_per_row`` rows: each part is
    uploaded on its own, counted, freed, and its table joins a merge
    stack. The adjacency is :func:`build_dbg`'s.

    ``engine`` (``None`` means ``BUILD_ENGINE``) picks the formulation:
    ``"join"`` as above, or ``"inst"``, which sorts the k-windows of both
    strands once, keeps every instance's node id and scatters the
    adjacency from consecutive instances
    (:func:`_adjacency_from_instances`). Both give the same graph. Like
    its JAX twin ``"inst"`` has no parted path and raises above the
    single-pass budget.

    With ``endpoints_out`` (a dict) the build stashes each input row's
    FIRST/LAST packed k-window under ``first_km``/``last_km`` (int64
    ``[R]`` on the device, SENTINEL where len < k) for the read mapper's
    keep predicate.
    """
    from mcaat_tpu_torch.utils.profiling import count, span

    dev = torch.device(device)
    sync_dev = dev if verbose else None
    if chunk_windows is None:
        chunk_windows = SINGLE_PASS_MAX_WINDOWS
    if engine is None:
        engine = BUILD_ENGINE
    if engine not in ("join", "inst"):
        raise ValueError(f"engine must be 'join' or 'inst', not {engine!r}")
    codes_np = np.asarray(codes, dtype=np.uint8)
    lengths_np = np.asarray(lengths, dtype=np.int32)
    R, L = codes_np.shape
    max_true = int(lengths_np.max()) if lengths_np.size else 0
    w24 = max(min(L - k, max_true - k), 0)
    strands = 2 if add_reverse_complement else 1
    n_windows = R * w24 * strands
    count(windows=n_windows)
    rows = R
    if chunk_windows and n_windows > chunk_windows:
        if engine == "inst":
            raise ValueError(
                f"engine='inst' has no chunked counting path: {n_windows} "
                f"windows exceeds the {chunk_windows}-window single-pass "
                "budget (use engine='join' or raise chunk_windows)"
            )
        rows = max(chunk_windows // (max(w24, 1) * strands), 1)
    if engine == "inst":
        return _build_from_instances(
            codes_np, lengths_np, k, add_reverse_complement, endpoints_out, dev, sync_dev
        )
    bounds = [(lo, min(lo + rows, R)) for lo in range(0, max(R, 1), rows)]

    firsts: list[torch.Tensor] = []
    lasts: list[torch.Tensor] = []

    def upload(lo: int, hi: int):
        codes_t = torch.as_tensor(codes_np[lo:hi], device=dev)
        lengths_t = torch.as_tensor(lengths_np[lo:hi], device=dev)
        firsts.append(extract_first_kmer(codes_t, lengths_t, k))
        lasts.append(extract_last_kmer(codes_t, lengths_t, k))
        return codes_t, lengths_t

    # the RC read's window multiset is the elementwise RC of the forward
    # windows, so no RC code matrix is ever built; each loader uploads
    # its part when the count calls it and holds no reference to it
    with span("upload_count", device=sync_dev):
        u24, c24, n24 = count_edges_parts(
            [partial(upload, lo, hi) for lo, hi in bounds], k, w_cap=w24,
            add_rc=add_reverse_complement, verbose=verbose and len(bounds) > 1,
            device=dev,
        )
        count(parts=len(bounds), unique_24mers=n24)
    with span("last_window_count", device=sync_dev):
        first = torch.cat(firsts)
        last = torch.cat(lasts)
        if endpoints_out is not None:
            endpoints_out["first_km"] = first
            endpoints_out["last_km"] = last
        if add_reverse_complement:
            # the RC strand's last k-window is the RC of the forward FIRST
            last = torch.cat([last, revcomp_kmers(first, k)])
        u_l, c_l, _n_l = count_unique(last)
        del last
    with span("derive_nodes", device=sync_dev):
        u23, c23, n23, u_id = derive_nodes_from_edges(u24, c24, u_l, c_l)
        del c24, u_l, c_l
        count(nodes=n23)
    with span("adjacency", device=sync_dev):
        graph = build_dbg(u23, c23, u24, u_id, k=k, sync_dev=sync_dev)
    return graph


def _build_from_instances(codes_np, lengths_np, k, add_rc, endpoints_out, dev, sync_dev) -> DBG:
    """The "inst" engine of :func:`build_dbg_from_reads`: one pass, the
    RC strand as real code rows (consecutive windows of a row must be
    consecutive windows of a read, which the elementwise RC of the
    forward windows is not). ``sync_dev``: the device each span waits for
    when the profiler is verbose."""
    from mcaat_tpu_torch.utils.profiling import count, span

    with span("upload", device=sync_dev):
        codes_t = torch.as_tensor(codes_np, device=dev)
        lengths_t = torch.as_tensor(lengths_np, device=dev)
        if endpoints_out is not None:
            # before the rows are doubled: they must align with the caller's
            endpoints_out["first_km"] = extract_first_kmer(codes_t, lengths_t, k)
            endpoints_out["last_km"] = extract_last_kmer(codes_t, lengths_t, k)
        if add_rc:
            codes_rc, lengths_rc = _reverse_complement_batch(codes_t, lengths_t)
            codes_t = torch.cat([codes_t, codes_rc])
            lengths_t = torch.cat([lengths_t, lengths_rc])
            del codes_rc, lengths_rc
    with span("window_count", device=sync_dev):
        max_true = int(lengths_np.max()) if lengths_np.size else 0
        R2, L = codes_t.shape
        W = max(min(L, max_true) - k + 1, 0)
        # the windows are handed over as a temporary: the count frees them
        # as soon as they are sorted
        u23, c23, n23, inst_id = count_unique_with_ids(
            extract_kmers(codes_t, lengths_t, k, w_cap=W).reshape(-1)
        )
        count(nodes=n23)
    with span("adjacency", device=sync_dev):
        out, in_ = _adjacency_from_instances(inst_id.reshape(R2, W), codes_t, lengths_t, n23, k=k)
    return DBG(
        k=k, kmers=u23, mult=c23, out=out, in_=in_,
        valid=torch.ones(n23, dtype=torch.bool, device=dev),
    )
