"""De Bruijn graph as a structure of tensors over a sorted k-mer table.

Port of ``mcaat_tpu/graph/dbg.py`` (the single-pass build). The layout is
the same:

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

from dataclasses import dataclass, replace

import numpy as np
import torch

from mcaat_tpu_torch import SENTINEL
from mcaat_tpu_torch.io.fastq import decode_kmer
from mcaat_tpu_torch.kmer.count import (
    count_unique,
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


def _lookup(table: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Rank of each query in the sorted ``table``, -1 where absent.
    SENTINEL queries never hit, even against a SENTINEL-padded table."""
    if table.shape[0] == 0:
        return torch.full(query.shape, -1, dtype=torch.int32, device=query.device)
    idx = torch.searchsorted(table, query)
    idx_c = torch.clamp(idx, max=table.shape[0] - 1)
    found = (idx < table.shape[0]) & (table[idx_c] == query) & (query != SENTINEL)
    return torch.where(found, idx_c, -1).to(torch.int32)


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


def _build_adjacency(
    kmers23: torch.Tensor, edges24: torch.Tensor, u_id: torch.Tensor, k: int = 23
):
    """Scatter the unique (k+1)-mers into flat out/in adjacency over the
    k-mer table. ``u_id`` is each edge's source node id (from
    ``derive_nodes_from_edges``); only the destination joins.

    Rows that are not live go to a dump slot ``4N`` of a ``4N+1`` buffer,
    which is sliced off; each live (k+1)-mer maps to its own slot."""
    N = kmers23.shape[0]
    mask_k = (1 << (2 * k)) - 1
    v = edges24 & mask_k  # last k bases
    last = edges24 & 3
    first = (edges24 >> (2 * k)) & 3
    v_id = _join_lookup1_trusted(kmers23, v).to(torch.int64)
    u = u_id.to(torch.int64)
    ok = (edges24 != SENTINEL) & (u >= 0) & (v_id >= 0)
    dump = 4 * N
    out_slot = torch.where(ok, u * 4 + last, dump)
    in_slot = torch.where(ok, v_id * 4 + first, dump)
    out = torch.full((4 * N + 1,), -1, dtype=torch.int32, device=kmers23.device)
    out[out_slot] = torch.where(ok, v_id, -1).to(torch.int32)
    in_ = torch.full((4 * N + 1,), -1, dtype=torch.int32, device=kmers23.device)
    in_[in_slot] = torch.where(ok, u, -1).to(torch.int32)
    return out[: 4 * N], in_[: 4 * N]


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


# The single-pass window budget of ``mcaat_tpu`` (pipeline.py:140). The
# chunked multi-pass build above it is not ported yet (ROADMAP queue 1).
SINGLE_PASS_MAX_WINDOWS = 384_000_000


def build_dbg_from_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int = 23,
    add_reverse_complement: bool = True,
    chunk_windows: int = SINGLE_PASS_MAX_WINDOWS,
    verbose: bool = False,
    endpoints_out: dict | None = None,
    device: str | torch.device = "cuda",
) -> DBG:
    """End-to-end graph build from a padded read-code matrix (single pass).

    Replaces ``SDBGBuild`` (reference ``src/sdbg_build.cpp``): the
    (k+1)-mer windows (plus their reverse complements, as bit math) are
    counted, the node table and each edge's source id are derived from
    the unique edge table, and the adjacency is scattered.

    With ``endpoints_out`` (a dict) the build stashes each input row's
    FIRST/LAST packed k-window under ``first_km``/``last_km`` (int64
    ``[R]`` on the device, SENTINEL where len < k) for the read mapper's
    keep predicate.
    """
    from mcaat_tpu_torch.utils.profiling import tick_printer

    dev = torch.device(device)
    _tick = tick_printer("build", verbose, dev)
    codes_np = np.asarray(codes, dtype=np.uint8)
    lengths_np = np.asarray(lengths, dtype=np.int32)
    R, L = codes_np.shape
    max_true = int(lengths_np.max()) if lengths_np.size else 0
    w24 = max(min(L - k, max_true - k), 0)
    n_windows = R * w24 * (2 if add_reverse_complement else 1)
    if chunk_windows and n_windows > chunk_windows:
        raise NotImplementedError(
            f"{n_windows} windows exceed the {chunk_windows}-window "
            "single-pass budget; the chunked multi-pass build is not ported "
            "yet (ROADMAP.md queue 1: chunked build and the 80 GB budget)"
        )

    codes_t = torch.as_tensor(codes_np, device=dev)
    lengths_t = torch.as_tensor(lengths_np, device=dev)
    first = extract_first_kmer(codes_t, lengths_t, k)
    last = extract_last_kmer(codes_t, lengths_t, k)
    if endpoints_out is not None:
        endpoints_out["first_km"] = first
        endpoints_out["last_km"] = last
    _tick("upload")

    km1 = extract_kmers(codes_t, lengths_t, k + 1, w_cap=w24).reshape(-1)
    del codes_t
    if add_reverse_complement:
        # the RC read's window multiset is the elementwise RC of the
        # forward windows, so no RC code matrix is ever built
        km1 = torch.cat([km1, revcomp_kmers(km1, k + 1)])
    u24, c24, n24 = count_unique(km1)
    del km1
    _tick(f"edge count ({n24} unique)")
    if add_reverse_complement:
        # the RC strand's last k-window is the RC of the forward FIRST
        last = torch.cat([last, revcomp_kmers(first, k)])
    u_l, c_l, _n_l = count_unique(last)
    _tick("last-window count")
    u23, c23, n23, u_id = derive_nodes_from_edges(u24, c24, u_l, c_l)
    _tick(f"derive nodes ({n23} nodes)")
    out, in_ = _build_adjacency(u23, u24, u_id, k=k)
    graph = DBG(
        k=k, kmers=u23, mult=c23, out=out, in_=in_,
        valid=torch.ones(n23, dtype=torch.bool, device=dev),
    )
    _tick("adjacency")
    return graph
