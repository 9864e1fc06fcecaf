"""Device-side k-mer extraction and counting (torch).

Port of ``mcaat_tpu/kmer/count.py``: k-mers are packed big-endian into
int64 (k=23 → 46 bits, k+1=24 → 48 bits), sorted, and reduced to a
unique sorted table plus multiplicities. The solid threshold is m=1 (keep
everything), matching the reference's hardcoded ``"-m","1"``
(``src/sdbg_build.cpp:216``).

Tables here have exact sizes: where the JAX package pads to bucket sizes
so that XLA can reuse compiled programs, torch runs eagerly and needs no
padding. Dead windows are SENTINEL, which sorts last.

Past the single-pass window budget the (k+1)-mers are counted in row
parts, and the counted tables merge in a binary-counter stack that
spills its oldest parts to pinned host memory past
``DEVICE_PARTS_BUDGET`` (:func:`count_edges_parts`).

Unsigned 64-bit note: torch has no uint64 arithmetic, and ``>>`` on
int64 is arithmetic, so every right shift below is masked.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mcaat_tpu_torch import SENTINEL


def extract_kmers(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, w_cap: int | None = None
) -> torch.Tensor:
    """All k-mer windows of each read, packed big-endian into int64.

    ``codes`` uint8 ``[R, L]``, ``lengths`` int32 ``[R]``. Returns
    ``[R, W]`` int64 with ``W = L - k + 1`` (or ``w_cap`` when smaller);
    windows past a read's length are SENTINEL.
    """
    R, L = codes.shape
    W = max(L - k + 1, 0)
    if w_cap is not None:
        W = min(W, w_cap)
    acc = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    for t in range(k):
        acc = (acc << 2) | codes[:, t : t + W].to(torch.int64)
    pos = torch.arange(W, device=codes.device, dtype=torch.int32)
    valid = (pos[None, :] + k) <= lengths[:, None]
    return torch.where(valid, acc, torch.full_like(acc, SENTINEL))


def revcomp_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Elementwise reverse complement of packed k-mers (SENTINEL kept).

    Complement is XOR with 2k ones (code c -> 3-c); base order reversal
    is a 2-bit-group reversal of the 64-bit word followed by a logical
    right shift. Each ``>>`` is masked because int64 shifts are
    arithmetic.
    """
    ones = (1 << (2 * k)) - 1
    x = kmers ^ ones
    m1 = 0x3333333333333333
    x = ((x >> 2) & m1) | ((x & m1) << 2)
    m2 = 0x0F0F0F0F0F0F0F0F
    x = ((x >> 4) & m2) | ((x & m2) << 4)
    m3 = 0x00FF00FF00FF00FF
    x = ((x >> 8) & m3) | ((x & m3) << 8)
    m4 = 0x0000FFFF0000FFFF
    x = ((x >> 16) & m4) | ((x & m4) << 16)
    x = ((x >> 32) & 0xFFFFFFFF) | (x << 32)
    x = (x >> (64 - 2 * k)) & ones
    return torch.where(kmers == SENTINEL, torch.full_like(x, SENTINEL), x)


def count_unique(kmers_flat: torch.Tensor):
    """Sort + run-length reduce: ``(unique_sorted, counts, n_unique)``.

    ``unique_sorted`` int64 and ``counts`` int32 hold exactly the
    ``n_unique`` live entries; SENTINEL windows are dropped.
    """
    s = torch.sort(kmers_flat, stable=True).values
    s = s[: int((s != SENTINEL).sum())]  # SENTINEL sorts last
    unique, counts = torch.unique_consecutive(s, return_counts=True)
    # unique_consecutive shrinks its output in place, so the tensor keeps
    # an input-sized allocation; the clone holds only the live rows
    return unique.clone(), counts.to(torch.int32), int(unique.shape[0])


def count_unique_with_ids(kmers_flat: torch.Tensor):
    """Like :func:`count_unique`, plus each instance's id in the unique
    table: ``(unique_sorted, counts, n_unique, inst_id)``.

    One stable sort with its index gives the sorted windows and where
    each came from; the rank of every sorted position (the running count
    of run heads) is scattered back through the index. ``inst_id`` is
    int32 ``[n]`` in input order: the node id of a live window, and -1
    for a SENTINEL window (the JAX function leaves those "an arbitrary
    in-range id"; callers mask them either way). This is what lets the
    "inst" build engine skip the (k+1)-mer dedup and the join
    (``graph.dbg._adjacency_from_instances``).
    """
    n = kmers_flat.shape[0]
    dev = kmers_flat.device
    if n == 0:
        return (
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            0,
            torch.zeros(0, dtype=torch.int32, device=dev),
        )
    s, so = torch.sort(kmers_flat, stable=True)
    del kmers_flat  # frees the windows when the caller passed its only reference
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(is_head, 0, dtype=torch.int32) - 1
    del is_head
    n_live = int((s != SENTINEL).sum())  # SENTINEL sorts last
    rank[n_live:] = -1
    inst_id = torch.empty(n, dtype=torch.int32, device=dev)
    inst_id[so] = rank  # ``so`` is a permutation: every slot written once
    del so, rank  # the int64 index is the largest temporary here
    unique, counts = torch.unique_consecutive(s[:n_live], return_counts=True)
    del s
    # the clone drops unique_consecutive's input-sized allocation
    return unique.clone(), counts.to(torch.int32), int(unique.shape[0]), inst_id


def extract_first_kmer(codes: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """The first k-window of each read, packed int64 [R]; SENTINEL if len < k."""
    R, L = codes.shape
    acc = torch.zeros((R,), dtype=torch.int64, device=codes.device)
    for t in range(min(k, L)):
        acc = (acc << 2) | codes[:, t].to(torch.int64)
    return torch.where(lengths >= k, acc, torch.full_like(acc, SENTINEL))


def extract_last_kmer(codes: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-window of each read, packed int64 [R]; SENTINEL if len < k."""
    R, L = codes.shape
    start = torch.clamp(lengths.to(torch.int64) - k, min=0)
    acc = torch.zeros((R,), dtype=torch.int64, device=codes.device)
    for t in range(k):
        # columns past the row end are clamped, as JAX clamps the gather;
        # such rows are SENTINEL below anyway
        col = torch.clamp(start + t, max=L - 1)
        c = torch.gather(codes, 1, col[:, None]).squeeze(1)
        acc = (acc << 2) | c.to(torch.int64)
    return torch.where(lengths >= k, acc, torch.full_like(acc, SENTINEL))


def node_multiset_from_edges(km_k1_flat: torch.Tensor, last_k: torch.Tensor) -> torch.Tensor:
    """The k-mer window multiset, derived from (k+1)-mer windows.

    Every k-window of a read except the last is the prefix of a
    (k+1)-window; the last k-window is appended separately. The counts
    equal those of extracting the k-windows directly."""
    pref = torch.where(km_k1_flat == SENTINEL, km_k1_flat, km_k1_flat >> 2)
    return torch.cat([pref, last_k])


def count_nodes_and_edges(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """One-extraction counting of k-mer nodes and (k+1)-mer edges.

    Returns ``(u_k, c_k, n_k, u_k1, n_k1)``; the k-mer multiset is
    derived from the (k+1)-mers (:func:`node_multiset_from_edges`)."""
    km1 = extract_kmers(codes, lengths, k + 1).reshape(-1)
    last = extract_last_kmer(codes, lengths, k)
    u_k, c_k, n_k = count_unique(node_multiset_from_edges(km1, last))
    u_k1, _c, n_k1 = count_unique(km1)
    return u_k, c_k, n_k, u_k1, n_k1


def _compact_counted_sorted(keys: torch.Tensor, cnts: torch.Tensor):
    """Reduce sorted keys with aligned counts to a unique table:
    ``(unique, counts, n_unique, inverse)`` where ``inverse[i]`` is the
    rank of ``keys[i]`` in ``unique``. SENTINEL keys must already be
    removed. Unlike the JAX version, runs may be of any length: the run
    sums are an ``index_add_`` over the inverse, not bounded shifted
    adds, so there is no overflow contract to check."""
    unique, inverse = torch.unique_consecutive(keys, return_inverse=True)
    unique = unique.clone()  # drop the input-sized allocation (see count_unique)
    counts = torch.zeros(unique.shape[0], dtype=torch.int64, device=keys.device)
    counts.index_add_(0, inverse, cnts.to(torch.int64))
    return unique, counts.to(torch.int32), int(unique.shape[0]), inverse


def merge_counted(unique_a, counts_a, unique_b, counts_b):
    """Merge two (sorted unique, counts) tables into one.

    Returns ``(unique, counts, n_unique, overflow)``. ``overflow`` counts
    keys that occur more than twice in the merge sort, which happens only
    when an input was not a unique table: the JAX version's compaction is
    bounded to runs of two and under-counts then, so it reports this
    scalar. The run sums here have no bound, but the check is kept so
    that a non-unique input is caught the same way.
    """
    keys = torch.cat([unique_a, unique_b])
    cnts = torch.cat([counts_a, counts_b])
    keys, order = torch.sort(keys, stable=True)
    cnts = cnts[order]
    del order
    overflow = int(((keys[2:] == keys[:-2]) & (keys[2:] != SENTINEL)).sum())
    keys = keys[: int((keys != SENTINEL).sum())]  # SENTINEL sorts last
    unique, counts, n, _inv = _compact_counted_sorted(keys, cnts[: keys.shape[0]])
    return unique, counts, n, overflow


# Bytes of counted parts (int64 key + int32 count per row) that the
# chunked counters keep on the device. Past it the oldest parts move to
# pinned host memory and are uploaded again at their merge. Sized with the
# single-pass budget (graph/dbg.py::SINGLE_PASS_MAX_WINDOWS, 53.7 GB on an
# 80 GB H100) so that a part's count plus the resident parts stay at or
# under 75% of the card (53.7-59.1 GB measured at 2-3B windows). A merge
# adds 52-59 bytes per merged row to what is resident (graph/dbg.py).
DEVICE_PARTS_BUDGET = 10_000_000_000


@dataclass
class _Part:
    """One entry of the merge stack: a counted table, the level of the
    binary counter it sits at, and whether it was spilled to the host."""

    u: torch.Tensor
    c: torch.Tensor
    level: int
    device: torch.device
    spilled: bool = False


def _part_nbytes(u) -> int:
    """(int64 key + int32 count) bytes of one part."""
    return int(u.shape[0]) * 12


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory when ``t`` is on a card."""
    if t.device.type == "cpu":
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _spill(p: _Part) -> None:
    p.u, p.c = _to_host(p.u), _to_host(p.c)
    p.spilled = True


def _merge_two(a: _Part, b: _Part) -> _Part:
    """Merge two stack entries into one at the next level."""
    dev = a.device
    mu, mc, _n, ovf = merge_counted(
        a.u.to(dev, non_blocking=True), a.c.to(dev, non_blocking=True),
        b.u.to(dev, non_blocking=True), b.c.to(dev, non_blocking=True),
    )
    if ovf != 0:
        raise RuntimeError("merge_counted fed a non-unique table")
    return _Part(mu, mc, max(a.level, b.level) + 1, dev)


def _merge_stack_push(stack: list, u: torch.Tensor, cnt: torch.Tensor) -> None:
    """Push one counted table onto a binary-counter merge stack.

    Equal-level neighbours merge at once (mergesort's binary counter), so
    at most about log2(K) parts of K are alive. When the device-resident
    parts exceed ``DEVICE_PARTS_BUDGET`` bytes, the oldest move to the
    host (pinned) and are uploaded again at their merge.
    """
    stack.append(_Part(u, cnt, 0, u.device))
    while len(stack) >= 2 and stack[-1].level == stack[-2].level:
        b = stack.pop()
        a = stack.pop()
        stack.append(_merge_two(a, b))
    live = sum(_part_nbytes(p.u) for p in stack if not p.spilled)
    for p in stack:  # oldest (merged last) first
        if live <= DEVICE_PARTS_BUDGET:
            break
        if not p.spilled:
            live -= _part_nbytes(p.u)
            _spill(p)


def _merge_stack_drain(stack: list, device):
    """Merge what is left on the stack (newest, smallest first):
    ``(unique, counts, n)`` on ``device``."""
    dev = torch.device(device)
    if not stack:
        return (
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            0,
        )
    while len(stack) > 1:
        b = stack.pop()
        a = stack.pop()
        stack.append(_merge_two(a, b))
    p = stack.pop()
    return p.u.to(dev), p.c.to(dev), int(p.u.shape[0])


def count_unique_chunked(codes, lengths, k: int, chunk_rows: int, device="cuda"):
    """Memory-bounded k-mer counting: count row chunks, then merge.

    Peak device memory is one chunk's windows plus one pairwise merge.
    Returns ``(unique, counts, n_unique)`` like :func:`count_unique`.
    """
    dev = torch.device(device)
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)

    def counted():
        for lo in range(0, codes.shape[0], chunk_rows):
            c = torch.as_tensor(codes[lo : lo + chunk_rows], device=dev)
            ln = torch.as_tensor(lengths[lo : lo + chunk_rows], device=dev)
            km = extract_kmers(c, ln, k).reshape(-1)
            del c, ln
            yield count_unique(km)

    return _reduce_counted(counted(), dev, verbose=False)


def _count_edge_part(codes, lengths, k: int, w_cap, add_rc: bool = False):
    """(k+1)-mer count of one row part already on the device. With
    ``add_rc`` the reverse-complement strand joins as the elementwise RC
    of the forward windows, so no RC code matrix is ever built."""
    km1 = extract_kmers(codes, lengths, k + 1, w_cap=w_cap).reshape(-1)
    if add_rc:
        km1 = torch.cat([km1, revcomp_kmers(km1, k + 1)])
    return count_unique(km1)


def _count_edge_chunk(codes, lengths, start: int, k: int, w_cap, chunk_rows: int,
                      add_rc: bool = False):
    """(k+1)-mer count of rows ``[start, start + chunk_rows)`` of a code
    matrix that is on the device whole (sliced there, not on the host)."""
    return _count_edge_part(
        codes[start : start + chunk_rows], lengths[start : start + chunk_rows],
        k, w_cap, add_rc,
    )


def count_edges_chunked(codes, lengths, k: int, chunk_rows: int,
                        w_cap: int | None = None, verbose: bool = False,
                        add_rc: bool = False, device="cuda"):
    """Memory-bounded (k+1)-mer counting of a code matrix uploaded once:
    per-chunk count + merge stack. Only the edge table is counted; the
    node table is derived from it (:func:`derive_nodes_from_edges`).
    Returns ``(u_k1, c_k1, n_k1)``."""
    dev = torch.device(device)
    codes_t = torch.as_tensor(np.asarray(codes, dtype=np.uint8), device=dev)
    lengths_t = torch.as_tensor(np.asarray(lengths, dtype=np.int32), device=dev)
    counted = (
        _count_edge_chunk(codes_t, lengths_t, s, k, w_cap, chunk_rows, add_rc)
        for s in range(0, max(int(codes_t.shape[0]), 1), chunk_rows)
    )
    return _reduce_counted(counted, dev, verbose)


def count_edges_parts(parts, k: int, w_cap: int | None = None,
                      add_rc: bool = False, verbose: bool = False, device="cuda"):
    """Memory-bounded (k+1)-mer counting over row parts uploaded one at a
    time. ``parts`` is an iterable of ``(codes, lengths)`` device tensors
    (a generator that uploads each part when asked keeps one on the
    device at a time); each part is counted and dropped before its table
    joins the merge stack. Returns ``(u_k1, c_k1, n_k1)``."""
    def counted():
        for codes_t, lengths_t in parts:
            res = _count_edge_part(codes_t, lengths_t, k, w_cap, add_rc)
            del codes_t, lengths_t
            yield res

    return _reduce_counted(counted(), torch.device(device), verbose)


def _reduce_counted(counted, dev: torch.device, verbose: bool):
    """Push each ``(u, c, n)`` of ``counted`` onto a merge stack, drain
    it, and with ``verbose`` print the count and merge seconds of each
    part and how many parts went to the host."""
    from mcaat_tpu_torch.utils.profiling import sync

    stack: list = []
    t_count = t_merge = 0.0
    t0 = time.perf_counter()
    pi = 0
    for pi, (u, cnt, nu) in enumerate(counted, start=1):
        if verbose:
            sync(dev)
        tm = time.perf_counter()
        _merge_stack_push(stack, u, cnt)
        del u, cnt
        if verbose:
            sync(dev)
        tm2 = time.perf_counter()
        t_count += tm - t0
        t_merge += tm2 - tm
        if verbose:
            print(
                f"    [build]     part {pi}: count {tm - t0:.2f}s, "
                f"merge {tm2 - tm:.2f}s ({nu} unique)",
                flush=True,
            )
        t0 = time.perf_counter()
    if verbose:
        spilled = sum(1 for p in stack if p.spilled)
        print(
            f"    [build]   {pi} part counts: {t_count:.2f}s + interleaved merges: "
            f"{t_merge:.2f}s (stack={len(stack)}, host-spilled={spilled})",
            flush=True,
        )
    res = _merge_stack_drain(stack, dev)
    if verbose:
        sync(dev)
        print(f"    [build]   final merge: {time.perf_counter() - t0:.2f}s", flush=True)
    return res


def count_kmers_for_reads(codes, lengths, k: int, device="cuda"):
    """Host-facing: unique sorted k-mers and their counts (numpy) for a
    read batch."""
    dev = torch.device(device)
    kmers = extract_kmers(
        torch.as_tensor(np.asarray(codes, dtype=np.uint8), device=dev),
        torch.as_tensor(np.asarray(lengths, dtype=np.int32), device=dev), k,
    )
    unique, counts, _n = count_unique(kmers.reshape(-1))
    return unique.cpu().numpy(), counts.cpu().numpy()


def host_endpoint_kmers(
    codes: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """First/last k-window of each read, packed int64, on HOST numpy:
    the two k-mers the mapper's keep predicate needs (reference
    src/reads.cpp:74-76), without uploading the code matrix. Returns
    ``(first_km [R], last_km [R])``; reads shorter than ``k`` get
    SENTINEL."""
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    R, L = codes.shape
    sen = np.int64(SENTINEL)
    if L < k or R == 0:
        s = np.full(R, sen, dtype=np.int64)
        return s, s.copy()
    first = np.zeros(R, dtype=np.int64)
    for t in range(k):
        first = (first << 2) | codes[:, t].astype(np.int64)
    start = np.maximum(lengths - k, 0)
    idx = np.minimum(start[:, None] + np.arange(k, dtype=np.int64)[None, :], L - 1)
    g = np.take_along_axis(codes, idx, axis=1).astype(np.int64)
    last = np.zeros(R, dtype=np.int64)
    for t in range(k):
        last = (last << 2) | g[:, t]
    ok = lengths >= k
    return np.where(ok, first, sen), np.where(ok, last, sen)


def derive_nodes_from_edges(u_k1, c_k1, u_last, c_last):
    """Node (k-mer) table derived from the unique (k+1)-mer edge table.

    Every k-window of a read is either the prefix of one of its
    (k+1)-windows or the read's last k-window, so

        c_k(x) = sum over (k+1)-mers e with prefix x of c_{k+1}(e)
                 + c_last(x).

    ``u_k1``/``c_k1`` are the live unique (k+1)-mers with counts (no
    SENTINEL rows); ``u_last``/``c_last`` the counted last-window table.
    Returns ``(u_k, c_k, n_k, u_id)``: the sorted node table, its counts,
    its size, and int32 ``[E]`` prefix node ids — each edge's source
    endpoint, which spares the adjacency build its source-side join.
    """
    E = u_k1.shape[0]
    keys = torch.cat([u_k1 >> 2, u_last])
    cnts = torch.cat([c_k1, c_last])
    order = torch.sort(keys, stable=True).indices
    u_k, c_k, n_k, inv_sorted = _compact_counted_sorted(keys[order], cnts[order])
    inverse = torch.empty_like(inv_sorted)
    inverse[order] = inv_sorted
    return u_k, c_k, n_k, inverse[:E].to(torch.int32)
