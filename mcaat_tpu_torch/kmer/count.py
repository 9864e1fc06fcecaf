"""Device-side k-mer extraction and counting (torch).

Port of ``mcaat_tpu/kmer/count.py``: k-mers are packed big-endian into
int64 (k=23 → 46 bits, k+1=24 → 48 bits), sorted, and reduced to a
unique sorted table plus multiplicities. The solid threshold is m=1 (keep
everything), matching the reference's hardcoded ``"-m","1"``
(``src/sdbg_build.cpp:216``).

Tables here have exact sizes: where the JAX package pads to bucket sizes
so that XLA can reuse compiled programs, torch runs eagerly and needs no
padding. Dead windows are SENTINEL, which sorts last.

Unsigned 64-bit note: torch has no uint64 arithmetic, and ``>>`` on
int64 is arithmetic, so every right shift below is masked.
"""

from __future__ import annotations

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
    return unique, counts.to(torch.int32), int(unique.shape[0])


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


def _compact_counted_sorted(keys: torch.Tensor, cnts: torch.Tensor):
    """Reduce sorted keys with aligned counts to a unique table:
    ``(unique, counts, n_unique, inverse)`` where ``inverse[i]`` is the
    rank of ``keys[i]`` in ``unique``. SENTINEL keys must already be
    removed. Unlike the JAX version, runs may be of any length: the run
    sums are an ``index_add_`` over the inverse, not bounded shifted
    adds, so there is no overflow contract to check."""
    unique, inverse = torch.unique_consecutive(keys, return_inverse=True)
    counts = torch.zeros(unique.shape[0], dtype=torch.int64, device=keys.device)
    counts.index_add_(0, inverse, cnts.to(torch.int64))
    return unique, counts.to(torch.int32), int(unique.shape[0]), inverse


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
