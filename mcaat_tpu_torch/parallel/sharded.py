"""Sharding over cards and processes: data-parallel reads × a
k-mer-space-partitioned graph.

Port of ``mcaat_tpu/parallel/sharded.py``. The mesh axes are the JAX
package's: ``dp`` shards reads, ``kp`` radix-partitions the k-mer space
by the top bits of the packed k-mer, so the sorted node table, the
multiplicities and the adjacency live distributed over the shards.

* k-mer counting: local extraction → bucket by owner (one sort, since
  the owner id *is* the top bits) → ``all_to_all`` over ``kp`` →
  ``all_gather`` over ``dp`` → local sort + run-length reduce.
* query routing: queries bucketed by owner, ``all_to_all`` to the owner
  shards, local binary search, ``all_to_all`` back, inverse permutation.

Where the JAX version works on fixed-capacity, sentinel-padded buffers
and counts what overflowed (``dropped``), every bucket here has its exact
length (``parallel/exchange.py``), so there is no capacity to choose, no
overflow and no counter. Per-shard values are Python lists with one
tensor per local slot of the mesh, each on its slot's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mcaat_tpu_torch import resolve_device
from mcaat_tpu_torch.kmer.count import count_unique, extract_kmers
from mcaat_tpu_torch.parallel.exchange import (
    Mesh,
    all_gather_dp,
    all_to_all,
    psum,
)


def default_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """The shard devices of a default mesh: every visible CUDA device
    once, or one CPU shard when the run's device is the CPU.

    ``MCAAT_TORCH_SHARDS=N`` is a test switch, the counterpart of XLA's
    forced host device count: the list then has N shards dealt round-robin
    over those devices, so one card (or the CPU) runs the whole routing
    logic of an N-shard mesh.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    n = int(os.environ.get("MCAAT_TORCH_SHARDS", "0") or 0)
    if n > 0:
        return [base[i % len(base)] for i in range(n)]
    return base


def mesh_dims(n: int, dp: int | None = None) -> tuple[int, int]:
    """``(dp, kp)`` for ``n`` shards: ``kp`` the largest power of two that
    divides ``n`` (the radix bits) and ``dp`` the rest, or the caller's
    ``dp``."""
    if dp is None:
        kp = 1 << (n.bit_length() - 1)
        while n % kp:
            kp >>= 1
        dp = n // kp
    kp = n // dp
    if dp * kp != n or kp & (kp - 1):
        raise ValueError(f"cannot build mesh: n={n}, dp={dp}, kp={kp}")
    return dp, kp


def make_pipeline_mesh(devices=None, dp: int | None = None) -> Mesh:
    """Build a one-process ("dp", "kp") mesh over ``devices``, a list of
    ``torch.device`` in which the same device may appear more than once
    (default: :func:`default_devices`). ``kp`` must be a power of two."""
    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    dp, kp = mesh_dims(n, dp)
    return Mesh(dp=dp, kp=kp, slot_proc=(0,) * n, local_devices=tuple(devices))


def _owner_shift(k: int, kp: int) -> int:
    return 2 * k - (kp.bit_length() - 1)


def kmer_bounds(k: int, kp: int) -> list[int]:
    """The ``kp + 1`` owner bounds of the packed k-mer space: shard ``s``
    owns ``[bounds[s], bounds[s+1])``; SENTINEL lies past the last."""
    shift = _owner_shift(k, kp)
    return [s << shift for s in range(kp + 1)]


def _cut(sorted_vals: torch.Tensor, bounds: list[int]) -> list[int]:
    """Positions of ``bounds`` in a sorted tensor (one host sync)."""
    b = torch.tensor(bounds, dtype=sorted_vals.dtype, device=sorted_vals.device)
    return torch.searchsorted(sorted_vals, b).tolist()


def _slice_by_owner(sorted_kmers: torch.Tensor, kp: int, shift: int) -> list[torch.Tensor]:
    """``kp`` send buckets of exact length out of SORTED packed k-mers.

    Sorting groups the k-mers by owner (the owner id is the top bits);
    SENTINEL sorts last and is sent nowhere. The graph build sorts every
    slot's k-mers first and slices afterwards: the slice waits for its
    device (one host sync), the other devices' sorts run meanwhile.
    """
    cuts = _cut(sorted_kmers, [o << shift for o in range(kp + 1)])
    return [sorted_kmers[cuts[d] : cuts[d + 1]] for d in range(kp)]


def _bucket_by_owner(kmers_flat: torch.Tensor, kp: int, shift: int) -> list[torch.Tensor]:
    """Sort + slice into ``kp`` send buckets (see :func:`_slice_by_owner`)."""
    return _slice_by_owner(torch.sort(kmers_flat).values, kp, shift)


def route(mesh: Mesh, values: list, bounds: list[int], stage: str | None = None,
          extra: list | None = None):
    """Route every entry of ``values[i]`` to the kp shard that owns it.

    ``bounds`` are ``kp + 1`` ascending owner bounds in the values' own
    order (packed k-mers or global node ids); entries outside
    ``[bounds[0], bounds[kp])`` are dead and go nowhere. One stable sort
    per slot groups the entries by owner. ``extra`` tensors (aligned with
    ``values``) ride along through the same permutation.

    Returns ``(recv, recv_extra, plan)``: ``recv[j][s]`` holds what kp
    column ``s`` sent to local slot ``j`` (ascending), and ``plan`` is
    what :func:`route_back` needs to return the answers.
    """
    kp = mesh.kp
    buckets, xbuckets, plan = [], [], []
    # every slot's sort is queued before the first cut waits for its device
    sorts = [torch.sort(v, stable=True) for v in values]
    for i, (v, (sv, order)) in enumerate(zip(values, sorts)):
        cuts = _cut(sv, bounds)
        buckets.append([sv[cuts[d] : cuts[d + 1]] for d in range(kp)])
        if extra is not None:
            xs = extra[i][order]
            xbuckets.append([xs[cuts[d] : cuts[d + 1]] for d in range(kp)])
        plan.append((order, cuts[0], cuts[kp], int(v.shape[0])))
    recv = all_to_all(mesh, buckets, stage)
    recv_extra = all_to_all(mesh, xbuckets, stage) if extra is not None else None
    return recv, recv_extra, plan


def route_back(mesh: Mesh, plan: list, answers: list, fill, stage: str | None = None) -> list:
    """Return ``answers[j][s]`` (one row per entry of ``recv[j][s]``) to
    the slots that asked, in the order of their ``values``; dead entries
    get ``fill``."""
    back = all_to_all(mesh, answers, stage)
    out = []
    for i, (order, lo, hi, n) in enumerate(plan):
        got = torch.cat(back[i])
        res_sorted = torch.full((n,) + tuple(got.shape[1:]), fill, dtype=got.dtype,
                                device=got.device)
        res_sorted[lo:hi] = got
        res = torch.empty_like(res_sorted)
        res[order] = res_sorted
        out.append(res)
    return out


def split_rows(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray) -> list:
    """This process's read rows dealt in contiguous blocks to its local
    slots, uploaded: ``[(codes, lengths)]`` per local slot."""
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    edges = np.linspace(0, codes.shape[0], mesh.n_local + 1).astype(np.int64)
    out = []
    for i, dev in enumerate(mesh.local_devices):
        lo, hi = int(edges[i]), int(edges[i + 1])
        out.append(
            (
                torch.as_tensor(np.ascontiguousarray(codes[lo:hi]), device=dev),
                torch.as_tensor(lengths[lo:hi], device=dev),
            )
        )
    return out


def sharded_count_kmers(mesh: Mesh, codes, lengths, k: int):
    """Distributed k-mer counting over the ("dp", "kp") mesh.

    ``codes``/``lengths`` are this process's read rows (host numpy); they
    are sharded over both axes for extraction, re-merged over ``kp`` by
    the ``all_to_all`` and over ``dp`` by the ``all_gather``. Returns
    ``(unique, counts)``: per local slot the sorted unique k-mers of its
    kp range (int64, exact size) and their counts (int32).
    """
    kp = mesh.kp
    shift = _owner_shift(k, kp)
    buckets = [
        _bucket_by_owner(extract_kmers(codes_l, lengths_l, k).reshape(-1), kp, shift)
        for codes_l, lengths_l in split_rows(mesh, codes, lengths)
    ]
    recv = all_to_all(mesh, buckets, "count_kmers")
    mine = all_gather_dp(mesh, [torch.cat(r) for r in recv], "count_kmers")
    unique, counts = [], []
    for m in mine:
        u, c, _n = count_unique(m)
        unique.append(u)
        counts.append(c)
    return unique, counts


def sharded_lookup(mesh: Mesh, table: list, queries: list, k: int,
                   stage: str | None = "lookup") -> list:
    """Distributed k-mer → owner-local index lookup (frontier exchange).

    ``table[j]`` is local slot ``j``'s sorted unique k-mer table,
    ``queries[i]`` the packed k-mers local slot ``i`` asks for. Each query
    is routed to its owner shard, binary-searched in the owner's table,
    and the owner-local hit index is routed back. Returns, per local
    slot, int32 indices aligned with its queries, -1 for misses and for
    SENTINEL queries.
    """
    recv, _x, plan = route(mesh, queries, kmer_bounds(k, mesh.kp), stage)
    answers = []
    for j, row in enumerate(recv):
        tloc = table[j]
        ans = []
        for q in row:
            if tloc.shape[0] == 0:
                ans.append(torch.full(q.shape, -1, dtype=torch.int32, device=q.device))
                continue
            pos = torch.clamp(torch.searchsorted(tloc, q), max=tloc.shape[0] - 1)
            ans.append(torch.where(tloc[pos] == q, pos, -1).to(torch.int32))
        answers.append(ans)
    return route_back(mesh, plan, answers, -1, stage)


def sharded_pipeline_step(mesh: Mesh, codes, lengths, k: int) -> dict:
    """One full distributed pipeline step (the dry-run "training step").

    Count k-mers across the mesh, then route every read's k-mer back
    through the sharded table (the read-mapping and frontier
    communication pattern), and reduce basic stats. Exercises
    ``all_to_all`` (kp), ``all_gather`` (dp) and ``psum``.
    """
    unique, counts = sharded_count_kmers(mesh, codes, lengths, k)
    queries = [
        extract_kmers(c, ln, k).reshape(-1) for c, ln in split_rows(mesh, codes, lengths)
    ]
    idx = sharded_lookup(mesh, unique, queries, k)
    prim = mesh.primary
    return {
        "n_unique": int(psum(mesh, sum(int(unique[i].shape[0]) for i in prim))),
        "n_hit": int(psum(mesh, sum(int((x >= 0).sum()) for x in idx))),
        "total_mult": int(psum(mesh, sum(int(counts[i].sum()) for i in prim))),
    }
