"""Read → node-chain mapping (torch).

Port of ``mcaat_tpu/reads/mapper.py``, which replaces reference
``src/reads.cpp:33-130``. A read is kept iff its first or last window's
node is in the cycle-node set (src/reads.cpp:74-76), so the keep decision
needs only the two endpoint k-mers of each read, joined against the
cycle nodes' own k-mer table; full window chains are then extracted and
looked up for the kept reads alone. A kept read is its full chain of
node ids, including misses (-1).

Reads with ``len(seq) <= 2k`` are skipped (src/reads.cpp:64-66). Mate-2
sequences are reverse-complemented before mapping (src/reads.cpp:116-127).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG, _lookup
from mcaat_tpu_torch.io.fastq import ReadBatch, encode_sequences
from mcaat_tpu_torch.kmer.count import (
    extract_first_kmer,
    extract_kmers,
    extract_last_kmer,
    revcomp_kmers,
)
from mcaat_tpu_torch.reads.chains import Chains


def map_reads_to_nodes(graph: DBG, batch: ReadBatch) -> tuple[np.ndarray, np.ndarray]:
    """All window node-ids per read: ``ids[R, W]`` int32 (-1 miss) and
    ``n_windows[i] = lengths[i] - k + 1`` live windows per read, both as
    numpy, computed on the graph's device."""
    if batch.num_reads == 0 or batch.max_len < graph.k:
        return (
            np.zeros((batch.num_reads, 0), dtype=np.int32),
            np.zeros((batch.num_reads,), dtype=np.int32),
        )
    dev = graph.device
    kmers = extract_kmers(
        torch.as_tensor(np.ascontiguousarray(batch.codes, dtype=np.uint8), device=dev),
        torch.as_tensor(np.asarray(batch.lengths, dtype=np.int32), device=dev),
        graph.k,
    )
    ids = graph.lookup(kmers.reshape(-1)).reshape(kmers.shape)
    n_windows = np.maximum(np.asarray(batch.lengths) - graph.k + 1, 0).astype(np.int32)
    return ids.cpu().numpy(), n_windows


def chains_from_ids(
    ids: np.ndarray,
    n_windows: np.ndarray,
    lengths: np.ndarray,
    k: int,
    cycle_nodes: set[int],
) -> Chains:
    """Filter + materialize node chains (≙ get_read_from_sequence).

    The keep predicate (first-or-last window node in the cycle set,
    src/reads.cpp:74-76) is evaluated vectorized over all reads; only
    the kept reads materialize, flat (``Chains``)."""
    R = ids.shape[0]
    if R == 0 or ids.shape[1] == 0:
        return Chains.empty()
    lengths = np.asarray(lengths)
    n_windows = np.asarray(n_windows)
    firsts = ids[:, 0]
    lasts = ids[np.arange(R), np.clip(n_windows - 1, 0, ids.shape[1] - 1)]
    cyc = np.fromiter(cycle_nodes, dtype=np.int64, count=len(cycle_nodes))
    cyc.sort()
    eligible = (lengths > 2 * k) & (n_windows > 0)
    keep = eligible & (np.isin(firsts, cyc) | np.isin(lasts, cyc))
    kept = np.nonzero(keep)[0]
    return Chains.from_dense(ids[kept], n_windows[kept])


def get_reads(
    graph: DBG,
    fastq_file_1: str,
    fastq_file_2: Optional[str],
    cycles: list[list[int]],
    verbose: bool = False,
    batches: Optional[dict] = None,
    endpoints: Optional[dict] = None,
    region_provider=None,
) -> Chains:
    """≙ reference ``get_reads`` (src/reads.cpp:91-130).

    ``batches`` (``{path: ReadBatch}``) reuses the build stage's parse.
    ``endpoints`` (``{path: (first_km, last_km)}`` device tensors in RAW
    orientation, stashed by the build) lets the keep decision run without
    re-uploading codes; the mate-2 endpoints are the bit-math RC of the
    raw ones, swapped: first(RC(r)) == revcomp(last(r)).

    ``region_provider``: a callable ``read_chain_len -> (table_kmers,
    table_ids) | None``. When given, it is called once with the first
    kept read's window count and the kept chains join against that small
    sorted table (the cycle region's nodes) instead of the full node
    table; windows outside it map to -1. This is output-identical for
    the ordering stage (see the proof at mcaat_tpu/reads/mapper.py).
    """
    from mcaat_tpu_torch.io.fastq import read_encoded_batch, reverse_complement_batch
    from mcaat_tpu_torch.utils.profiling import count, span

    sync_dev = graph.device if verbose else None

    def _batch(path: str):
        if batches is not None and path in batches:
            return batches[path]
        with span("parse"):
            batch = read_encoded_batch(path)
            count(reads=batch.num_reads)
        return batch

    def _eps(path: str, mate2: bool):
        if not endpoints or path not in endpoints:
            return None
        first_km, last_km = endpoints[path]
        if mate2:
            return revcomp_kmers(last_km, graph.k), revcomp_kmers(first_km, graph.k)
        return first_km, last_km

    with span("cycle_table", device=sync_dev):
        cycle_nodes: set[int] = set()
        for cycle in cycles:
            cycle_nodes.update(int(n) for n in cycle)
        cyc_km = _bucketed_cycle_kmer_table(graph, cycle_nodes)
    plan = []
    b1 = _batch(fastq_file_1)
    with span("keep", device=sync_dev):
        plan.append((b1, _phase1_kept(graph, b1, cyc_km, _eps(fastq_file_1, False))))
        count(kept_reads=len(plan[0][1]))
    if fastq_file_2:
        b2 = _batch(fastq_file_2)
        with span("mate2_revcomp"):
            b2 = reverse_complement_batch(b2)
            count(revcomp_mates=b2.num_reads)
        with span("keep_mate2", device=sync_dev):
            plan.append((b2, _phase1_kept(graph, b2, cyc_km, _eps(fastq_file_2, True))))
            count(kept_reads=len(plan[1][1]))

    table = None
    if region_provider is not None:
        # the region hop count is the FIRST kept read's window count —
        # exactly the len(reads[0]) the ordering stage uses
        with span("region_table", device=sync_dev):
            for b, kept in plan:
                if len(kept):
                    table = region_provider(int(b.lengths[kept[0]]) - graph.k + 1)
                    break

    with span("map", device=sync_dev):
        parts = [
            _chains_for_kept(graph, b.codes, b.lengths, kept, 1 << 20, table=table)
            for b, kept in plan
        ]
        return Chains.concat(parts)


def _phase1_kept(graph: DBG, batch: ReadBatch, cyc_km, endpoints) -> np.ndarray:
    """Kept-read indices of one batch (the endpoint keep predicate), from
    the build's endpoint stash when given, else from the codes."""
    R_total = batch.num_reads
    if R_total == 0 or int(np.asarray(batch.lengths).max(initial=0)) < graph.k:
        return np.zeros(0, dtype=np.int64)
    dev = graph.device
    if endpoints is not None:
        first_km, last_km = endpoints
        lengths = torch.as_tensor(np.asarray(batch.lengths, dtype=np.int32), device=dev)
        keep = _keep_from_endpoints(
            cyc_km, first_km[:R_total], last_km[:R_total], lengths, graph.k
        )
        return torch.nonzero(keep).flatten().cpu().numpy()
    kept_parts = []
    chunk_reads = 1 << 20
    for lo in range(0, R_total, chunk_reads):
        c_np = batch.codes[lo : lo + chunk_reads]
        l_np = np.asarray(batch.lengths[lo : lo + chunk_reads], dtype=np.int32)
        if int(l_np.max(initial=0)) < graph.k:
            continue
        keep = _endpoint_keep_mask(
            cyc_km,
            torch.as_tensor(np.ascontiguousarray(c_np), device=dev),
            torch.as_tensor(l_np, device=dev),
            graph.k,
        )
        kept_parts.append(lo + torch.nonzero(keep).flatten().cpu().numpy())
    if not kept_parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(kept_parts)


def _isin_sorted(x: torch.Tensor, table_sorted: torch.Tensor) -> torch.Tensor:
    """Membership of non-negative values in a sorted table."""
    if table_sorted.shape[0] == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    x64 = x.to(torch.int64)
    pos = torch.clamp(torch.searchsorted(table_sorted, x64), max=table_sorted.shape[0] - 1)
    return (x64 >= 0) & (table_sorted[pos] == x64)


def _endpoint_keep_mask(cyc_kmers, codes, lengths, k: int):
    """Keep predicate from the two endpoint windows only: the first or
    last k-mer's node is a cycle node (src/reads.cpp:74-76), tested by
    joining the endpoint k-mers against the cycle nodes' k-mer table."""
    first_km = extract_first_kmer(codes, lengths, k)
    last_km = extract_last_kmer(codes, lengths, k)
    return _keep_from_endpoints(cyc_kmers, first_km, last_km, lengths, k)


def _map_sequences(
    graph: DBG,
    sequences: list[str],
    cycle_nodes: set[int],
    chunk_reads: int = 1 << 20,
) -> Chains:
    """String-list convenience wrapper around :func:`_map_batch`."""
    if not sequences:
        return Chains.empty()
    return _map_batch(graph, encode_sequences(sequences), cycle_nodes, chunk_reads)


def _keep_from_endpoints(cyc_kmers, first_km, last_km, lengths, k: int):
    """Keep predicate from pre-extracted endpoint k-mers. SENTINEL
    endpoints (len < k rows) occur only on ineligible rows, and match
    nothing in the table either way."""
    eligible = lengths > 2 * k
    return eligible & (_isin_sorted(first_km, cyc_kmers) | _isin_sorted(last_km, cyc_kmers))


def _chains_for_kept(
    graph: DBG,
    codes_src: np.ndarray,
    lengths_src: np.ndarray,
    kept_idx: np.ndarray,
    chunk_reads: int,
    table=None,
) -> Chains:
    """Full window chains for the kept reads only, looked up in the node
    table or, with ``table`` (a sorted ``(kmers, ids)`` pair such as the
    cycle region's node table), in that table."""
    parts: list[Chains] = []
    for lo in range(0, len(kept_idx), chunk_reads):
        sel = kept_idx[lo : lo + chunk_reads]
        codes_k = torch.as_tensor(np.ascontiguousarray(codes_src[sel]), device=graph.device)
        lengths_np = np.asarray(lengths_src[sel], dtype=np.int32)
        kmers = extract_kmers(codes_k, torch.as_tensor(lengths_np, device=graph.device), graph.k)
        if table is not None:
            ids = _table_lookup_ids(table[0], table[1], kmers.reshape(-1))
        else:
            ids = graph.lookup(kmers.reshape(-1))
        ids_kept = ids.reshape(kmers.shape).cpu().numpy()
        parts.append(Chains.from_dense(ids_kept, np.maximum(lengths_np - graph.k + 1, 0)))
    return Chains.concat(parts)


def _table_lookup_ids(table_kms, table_ids, queries):
    """Window k-mers → ids through a small sorted ``(kmers, ids)`` side
    table; -1 for misses."""
    pos = _lookup(table_kms, queries).to(torch.int64)
    return torch.where(pos >= 0, table_ids[torch.clamp(pos, min=0)], -1).to(torch.int32)


def _bucketed_cycle_kmer_table(graph: DBG, cycle_nodes: set[int]) -> torch.Tensor:
    """Sorted cycle-node k-mer table for the keep joins: node id == k-mer
    rank, so gathering ``graph.kmers`` at the ascending cycle ids yields
    a sorted table. (Exact size: the JAX version pads it to a bucket.)"""
    cyc = np.fromiter(cycle_nodes, dtype=np.int64, count=len(cycle_nodes))
    cyc.sort()
    return graph.kmers[torch.as_tensor(cyc, device=graph.device)]


def _map_batch(
    graph: DBG,
    full_batch: ReadBatch,
    cycle_nodes: set[int],
    chunk_reads: int = 1 << 20,
    endpoints: tuple | None = None,
) -> Chains:
    """Keep decision + full chains for one batch (the direct-API entry;
    ``get_reads`` drives the same two phases itself)."""
    if full_batch.num_reads == 0:
        return Chains.empty()
    if int(np.asarray(full_batch.lengths).max(initial=0)) < graph.k:
        return Chains.empty()
    cyc_km = _bucketed_cycle_kmer_table(graph, cycle_nodes)
    kept_idx = _phase1_kept(graph, full_batch, cyc_km, endpoints)
    return _chains_for_kept(
        graph, full_batch.codes, full_batch.lengths, kept_idx, chunk_reads
    )

