"""End-to-end pipeline over a sharded graph — no full-graph compaction.

Port of ``mcaat_tpu/parallel/sharded_pipeline.py``. The graph stays
sharded through prune → candidate scan → neighbourhood extraction → read
mapping; only two *small* compactions ever happen:

1. the **enumeration subgraph** — the union forward-reachable set of the
   static start-node candidates within ``cycle_max_length`` steps
   (output-preserving, see ``cycles/neighborhood.py``) — for the host
   DFS;
2. the **ordering region** — the undirected ``read_len``-hop expansion
   of the cycle nodes (the set the reference keeps while it invalidates
   the rest, ``src/spacer_ordering.cpp:78-139``) — for the host
   combinatorial stages.

Both are proportional to CRISPR-candidate neighbourhoods, not to N.

Layout note: global id ``g = shard*T + local``, and a shard's flat
adjacency slot ``4*local + b`` is global slot ``4*g + b``: the same
addressing as the single-device ``DBG``.

Read-chain ids: everything downstream of the region compaction uses
compact local ids. Read-chain entries *outside* the region map to unique
negative surrogates (-2 - rank), distinct from the -1 miss value and from
every region id, which preserves the chains' equality structure (ordering
only ever tests membership and equality on them), so the ordering output
equals the single-device run's.

In a process group every process runs these host loops in full, on
replicated frontiers and ids, so each collective is entered by every
process in the same order. The one stage that is not replicated is read
mapping (each process maps its own records); its collectives are counted
out beforehand so that a process with nothing to map still enters them.
"""

from __future__ import annotations

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG
from mcaat_tpu_torch.parallel.exchange import all_gather_host, barrier, host_replicated
from mcaat_tpu_torch.utils.profiling import count, span
from mcaat_tpu_torch.parallel.sharded import (
    _owner_shift,
    default_devices,
    make_pipeline_mesh,
    sharded_lookup,
)
from mcaat_tpu_torch.parallel.sharded_graph import (
    ShardedDBG,
    _owner_gather,
    build_sharded_dbg,
    frontier_step,
    release_tags,
    routed_gather,
    sharded_candidate_ids,
    sharded_prune_and_candidates,
    tagged_adjacency,
)


# ---------------------------------------------------------------------------
# Distributed BFS (host-orchestrated frontier_step loops)
# ---------------------------------------------------------------------------


class HostBitset:
    """Packed host bitmap: N/8 bytes instead of an N-byte bool array, for
    the visited/reached sets of the BFS wrappers. Frontier-sized test/set
    batches only."""

    __slots__ = ("n", "bits")

    def __init__(self, n: int):
        self.n = int(n)
        self.bits = np.zeros((self.n + 7) // 8, dtype=np.uint8)

    def test(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        return (self.bits[idx >> 3] >> (idx & 7).astype(np.uint8)) & 1 != 0

    def set(self, idx: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        np.bitwise_or.at(
            self.bits, idx >> 3, np.uint8(1) << (idx & 7).astype(np.uint8)
        )

    def to_indices(self) -> np.ndarray:
        """Ascending set-bit indices (one transient O(N) unpack)."""
        u = np.unpackbits(self.bits, bitorder="little")[: self.n]
        return np.nonzero(u)[0]


def _mask_indices(mask) -> np.ndarray:
    if isinstance(mask, HostBitset):
        return mask.to_indices()
    return np.nonzero(np.asarray(mask).reshape(-1))[0]


def _seed_validity(sg: ShardedDBG, valid: list, gids: np.ndarray) -> np.ndarray:
    """Validity of a SMALL set of global ids: one seed-proportional
    owner-side gather instead of a download of the whole mask."""
    if len(gids) == 0:
        return np.zeros(0, dtype=bool)
    return routed_gather(sg.mesh, valid, gids, sg.T, "seed_validity").astype(bool)


def sharded_touched_mask(
    sg: ShardedDBG,
    valid: list,  # the current validity epoch (for the seed check)
    outv: list,  # adjacency TAGGED with the same epoch
    seeds: np.ndarray,  # global ids
    radius: int,
) -> HostBitset:
    """Union forward-reachable set from ``seeds`` within ``radius``
    out-steps through valid nodes.

    Each level is one :func:`frontier_step` over the validity-tagged
    adjacency; neighbour validity is the entry's sign, so there is no
    validity collective and no O(N) download. The frontier is the
    replicated one, so every process leaves the loop at the same level.
    """
    visited = HostBitset(sg.mesh.kp * sg.T)
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    seeds = seeds[_seed_validity(sg, valid, seeds)]
    visited.set(seeds)
    frontier = seeds
    for _ in range(radius):
        if len(frontier) == 0:
            break
        nbrs = frontier_step(sg.mesh, outv, frontier, sg.T, "touched_mask")
        new = np.unique(nbrs[nbrs >= 0])  # tagged (≤ -2) = invalid target
        new = new[~visited.test(new)]
        visited.set(new)
        frontier = new.astype(np.int64)
    return visited


def sharded_region_mask(
    sg: ShardedDBG,
    valid: list,  # the current validity epoch (for the seed check)
    outv: list,  # out-adjacency TAGGED with the same epoch
    inv: list,  # in-adjacency TAGGED with the same epoch
    seeds: np.ndarray,
    hops: int,
) -> HostBitset:
    """Undirected ``hops``-hop expansion of ``seeds``: invalid neighbours
    join the reached set but only valid nodes expand (≙ the reference's
    keep_crispr_regions_extended_by_k, src/spacer_ordering.cpp:96-129).

    The validity TAGS carry both facts per returned entry: the raw
    neighbour id (decoded from ``-2-gid``) joins the reached set, and only
    untagged (valid-target) entries expand.
    """
    reached = HostBitset(sg.mesh.kp * sg.T)
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    reached.set(seeds)
    frontier = seeds[_seed_validity(sg, valid, seeds)]
    for _ in range(hops):
        if len(frontier) == 0:
            break
        out_n = frontier_step(sg.mesh, outv, frontier, sg.T, "region_mask")
        in_n = frontier_step(sg.mesh, inv, frontier, sg.T, "region_mask")
        nbrs = np.concatenate([out_n.reshape(-1), in_n.reshape(-1)]).astype(np.int64)
        nbrs = nbrs[nbrs != -1]
        gid = np.where(nbrs <= -2, -2 - nbrs, nbrs)  # decode the tag
        uniq, first = np.unique(gid, return_index=True)
        uval = nbrs[first] >= 0  # tag ⇒ target validity, same for every copy
        fresh = ~reached.test(uniq)
        new = uniq[fresh]
        reached.set(new)
        frontier = new[uval[fresh]]
    return reached


# ---------------------------------------------------------------------------
# Subgraph compaction (the only host-sized materializations)
# ---------------------------------------------------------------------------


def extract_sharded_subgraph(sg: ShardedDBG, valid: list, mask) -> tuple[DBG, np.ndarray]:
    """Compact the masked global rows into a single-device DBG (on this
    process's first device) + the id map.

    ``mask`` is a HostBitset or a bool array over global rows. Adjacency
    entries leaving the mask become -1. ``gids`` is ascending, so
    compact-id order == global-id order == k-mer rank order, and every
    deterministic ordering downstream is preserved.
    """
    from mcaat_tpu_torch.cycles.neighborhood import remap_to_local

    mesh = sg.mesh
    gids = _mask_indices(mask).astype(np.int64)
    kmers = _owner_gather(mesh, sg.kmers, gids, sg.T, 1, 0, "extract_subgraph")
    mult = _owner_gather(mesh, sg.mult, gids, sg.T, 1, 0, "extract_subgraph")
    valid_sel = _owner_gather(mesh, valid, gids, sg.T, 1, False, "extract_subgraph")
    out_rows = _owner_gather(mesh, sg.out, gids, sg.T, 4, -1, "extract_subgraph")
    in_rows = _owner_gather(mesh, sg.in_, gids, sg.T, 4, -1, "extract_subgraph")
    graph = DBG.from_numpy(
        sg.k, kmers, mult,
        remap_to_local(gids, out_rows), remap_to_local(gids, in_rows),
        valid_sel, mesh.local_devices[0],
    )
    return graph, gids


# ---------------------------------------------------------------------------
# Cycle search on the sharded graph
# ---------------------------------------------------------------------------


def sharded_find_cycles(
    sg: ShardedDBG,
    threshold_multiplicity: int = 20,
    cycle_min_length: int = 27,
    cycle_max_length: int = 77,
    verbose: bool = True,
):
    """Distributed prune + candidate scan + neighbourhood-compacted host
    enumeration. Returns ``(valid, {global start: cycles})``.

    ≙ CycleFinder::FindApproximateCRISPRArrays
    (src/cycle_finder.cpp:433-492) with the whole-graph passes sharded.

    At ≥ ``cycles.finder.LAZY_CLIP_MIN_NODES`` live nodes the tip clip is
    DEFERRED to the extracted candidate neighbourhood, like the
    single-device lazy path (same threshold, so the same results). That
    path runs no chain collapse, no branch fixpoint and no O(N) host
    work: the mult filter, one adjacency tagging pass per array, the
    per-shard candidate compaction, and frontier-proportional BFS levels.
    The returned ``valid`` then carries the mult filter only, and
    :func:`condense_region` completes the clip on the condensed region.
    Below the threshold the full distributed prune runs
    (:func:`sharded_prune_and_candidates`), like ``prune_graph``.
    """
    from mcaat_tpu_torch.cycles import finder as _finder
    from mcaat_tpu_torch.cycles.finder import enumerate_on_arrays
    from mcaat_tpu_torch.cycles.start_nodes import bucket_start_nodes, self_reachable_batch
    from mcaat_tpu_torch.prune.prune import clip_tips

    lazy = sg.n_nodes >= _finder.LAZY_CLIP_MIN_NODES
    if lazy:
        valid = [v & (m > 1) for v, m in zip(sg.valid, sg.mult)]
        if verbose:
            print(
                f"Graph size: {sg.n_nodes} nodes; "
                f"tip clipping deferred to the candidate neighborhood"
            )
        outv, inv = tagged_adjacency(sg, valid)
        cand_ids = sharded_candidate_ids(sg, valid, outv, inv, threshold_multiplicity)
    else:
        valid, cand = sharded_prune_and_candidates(
            sg.mesh, sg.mult, sg.out, sg.in_, sg.valid, sg.T,
            threshold_multiplicity=threshold_multiplicity,
        )
        bases = [sg.gid_base(i) for i in range(sg.mesh.n_local)]
        cand_ids = host_replicated(
            sg.mesh, [torch.nonzero(c).flatten() + b for c, b in zip(cand, bases)]
        ).astype(np.int64)
        outv, _inv = tagged_adjacency(sg, valid)
    if verbose:
        print(f"ChunkStartNodes: {len(cand_ids)} candidates pass the static filter")
    if len(cand_ids) == 0:
        return valid, {}

    mask = sharded_touched_mask(sg, valid, outv, cand_ids, cycle_max_length)
    sub, gids = extract_sharded_subgraph(sg, valid, mask)
    if verbose:
        print(
            f"Neighborhood extraction: {len(gids)} nodes touched by "
            f"{len(cand_ids)} candidates (graph of {sg.n_nodes} nodes)"
        )
    if lazy:
        # deferred tip clip at neighbourhood scale (output-preserving, see
        # cycles/finder.LAZY_CLIP_MIN_NODES)
        sub, n_clipped = clip_tips(sub)
        if verbose:
            print(f"Neighborhood tip clip: {n_clipped} node(s) clipped")
    loc_cand = np.searchsorted(gids, cand_ids).astype(np.int64)
    reach = self_reachable_batch(sub, loc_cand, cycle_max_length)
    kept_loc = loc_cand[reach]
    host = sub.to_host()
    buckets_loc = bucket_start_nodes(kept_loc, host.mult[kept_loc], verbose=verbose)
    results_loc = enumerate_on_arrays(
        host.out, host.in_, host.valid, host.mult, buckets_loc,
        cycle_min_length, cycle_max_length, verbose=verbose,
    )
    results = {
        int(gids[start]): [[int(gids[v]) for v in cyc] for cyc in cycles]
        for start, cycles in results_loc.items()
    }
    return valid, results


# ---------------------------------------------------------------------------
# Read mapping through the sharded table
# ---------------------------------------------------------------------------


class MapSource:
    """One read-mapping input: a parsed (already RC'd for file 2) batch,
    its host-side endpoint k-mers, and the global file-order keys of its
    records. ``order_key[j]`` totally orders every record across sources
    AND processes (file-major, record-minor), so the merged chain list is
    deterministic and equals the single-process file order."""

    __slots__ = ("batch", "first_km", "last_km", "order_key")

    def __init__(self, batch, order_key: np.ndarray, k: int):
        from mcaat_tpu_torch.kmer.count import host_endpoint_kmers

        self.batch = batch
        self.first_km, self.last_km = host_endpoint_kmers(batch.codes, batch.lengths, k)
        self.order_key = np.asarray(order_key, dtype=np.int64)

    def release(self) -> None:
        """Drop the parsed code matrix and the endpoint stash: the mapper
        is the last consumer of read content."""
        self.batch = None
        self.first_km = None
        self.last_km = None
        self.order_key = None


_FILE_KEY = np.int64(1) << np.int64(44)  # order keys: file-major


def _sources(k: int, b1, b2) -> list[MapSource]:
    sources = [MapSource(b1, np.arange(b1.num_reads, dtype=np.int64), k)]
    if b2 is not None:
        sources.append(
            MapSource(b2, _FILE_KEY + np.arange(b2.num_reads, dtype=np.int64), k)
        )
    return sources


def default_map_sources(
    sg: ShardedDBG, fastq_file_1: str, fastq_file_2: str | None
) -> list[MapSource]:
    """Parse-the-files fallback (one-process callers without a batch
    cache)."""
    from mcaat_tpu_torch.io.fastq import read_encoded_batches

    with span("parse"):
        files = [fastq_file_1] + ([fastq_file_2] if fastq_file_2 else [])
        b1, b2 = (read_encoded_batches(files) + [None])[:2]
    return _sources(sg.k, b1, _mate2_revcomp(b2))


def _mate2_revcomp(b2):
    """Mate 2's rows reverse-complemented (None without a mate 2)."""
    from mcaat_tpu_torch.io.fastq import reverse_complement_batch

    if b2 is None:
        return None
    with span("mate2_revcomp"):
        count(revcomp_mates=b2.num_reads)
        return reverse_complement_batch(b2)


def sources_from_batches(sg: ShardedDBG, batches_by_path: dict,
                         fastq_file_1: str, fastq_file_2: str | None):
    """MapSources over ALREADY-PARSED batches: the pipeline parses each
    input once at build time and the mapper reuses the codes."""
    if fastq_file_1 not in batches_by_path or (
        fastq_file_2 and fastq_file_2 not in batches_by_path
    ):
        return default_map_sources(sg, fastq_file_1, fastq_file_2)
    b2 = batches_by_path[fastq_file_2] if fastq_file_2 else None
    return _sources(sg.k, batches_by_path[fastq_file_1], _mate2_revcomp(b2))


def _exchange_chains(mesh, chains, keys: np.ndarray):
    """Process group: gather every process's (local-record) chains and
    merge them into the global file order (a stable sort on the global
    record keys). Chains are CRISPR-anchored kept reads, so the volume is
    small. The flat ``Chains`` layout is the wire format."""
    from mcaat_tpu_torch.reads.chains import Chains

    chains = Chains.from_lists(chains)
    flats = all_gather_host(mesh, chains.flat)
    lenss = all_gather_host(mesh, chains.lengths().astype(np.int64))
    keyss = all_gather_host(mesh, np.asarray(keys, dtype=np.int64))
    all_lens = np.concatenate(lenss)
    offsets = np.zeros(len(all_lens) + 1, dtype=np.int64)
    np.cumsum(all_lens, out=offsets[1:])
    merged = Chains(np.concatenate(flats), offsets)
    order = np.argsort(np.concatenate(keyss), kind="stable")
    return merged.select(order)


def sharded_get_reads(
    sg: ShardedDBG,
    fastq_file_1: str,
    fastq_file_2: str | None,
    cycles: list[list[int]],
    chunk_reads: int = 1 << 20,
    sources: list[MapSource] | None = None,
    region_provider=None,
):
    """≙ reference get_reads (src/reads.cpp:91-130); chains carry GLOBAL
    node ids.

    ``sources`` carries already-parsed batches + host endpoint k-mers
    (phase 1 is host ``np.isin`` against the replicated cycle k-mer
    table: no uploads, no routed lookups). In a process group each
    process maps only its OWN record ranges and the kept chains are
    gathered into global file order, so every process still ends with the
    identical replicated chain list the downstream orchestration needs.

    ``region_provider`` (the at-scale path, like the single-device
    ``reads.mapper.get_reads``): a callable ``read_chain_len ->
    (sorted_kmers, global_ids) | None`` for the cycle REGION's node
    table. When given, it is called once with the GLOBALLY-first kept
    read's window count and phase 2 joins the kept windows against that
    small table on each process's own device. Out-of-region windows map
    to -1; the ordering output is the same (the proof is at
    mcaat_tpu/reads/mapper.py). Without it, every window routes to its
    owner shard (``sharded_lookup`` over kp) against the full table.
    """
    from mcaat_tpu_torch.reads.chains import Chains

    if sources is None:
        sources = default_map_sources(sg, fastq_file_1, fastq_file_2)
    cycle_nodes = sorted({int(n) for cyc in cycles for n in cyc})
    cyc_kms = _cycle_kmers_for_gids(sg, cycle_nodes)

    # phase 1 (host, per source): kept-read indices
    plan = [(src, _phase1_kept_sharded(sg, src, cyc_kms, chunk_reads)) for src in sources]

    table = None
    if region_provider is not None:
        rcl = _global_first_kept_windows(sg, plan)
        if rcl > 0:
            table = region_provider(rcl)

    parts: list[Chains] = []
    keys_parts: list[np.ndarray] = []
    for src, kept in plan:
        c, ky = _map_kept_sharded(sg, src, kept, chunk_reads, table)
        parts.append(c)
        keys_parts.append(ky)
    chains = Chains.concat(parts)
    keys = np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.int64)
    if sg.mesh.distributed:
        return _exchange_chains(sg.mesh, chains, keys)
    return chains.select(np.argsort(keys, kind="stable"))


def _global_first_kept_windows(sg: ShardedDBG, plan) -> int:
    """Window count of the globally-first kept read (by order key): the
    region-growth hop count. One small gather in a process group; every
    process computes the same value."""
    best_key = np.int64(np.iinfo(np.int64).max)
    best_win = np.int64(0)
    for src, kept in plan:
        if len(kept) == 0:
            continue
        j = int(kept[0])  # kept ascending ⇒ minimal order key of the source
        key = np.int64(src.order_key[j])
        if key < best_key:
            best_key = key
            best_win = np.int64(max(int(src.batch.lengths[j]) - sg.k + 1, 0))
    pairs = np.stack(
        all_gather_host(sg.mesh, np.asarray([best_key, best_win], dtype=np.int64))
    )
    return int(pairs[np.argmin(pairs[:, 0]), 1])


def _sharded_lookup_ids(sg: ShardedDBG, flat: torch.Tensor) -> np.ndarray:
    """Global node ids for a flat k-mer query tensor via the routed
    sharded lookup: the queries are dealt over this process's local
    slots, each routes its share to the owner shards, and the owner-local
    hits come back. Low-complexity reads may send every window to one
    shard; exact-length buckets take that as it comes."""
    mesh = sg.mesh
    shift = _owner_shift(sg.k, mesh.kp)
    Q = int(flat.shape[0])
    edges = np.linspace(0, Q, mesh.n_local + 1).astype(np.int64)
    queries = [
        flat[int(edges[i]) : int(edges[i + 1])].to(dev, non_blocking=True)
        for i, dev in enumerate(mesh.local_devices)
    ]
    idx = sharded_lookup(mesh, sg.kmers, queries, sg.k, stage="read_lookup")
    idx_h = np.concatenate([x.cpu().numpy() for x in idx]).astype(np.int64)
    flat_h = flat.cpu().numpy()
    owner = (flat_h >> shift).astype(np.int64)
    return np.where(idx_h >= 0, owner * sg.T + idx_h, -1).astype(np.int64)


def _cycle_kmers_for_gids(sg: ShardedDBG, cycle_nodes) -> np.ndarray:
    """K-mers of the cycle nodes (global ids) from the sharded table: one
    small owner-side gather, the same array on every process. Lets the
    keep decision run as host ``np.isin`` against the stashed endpoint
    k-mers (k-mer membership in the cycle set ⟺ node-id membership, since
    node k-mers are unique)."""
    gids = np.asarray(sorted(int(g) for g in cycle_nodes), dtype=np.int64)
    if len(gids) == 0:
        return np.zeros(0, dtype=np.int64)
    return routed_gather(sg.mesh, sg.kmers, gids, sg.T, "cycle_kmers")


def _phase1_kept_sharded(sg: ShardedDBG, src: MapSource,
                         cyc_kms: np.ndarray, chunk_reads) -> np.ndarray:
    """Phase 1: kept-read row indices of one source, pure host work (the
    stashed endpoint k-mers test membership in the replicated, small cycle
    k-mer table). Reference keep rule: first or last window node in the
    cycle set, src/reads.cpp:74-76; SENTINEL endpoints (len < k) never
    match a real cycle k-mer."""
    full_batch = src.batch
    if full_batch.num_reads == 0:
        return np.zeros(0, np.int64)
    k = sg.k
    if full_batch.max_len < k:
        return np.zeros(0, np.int64)
    kept = []
    for lo in range(0, full_batch.num_reads, chunk_reads):
        l_np = full_batch.lengths[lo : lo + chunk_reads]
        firsts_km = src.first_km[lo : lo + chunk_reads]
        lasts_km = src.last_km[lo : lo + chunk_reads]
        keep = (l_np > 2 * k) & (np.isin(firsts_km, cyc_kms) | np.isin(lasts_km, cyc_kms))
        kept.append(lo + np.nonzero(keep)[0])
    return np.concatenate(kept) if kept else np.zeros(0, np.int64)


def _map_kept_sharded(sg: ShardedDBG, src: MapSource, kept_idx: np.ndarray,
                      chunk_reads, table=None):
    """Phase 2: full window chains for one source's kept reads.

    With ``table`` (the cycle region's ``(sorted_kmers, global_ids)``
    tensors) the join runs on this process's own device against the small
    table: no routing. Without it, windows route to their owner shards
    (:func:`_sharded_lookup_ids`); the number of lookup rounds is agreed
    between the processes first, and a process that has fewer chunks (or
    no kept read at all) enters the remaining rounds with no query."""
    from mcaat_tpu_torch.kmer.count import extract_kmers
    from mcaat_tpu_torch.reads.chains import Chains
    from mcaat_tpu_torch.reads.mapper import _table_lookup_ids

    mesh = sg.mesh
    dev = mesh.local_devices[0]
    full_batch = src.batch
    k = sg.k
    if full_batch.max_len < k:
        kept_idx = kept_idx[:0]
    n_chunks = (len(kept_idx) + chunk_reads - 1) // chunk_reads
    rounds = n_chunks
    if table is None:
        rounds = int(max(np.concatenate(all_gather_host(mesh, np.asarray([n_chunks])))))
    parts: list[Chains] = []
    keys_parts: list[np.ndarray] = []
    for r in range(rounds):
        if r >= n_chunks:
            _sharded_lookup_ids(sg, torch.zeros(0, dtype=torch.int64, device=dev))
            continue
        sel = kept_idx[r * chunk_reads : (r + 1) * chunk_reads]
        lengths_k = np.asarray(full_batch.lengths[sel], dtype=np.int32)
        kmers = extract_kmers(
            torch.as_tensor(np.ascontiguousarray(full_batch.codes[sel]), device=dev),
            torch.as_tensor(lengths_k, device=dev), k,
        )
        if table is not None:
            ids = _table_lookup_ids(table[0], table[1], kmers.reshape(-1)).cpu().numpy()
        else:
            ids = _sharded_lookup_ids(sg, kmers.reshape(-1))
        n_windows = np.maximum(lengths_k - k + 1, 0).astype(np.int32)
        parts.append(Chains.from_dense(ids.reshape(kmers.shape), n_windows))
        keys_parts.append(src.order_key[sel])
    chains = Chains.concat(parts) if parts else Chains.empty()
    keys = np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.int64)
    return chains, keys


# ---------------------------------------------------------------------------
# Region condensation + id remapping for the host ordering stages
# ---------------------------------------------------------------------------


def condense_region(
    sg: ShardedDBG,
    valid: list,
    cycles: list[list[int]],
    reads,
    read_chain_len: int,
    region_mask: HostBitset | None = None,
):
    """Compact the read_len-hop cycle region and remap cycles + reads.

    Returns ``(region DBG with only region nodes, cycles_compact,
    reads_compact)``. Out-of-region read ids map to unique negative
    surrogates (see the module docstring; shared remap in
    ``cycles/neighborhood.remap_chains``).

    When the cycle stage ran lazy (``valid`` carries the mult filter
    only), the deferred tip clip completes HERE on the condensed region,
    like ``pipeline.spacer_ordering_step``'s region condensation;
    ``clip_tips`` is idempotent, so clipping is safe in either epoch.
    """
    from mcaat_tpu_torch.cycles import finder as _finder
    from mcaat_tpu_torch.cycles.neighborhood import remap_chains
    from mcaat_tpu_torch.prune.prune import clip_tips

    if region_mask is not None:
        # grown by the region-first mapper with the same seeds/hops/epoch
        reached = region_mask
    else:
        seeds = np.asarray(sorted({int(n) for cyc in cycles for n in cyc}), dtype=np.int64)
        outv, inv = tagged_adjacency(sg, valid)
        reached = sharded_region_mask(sg, valid, outv, inv, seeds, read_chain_len)
    region, gids = extract_sharded_subgraph(sg, valid, reached)
    if sg.n_nodes >= _finder.LAZY_CLIP_MIN_NODES:
        region, _ = clip_tips(region)
    # ≙ with_valid(valid & reached): everything outside the region is
    # invalid — inside the compact graph that is every remaining row
    cycles_c, reads_c = remap_chains(gids, cycles, reads)
    return region, cycles_c, reads_c


# ---------------------------------------------------------------------------
# The full downstream over a sharded graph (one process or a group)
# ---------------------------------------------------------------------------


def run_sharded_downstream(
    sg: ShardedDBG,
    settings,
    verbose: bool = True,
    write_report: bool = True,
    profiler=None,
    map_sources: list[MapSource] | None = None,
    checkpoint_dir: str | None = None,
):
    """Pipeline stages after a sharded build: distributed prune/candidate
    scan → neighbourhood-compacted cycle enumeration → read mapping →
    region condensation → host ordering → report.

    Process-group contract: every process calls this with the same
    ``sg``/``settings``. The host orchestration (frontier loops, candidate
    fixpoints, combinatorics) is REPLICATED, so every collective is
    entered by all processes in the same order and the computed
    ``PipelineResult`` is the same everywhere. The one stage that is not
    replicated is read mapping when ``map_sources`` carries per-process
    record ranges (see :func:`sharded_get_reads`). Only a
    caller-designated process should ``write_report`` (the others compute
    the same report text against os.devnull).

    ≙ the reference release main() from the CycleFinder call on
    (src/main.cpp:536-591) with the whole-graph stages distributed.
    """
    import json
    import os

    from mcaat_tpu_torch.cycles.finder import cycles_map_to_cycles
    from mcaat_tpu_torch.pipeline import (
        PipelineResult,
        _condense_threshold,
        benchmark_results,
        configure_threads,
        print_results,
        spacer_ordering_step,
    )
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer
    from mcaat_tpu_torch.utils.profiling import Profiler

    mesh = sg.mesh
    dev = mesh.local_devices[0]
    configure_threads(settings.threads)
    prof = profiler if profiler is not None else Profiler(mesh.local_devices, verbose=verbose)
    t0 = prof.elapsed()
    result = PipelineResult()
    cfs = settings.cycle_finder_settings

    ckpt = None
    if checkpoint_dir:
        from mcaat_tpu_torch import checkpoint as ckpt

        os.makedirs(checkpoint_dir, exist_ok=True)

    def _ck(name: str) -> str:
        return os.path.join(checkpoint_dir, name)

    # the cycle checkpoint holds global ids: it is good only for the
    # layout (kp, T) it was written under
    cycles_ck = False
    if checkpoint_dir and os.path.exists(_ck("cycles.json")):
        try:
            with open(os.path.join(_ck("valid_pruned"), "meta.json")) as fh:
                vmeta = json.load(fh)
            cycles_ck = vmeta["kp"] == mesh.kp and vmeta["T"] == sg.T
        except (OSError, ValueError, KeyError):
            cycles_ck = False
    if cycles_ck:
        cycles_map = ckpt.load_cycles(_ck("cycles.json"))
        valid = ckpt.load_sharded_valid(_ck("valid_pruned"), mesh, sg.n_live)
        if verbose:
            print(f"Cycles loaded from checkpoint: {len(cycles_map)} start nodes")
    else:
        with prof.stage("cycle_search"):
            valid, cycles_map = sharded_find_cycles(
                sg,
                threshold_multiplicity=cfs.threshold_multiplicity,
                cycle_min_length=cfs.cycle_min_length,
                cycle_max_length=cfs.cycle_max_length,
                verbose=verbose,
            )
        if checkpoint_dir:
            if mesh.proc == 0:
                ckpt.save_cycles(_ck("cycles.json"), cycles_map)
            ckpt.save_sharded_valid(_ck("valid_pruned"), mesh, valid, sg.T)
    prof.count("cycle_search", start_nodes=len(cycles_map))
    result.cycles_map = cycles_map
    result.cycles = cycles_map_to_cycles(cycles_map)
    if verbose:
        print(f"Number of nodes in results: {len(cycles_map)}")
        print("🔸STEP 6: Finding relevant reads")

    f1, f2 = settings.fastq_files()

    # region-first mapping at condense scale (like pipeline.run_pipeline):
    # the cycle region grows before the chain lookup and phase 2 joins the
    # kept windows against its small node table on each process's own
    # device; the ordering stage reuses the mask
    region_state: dict = {}

    def _region_provider(read_chain_len: int):
        seeds = np.asarray(
            sorted({int(n) for cyc in result.cycles for n in cyc}), dtype=np.int64
        )
        outv, inv = tagged_adjacency(sg, valid)
        reached = sharded_region_mask(sg, valid, outv, inv, seeds, read_chain_len)
        region_state["mask"] = reached
        region_state["read_chain_len"] = read_chain_len
        gids = reached.to_indices().astype(np.int64)
        if len(gids) == 0:
            return None
        # gids ascending + shards own ascending k-mer ranges ⇒ sorted
        kms = routed_gather(mesh, sg.kmers, gids, sg.T, "region_table")
        return torch.as_tensor(kms, device=dev), torch.as_tensor(gids, device=dev)

    use_region_join = sg.n_nodes >= _condense_threshold()

    reads = None
    if checkpoint_dir and cycles_ck and os.path.exists(_ck("reads.json")):
        reads = ckpt.load_reads(_ck("reads.json"))
        if verbose:
            print(f"Reads loaded from checkpoint: {len(reads)}")
    if reads is None:
        with prof.stage("read_mapping"):
            reads = sharded_get_reads(
                sg, f1, f2, result.cycles, sources=map_sources,
                region_provider=_region_provider if use_region_join else None,
            )
        if checkpoint_dir:
            if mesh.proc == 0:
                ckpt.save_reads(_ck("reads.json"), reads)
            barrier(mesh)
    prof.count("read_mapping", reads=len(reads))
    if map_sources:
        for src in map_sources:
            src.release()
    result.reads = reads
    if verbose:
        print(f"    ▸ Found {len(reads)} reads")
        print("🔸STEP 7: Order the spacers")

    read_chain_len = len(reads[0]) if len(reads) else 0
    region_mask = None
    if len(reads) and region_state.get("read_chain_len") == read_chain_len:
        region_mask = region_state.get("mask")
    with prof.stage("spacer_ordering"):
        region, cycles_c, reads_c = condense_region(
            sg, valid, result.cycles, reads, read_chain_len, region_mask=region_mask,
        )
        # the validity epoch ends here: nothing below reads the sharded
        # graph, so the tagged adjacency (two more adjacency-sized tensors
        # per shard) is freed instead of living as long as the graph
        release_tags(sg)
        graph, found_systems = spacer_ordering_step(region, reads_c, cycles_c, verbose)
    prof.count("spacer_ordering", systems=len(found_systems))
    result.graph = graph
    result.found_systems = found_systems

    if settings.benchmark_file:
        if verbose:
            print("🔸STEP 8: Compare to ground of truth using benchmark file")
        if write_report:
            benchmark_results(settings, found_systems)
    elif verbose:
        print("🔸STEP 8: Results")
        print_results(found_systems)

    all_systems: dict[str, list[str]] = {}
    for fs in found_systems:
        all_systems[fs.repeat] = fs.spacers
    out_path = (settings.output_file or "CRISPR_Arrays.txt") if write_report else os.devnull
    analyzer = CRISPRAnalyzer(all_systems, out_path, device=dev)
    with prof.stage("report"):
        result.report_text = analyzer.run_analysis()
    result.profile = prof
    if verbose:
        print(f"Saved in: {analyzer.output_path}")
        print("Stage timings:")
        print(prof.report())
        print(f"Downstream time: {prof.elapsed() - t0:.2f}s")
    return result


# ---------------------------------------------------------------------------
# Build (no compaction)
# ---------------------------------------------------------------------------


def build_sharded_graph_for_pipeline(codes, lengths, settings, device=None,
                                     verbose: bool = False) -> ShardedDBG:
    """Distributed build retained as a ShardedDBG (no single-device
    compaction) on the default mesh of ``device``. The reverse-complement
    strand is bit math inside the build (no RC code matrix); the id
    stride is node-proportional (counted live rows)."""
    mesh = make_pipeline_mesh(default_devices(device))
    return build_sharded_dbg(
        mesh, np.asarray(codes), np.asarray(lengths), k=23,
        add_rc=settings.add_reverse_complement, verbose=verbose,
    )
