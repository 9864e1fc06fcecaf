"""End-to-end pipeline orchestration (torch, one device).

Port of ``mcaat_tpu/pipeline.py::run_pipeline``, the analog of the
reference's release ``main()`` (``src/main.cpp:496-591``): graph build →
cycle finding → read mapping → spacer ordering → systems → report. The
device stages run on torch tensors on ``device``; this file is control
flow only.

With a ``checkpoint_dir`` every stage boundary is saved
(``checkpoint.py``) and completed stages are skipped on rerun.
:func:`run_debug_pipeline` is the reference's DEBUG-main extension.

Not ported yet, and refused with ``NotImplementedError`` naming its
ROADMAP.md item: the multi-device path (more than one visible card with
``--mesh auto``).
"""

from __future__ import annotations

import sys
import time
import zipfile
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from mcaat_tpu_torch import resolve_device
from mcaat_tpu_torch.cycles.finder import cycles_map_to_cycles, find_cycles
from mcaat_tpu_torch.evaluation import (
    get_most_similar_sequence,
    get_number_of_duplicate_spacers,
    get_string_similarity,
)
from mcaat_tpu_torch.graph import dbg as _dbg
from mcaat_tpu_torch.graph.dbg import DBG, build_dbg_from_reads
from mcaat_tpu_torch.ordering.ordering import (
    filter_subproblems,
    get_crispr_regions_extended_by_k,
    get_ordered_cycles,
)
from mcaat_tpu_torch.reads.mapper import get_reads
from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer
from mcaat_tpu_torch.settings import Settings
from mcaat_tpu_torch.systems.extract import get_systems
from mcaat_tpu_torch.utils.profiling import Profiler, tick_printer


@dataclass
class FoundSystem:
    """≙ the reference's found_systems tuple (main_run_and_debug.cpp:123-129)."""

    full_sequence: str
    repeat: str
    spacers: list[str]
    confidence_cycle_resolution: float
    confidence_topological_sort: float


@dataclass
class PipelineResult:
    graph: DBG | None = None
    cycles_map: dict[int, list[list[int]]] = field(default_factory=dict)
    cycles: list[list[int]] = field(default_factory=list)
    reads: list[list[int]] = field(default_factory=list)
    found_systems: list[FoundSystem] = field(default_factory=list)
    report_text: str = ""
    profile: Profiler | None = None


def _load_input_batches(settings: Settings) -> list:
    """Parse the input files: ``[(path, ReadBatch)]``, one entry per
    listed file (a path listed twice contributes its reads twice, like
    the reference's per-file loop, src/tmp_utils.cpp:8-24); each distinct
    path is parsed once."""
    from mcaat_tpu_torch.io.fastq import read_encoded_batch

    cache: dict = {}
    entries = []
    for path in settings.input_file_list():
        if path not in cache:
            cache[path] = read_encoded_batch(path)
        entries.append((path, cache[path]))
    return entries


def _concat_batches(entries: list) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-file batches into one padded 2-bit code matrix."""
    batches = [b for _, b in entries if b.num_reads]
    if not batches:
        raise RuntimeError("No sequences found in input files")
    max_len = max(b.max_len for b in batches)
    codes = np.zeros((sum(b.num_reads for b in batches), max_len), dtype=np.uint8)
    lengths = np.zeros(codes.shape[0], dtype=np.int32)
    row = 0
    for b in batches:
        codes[row : row + b.num_reads, : b.max_len] = b.codes
        lengths[row : row + b.num_reads] = b.lengths
        row += b.num_reads
    return codes, lengths


def _check_single_device(settings: Settings, device: torch.device) -> None:
    if device.type == "cuda" and settings.mesh != "off" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} visible CUDA devices with --mesh "
            f"{settings.mesh}: the multi-device path is not ported yet "
            "(ROADMAP.md queue 1: the parallel/ path on torch.distributed); "
            "run with --mesh off or one visible device"
        )


# the device memory, in GB, that graph/dbg.py's build budgets were sized
# for; --ram scales the window budget against it
BUDGET_CARD_GB = 80.0


def build_graph_from_settings(
    settings: Settings,
    verbose: bool = False,
    batches: list | None = None,
    endpoints_out: dict | None = None,
    device: str | torch.device | None = None,
) -> DBG:
    """STEP: graph build (≙ SDBGBuild, src/sdbg_build.cpp), in one pass
    or in row parts above the window budget.

    ``batches`` reuses already-parsed per-file ReadBatches.
    ``endpoints_out`` is filled with the device-resident per-read
    endpoint k-mers keyed by file (``{path: (first_km, last_km)}``, first
    occurrence wins for a duplicated path) for the mapper's keep
    predicate.
    """
    dev = resolve_device(device)
    if batches is None:
        batches = _load_input_batches(settings)
    codes, lengths = _concat_batches(batches)
    # --ram scales the single-pass window budget (sized for an 80 GB
    # card) down in proportion, to a floor of 2M windows
    chunk_windows = _dbg.SINGLE_PASS_MAX_WINDOWS
    if settings.ram_explicit and settings.ram and settings.ram < BUDGET_CARD_GB:
        chunk_windows = max(int(chunk_windows * settings.ram / BUDGET_CARD_GB), 2_000_000)
    eps_rows = {} if endpoints_out is not None else None
    graph = build_dbg_from_reads(
        codes,
        lengths,
        k=23,
        add_reverse_complement=settings.add_reverse_complement,
        chunk_windows=chunk_windows,
        verbose=verbose,
        endpoints_out=eps_rows,
        device=dev,
    )
    if endpoints_out is not None and eps_rows:
        # split the concatenated-row endpoint tensors back per input file
        off = 0
        for path, b in batches:
            if not b.num_reads:
                continue
            endpoints_out.setdefault(
                path,
                (
                    eps_rows["first_km"][off : off + b.num_reads],
                    eps_rows["last_km"][off : off + b.num_reads],
                ),
            )
            off += b.num_reads
    return graph


# Above this node count the ordering stage condenses the read_len-hop
# cycle region first, which is also where the deferred tip clip of the
# cycle stage is completed. None means "track finder.LAZY_CLIP_MIN_NODES
# at call time", so a runtime override of the finder threshold keeps the
# two coupled.
REGION_CONDENSE_MIN_NODES: int | None = None


def _condense_threshold() -> int:
    from mcaat_tpu_torch.cycles import finder as _finder

    if REGION_CONDENSE_MIN_NODES is not None:
        return REGION_CONDENSE_MIN_NODES
    return _finder.LAZY_CLIP_MIN_NODES


def spacer_ordering_step(
    graph: DBG,
    reads,
    cycles: list[list[int]],
    verbose: bool = True,
    condense_min_nodes: int | None = None,
    region_mask: np.ndarray | None = None,
) -> tuple[DBG, list[FoundSystem]]:
    """STEP 7 (≙ run_and_debug_spacer_ordering, main_run_and_debug.cpp:32-140).

    ``region_mask``: a precomputed ``undirected_region_mask(graph, cycle
    seeds, len(reads[0]))`` from the region-first mapper, reused so the
    condense path skips the second growth."""
    from mcaat_tpu_torch.cycles import finder as _finder
    from mcaat_tpu_torch.prune.prune import clip_tips

    if condense_min_nodes is None:
        condense_min_nodes = _condense_threshold()
    found_systems: list[FoundSystem] = []
    if not len(reads):
        return graph, found_systems
    read_chain_len = len(reads[0])
    _tick = tick_printer("ordering", verbose, graph.device)

    if graph.size >= condense_min_nodes:
        from mcaat_tpu_torch.cycles.neighborhood import (
            extract_region_graph,
            remap_chains,
            undirected_region_mask,
        )

        seeds = np.asarray(sorted({n for c in cycles for n in c}), dtype=np.int64)
        _tick("cycle-node seed set")
        if region_mask is not None:
            mask = region_mask
        else:
            mask = undirected_region_mask(graph, seeds, read_chain_len, verbose=verbose)
        _tick("region mask growth")
        graph, gids = extract_region_graph(graph, mask)
        _tick("region extract")
        cycles, reads = remap_chains(gids, cycles, reads)
        _tick("chain remap")
        if verbose:
            print(f"  ▸ Region condensed to {len(gids)} nodes for the ordering stages")
        # lazy-clip completion: clip the condensed region so the growth and
        # SCC split below see post-clip validity. Output-preserving; the
        # proof is at mcaat_tpu/pipeline.py::spacer_ordering_step.
        graph, _ = clip_tips(graph)
        _tick("region condense")
    elif graph.size >= _finder.LAZY_CLIP_MIN_NODES:
        # a caller raised condense_min_nodes above the lazy-clip threshold:
        # complete the deferred clip globally
        graph, _ = clip_tips(graph)
        _tick("global clip (condense skipped)")

    if verbose:
        print("  ▸ Splitting into subproblems")
    graph, subgraphs = get_crispr_regions_extended_by_k(
        graph, read_chain_len, cycles, verbose=verbose
    )
    _tick("region split (SCC)")

    if verbose:
        print("  🔄 Filtering subproblems:")
    remaining = filter_subproblems(graph.size, subgraphs, reads, cycles)
    if verbose:
        print(
            f"  ✅ Filtered out {len(subgraphs) - len(remaining)}/"
            f"{len(subgraphs)} subproblems"
        )
        print(f"  🔄 Solving {len(remaining)} subproblems...")
    _tick("subproblem filter")

    results = _solve_subproblems(graph.to_host(), remaining)
    for idx, cycle_order, conf_res, conf_topo, system, log_text in results:
        sg, relevant_reads, relevant_cycles = remaining[idx]
        if verbose:
            print(f"    Subproblem {idx + 1}/{len(remaining)}:")
            print(f"      🛈 Graph with {len(sg.nodes)} nodes and {sg.edge_count()} edges")
            print(f"      🛈 Reads with {len(relevant_reads)}/{len(reads)} used")
            print(f"      🛈 Cycles with {len(relevant_cycles)} used")
            sys.stdout.write(log_text)
            print(f"      ▸ The order is {' '.join(map(str, cycle_order))}")
            print(f"      ▸ Cycles were resolved with a confidence of {conf_res * 100:.2f}%")
            print(f"      ▸ Topological sort has a confidence of {conf_topo * 100:.2f}%")
        if system is None:
            if verbose:
                print("      ▸ Node order is too short and is not processed further")
            continue
        repeat, spacers, full_sequence = system
        if verbose:
            print(f"        ▸ Number of spacers: {len(spacers)}")
        found_systems.append(FoundSystem(full_sequence, repeat, spacers, conf_res, conf_topo))
    if verbose:
        print("  ✅ Completed each subproblem")
    _tick("subproblem solve")
    return graph, found_systems


# host graph shared with ordering workers through fork copy-on-write. It
# is numpy only: a forked child must never touch CUDA.
_ORDERING_GRAPH = None

# --threads: worker-count ceiling for the ordering pool (and the native
# OpenMP team, via native.set_threads). None = unset (cpu_count).
_ORDERING_THREADS: int | None = None

# parallelize only past this subproblem count: below it the fork +
# dispatch overhead exceeds the loop itself
_ORDERING_POOL_MIN_SUBPROBLEMS = 8


def configure_threads(n: int) -> None:
    """Wire ``settings.threads`` into the ordering pool (which
    ``MCAAT_ORDERING_PROCS`` still overrides) and the native library's
    OpenMP team (≙ omp_set_num_threads, src/main.cpp:292-294)."""
    global _ORDERING_THREADS
    _ORDERING_THREADS = int(n) if n and n > 0 else None
    if _ORDERING_THREADS is not None:
        from mcaat_tpu_torch import native as _native

        _native.set_threads(_ORDERING_THREADS)


def _ordering_worker_count() -> int:
    """Ordering-pool size: env override > --threads > cpu_count."""
    import os

    return int(
        os.environ.get("MCAAT_ORDERING_PROCS", str(_ORDERING_THREADS or os.cpu_count() or 1))
    )


def _solve_ordering_subproblem(args):
    """One ordering subproblem, pool-safe (numpy and Python only): returns
    everything the parent needs to print the serial verbose block and
    build the FoundSystem."""
    import contextlib
    import io

    from mcaat_tpu_torch.ordering.fast import order_cycles_fast

    idx, relevant_reads, relevant_cycles = args
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cycle_order, conf_res, conf_topo = order_cycles_fast(
            relevant_reads, relevant_cycles, verbose=True
        )
    ordered_cycles = get_ordered_cycles(cycle_order, relevant_cycles)
    system = None
    if len(ordered_cycles) >= 2:
        system = get_systems(_ORDERING_GRAPH, ordered_cycles)
    return idx, cycle_order, conf_res, conf_topo, system, buf.getvalue()


def _solve_subproblems(host_graph, remaining):
    """Solve the independent ordering subproblems, in a forked process
    pool when there are enough of them (≙ the reference's per-subproblem
    OpenMP parallelism, src/main_run_and_debug.cpp:32-140). Results come
    back in subproblem order, so output is identical to the serial loop.
    ``MCAAT_ORDERING_PROCS`` overrides the worker count (0/1: serial). A
    pool failure is logged, then the serial loop runs."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    global _ORDERING_GRAPH
    tasks = [(i, rr, rc) for i, (_sg, rr, rc) in enumerate(remaining)]
    n_procs = _ordering_worker_count()
    _ORDERING_GRAPH = host_graph
    try:
        if n_procs > 1 and len(tasks) >= _ORDERING_POOL_MIN_SUBPROBLEMS:
            ctx = multiprocessing.get_context("fork")
            ex = ProcessPoolExecutor(max_workers=n_procs, mp_context=ctx)
            try:
                futures = [ex.submit(_solve_ordering_subproblem, t) for t in tasks]
                timeout = max(600.0, 5.0 * len(tasks))
                results = [f.result(timeout=timeout) for f in futures]
                ex.shutdown(wait=True)
                return results
            except Exception as e:
                ex.shutdown(wait=False, cancel_futures=True)
                print(
                    f"Warning: ordering pool failed ({type(e).__name__}: {e}); "
                    "solving the subproblems serially",
                    file=sys.stderr,
                )
        return [_solve_ordering_subproblem(t) for t in tasks]
    finally:
        _ORDERING_GRAPH = None


def benchmark_results(settings: Settings, found_systems: list[FoundSystem]) -> None:
    """STEP 8, benchmark mode (≙ main_run_and_debug.cpp:142-212)."""
    benchmark_sequences = []
    try:
        with open(settings.benchmark_file) as fh:
            benchmark_sequences = [line.strip() for line in fh if line.strip()]
        print(f"Loaded {len(benchmark_sequences)} benchmark sequences.")
    except OSError:
        print(f"Error: Could not open benchmark file: {settings.benchmark_file}")

    print(
        f"  ▸ {len(found_systems)} crispr sequences are found and benchmarked "
        f"using {len(benchmark_sequences)} sequences"
    )
    no_match = 0
    avg_sim = 0.0
    for fs in found_systems:
        expected = get_most_similar_sequence(fs.full_sequence, benchmark_sequences)
        if expected == "":
            print(f"    ▸ No expected match for sequence: {fs.full_sequence}")
            no_match += 1
            continue
        sim = get_string_similarity(fs.full_sequence, expected)
        dups = get_number_of_duplicate_spacers(fs.spacers, expected)
        print(
            f"    ▸ ≥{sim * 100:.2f}% sequence similarity, with "
            f"{len(fs.spacers)} spacers, {dups} duplicate spacers, "
            f"confidence of cycle resolution: "
            f"{fs.confidence_cycle_resolution * 100:.2f}%, confidence of "
            f"topological sort: {fs.confidence_topological_sort * 100:.2f}%, "
            f"and the repeat: {fs.repeat}, and sequence: {fs.full_sequence}"
        )
        avg_sim += sim
    denom = len(found_systems) - no_match
    if denom > 0:
        avg_sim /= denom
    print(
        f"  ▸ The average sequence similarity is {avg_sim * 100:.2f}% with "
        f"{no_match}/{len(found_systems)} ignored"
    )


def print_results(found_systems: list[FoundSystem]) -> None:
    """STEP 8, confidence-graded summary (≙ main_run_and_debug.cpp:214-258)."""
    counts = {"🔴": 0, "🟠": 0, "🟡": 0, "🟢": 0}
    for fs in found_systems:
        if (
            len(fs.repeat) <= 23
            or fs.confidence_cycle_resolution < 0.5
            or fs.confidence_topological_sort < 0.5
        ):
            grade = "🔴"
        elif fs.confidence_cycle_resolution < 0.75 or fs.confidence_topological_sort < 0.75:
            grade = "🟠"
        elif fs.confidence_cycle_resolution < 0.85 or fs.confidence_topological_sort < 0.85:
            grade = "🟡"
        else:
            grade = "🟢"
        counts[grade] += 1
        print(f"  {grade} repeat: {fs.repeat}, sequence: {fs.full_sequence}")
    total = sum(counts.values())
    print(
        f"  ▸ {len(found_systems)} CRISPR Arrays were found with "
        f"🔴 ({counts['🔴']}/{total}), 🟠 ({counts['🟠']}/{total}), "
        f"🟡 ({counts['🟡']}/{total}), 🟢 ({counts['🟢']}/{total})"
    )


def multiplicity_histogram(graph: DBG) -> list[tuple[int, int]]:
    """``[(multiplicity, node count)]`` over the valid nodes, ascending
    (computed on the graph's device)."""
    values, counts = torch.unique(graph.mult[graph.valid], sorted=True, return_counts=True)
    return list(zip(values.tolist(), counts.tolist()))


def run_debug_pipeline(
    settings: Settings,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> PipelineResult:
    """The reference's DEBUG-main extension (src/main.cpp:358-493):
    node-multiplicity histogram → cycles → Filters → CRISPRAnalyzer →
    protospacer isolation → phage curation. Writes
    ``node_multiplicities.txt``, ``grouped_paths_protospacers.txt`` and
    ``QualityPaths_BeamWidth50.fasta`` into the output folder beside the
    report. ``result.profile`` holds each stage's seconds."""
    import os

    from mcaat_tpu_torch.phage import PhageCurator
    from mcaat_tpu_torch.protospacers import IsolateProtospacers, create_repeat_to_spacer_nodes
    from mcaat_tpu_torch.systems.filters import Filters

    dev = resolve_device(device)
    _check_single_device(settings, dev)
    configure_threads(settings.threads)
    prof = Profiler(dev)
    result = PipelineResult(profile=prof)
    out_dir = settings.output_folder or "."

    with prof.stage("graph_build"):
        graph = build_graph_from_settings(settings, device=dev)
    prof.count("graph_build", nodes=graph.size)

    # ≙ DEBUG main's node-multiplicity histogram dump (src/main.cpp:497-510)
    with prof.stage("histogram"):
        hist = multiplicity_histogram(graph)
        with open(os.path.join(out_dir, "node_multiplicities.txt"), "w") as fh:
            for m, c in hist:
                fh.write(f"Multiplicity {m}: {c} nodes\n")
    if verbose:
        print("Node Multiplicity Distribution:")

    cfs = settings.cycle_finder_settings
    # full_prune: the stages below consume whole-graph validity, so the
    # tip clip cannot be deferred to the candidate neighbourhood here
    with prof.stage("cycle_search"):
        graph, cycles_map = find_cycles(
            graph,
            threshold_multiplicity=cfs.threshold_multiplicity,
            cycle_min_length=cfs.cycle_min_length,
            cycle_max_length=cfs.cycle_max_length,
            verbose=verbose,
            full_prune=True,
        )
        host = graph.to_host()
    prof.count("cycle_search", start_nodes=len(cycles_map))
    result.graph = graph
    result.cycles_map = cycles_map

    with prof.stage("filters"):
        if verbose:
            print("FILTERS START:")
        systems, n_spacers = Filters(host, cycles_map).list_arrays()
    if verbose:
        print(f"Number of spacers: {n_spacers} before cleaning")
        print("POST PROCESSING START:")
    analyzer = CRISPRAnalyzer(
        systems, settings.output_file or "CRISPR_Arrays.txt", device=dev
    )
    with prof.stage("report"):
        result.report_text = analyzer.run_analysis()
    if verbose:
        print(f"Saved in: {analyzer.output_path}")

    with prof.stage("protospacers"):
        repeat_to_spacer_nodes = create_repeat_to_spacer_nodes(host, analyzer.get_systems())
        if verbose:
            print(
                f"Created repeat_to_spacer_nodes map with "
                f"{len(repeat_to_spacer_nodes)} entries."
            )
        isolator = IsolateProtospacers.from_repeat_to_spacer_nodes(host, repeat_to_spacer_nodes)
        in_map, out_map = isolator.get_protospacer_nodes()
        grouped = isolator.depth_limited_paths_from_in_to_out(in_map, out_map, 50, 1)
        isolator.write_paths_to_file(
            grouped, os.path.join(out_dir, "grouped_paths_protospacers.txt")
        )

    with prof.stage("phage"):
        curator = PhageCurator(graph=host, grouped_paths=grouped, cycles=cycles_map)
        curator.find_quality_paths_beam_search(
            3000, 3010, os.path.join(out_dir, "QualityPaths_BeamWidth50.fasta"), 50
        )
    if verbose:
        print("Stage timings:")
        print(prof.report())
    return result


def run_pipeline(
    settings: Settings,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    device: str | torch.device | None = None,
) -> PipelineResult:
    """Full release pipeline on one device (≙ src/main.cpp:496-591).

    ``device`` defaults to ``MCAAT_TORCH_DEVICE`` or ``cuda`` and raises
    when CUDA is asked for and missing (see :func:`resolve_device`).

    With ``checkpoint_dir`` every stage boundary is saved (``graph.npz``;
    ``graph_pruned.npz`` with ``cycles.json``; ``reads.json``) and the
    stages whose artifacts exist are skipped on rerun. When the graph
    came from a checkpoint, the mapper parses the inputs itself.
    """
    import os

    dev = resolve_device(device)
    _check_single_device(settings, dev)
    configure_threads(settings.threads)

    prof = Profiler(dev)
    result = PipelineResult()
    t0 = time.time()

    ckpt = None
    if checkpoint_dir:
        from mcaat_tpu_torch import checkpoint as ckpt

        os.makedirs(checkpoint_dir, exist_ok=True)

    def _ck_path(name: str) -> str:
        return os.path.join(checkpoint_dir, name)

    def _resume(stage: str, load, *names):
        """``load(*paths)`` of the artifacts ``names``, or None when one is
        missing or unreadable: the stage then runs again."""
        if ckpt is None or not all(os.path.exists(_ck_path(n)) for n in names):
            return None
        try:
            return load(*(_ck_path(n) for n in names))
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile, zlib.error) as e:
            print(f"{stage} checkpoint unreadable ({type(e).__name__}: {e}); recomputing")
            return None

    # a finished cycle stage needs no graph.npz: its pruned graph is the
    # one every later stage reads
    cycles_ck = _resume(
        "Cycles", lambda c, g: (ckpt.load_cycles(c), ckpt.load_graph(g, dev)),
        "cycles.json", "graph_pruned.npz",
    )
    input_batches = None
    input_endpoints: dict = {}
    if cycles_ck is not None:
        cycles_map, graph = cycles_ck
        if verbose:
            print(f"Graph loaded from checkpoint: {graph.size} nodes (graph_pruned.npz)")
    else:
        graph = _resume("Graph", lambda g: ckpt.load_graph(g, dev), "graph.npz")
        if graph is not None:
            if verbose:
                print(f"Graph loaded from checkpoint: {graph.size} nodes")
        else:
            with prof.stage("graph_build"):
                input_batches = _load_input_batches(settings)
                graph = build_graph_from_settings(
                    settings, verbose=verbose, batches=input_batches,
                    endpoints_out=input_endpoints, device=dev,
                )
            prof.count("graph_build", nodes=graph.size)
            if ckpt:
                ckpt.save_graph(_ck_path("graph.npz"), graph)
            if verbose:
                print(f"Graph built: {graph.size} nodes ({time.time() - t0:.2f}s)")
    result.graph = graph

    cfs = settings.cycle_finder_settings
    if cycles_ck is not None:
        if verbose:
            print(f"Cycles loaded from checkpoint: {len(cycles_map)} start nodes")
    else:
        with prof.stage("cycle_search"):
            graph, cycles_map = find_cycles(
                graph,
                threshold_multiplicity=cfs.threshold_multiplicity,
                cycle_min_length=cfs.cycle_min_length,
                cycle_max_length=cfs.cycle_max_length,
                verbose=verbose,
            )
        prof.count("cycle_search", start_nodes=len(cycles_map))
        if ckpt:
            ckpt.save_graph(_ck_path("graph_pruned.npz"), graph)
            ckpt.save_cycles(_ck_path("cycles.json"), cycles_map)
    result.cycles_map = cycles_map
    result.cycles = cycles_map_to_cycles(cycles_map)
    if verbose:
        print(f"Number of nodes in results: {len(cycles_map)}")
        print("🔸STEP 6: Finding relevant reads")

    # region-first mapping: at condense scale the cycle region (the
    # read_len-hop expansion the ordering stage needs anyway) is grown
    # before the chain lookup, and the kept chains join against its node
    # table instead of the full one. The mask is reused by STEP 7.
    region_state: dict = {}

    def _region_provider(read_chain_len: int):
        from mcaat_tpu_torch.cycles.neighborhood import undirected_region_mask

        seeds = np.asarray(sorted({n for c in result.cycles for n in c}), dtype=np.int64)
        mask = undirected_region_mask(graph, seeds, read_chain_len, verbose=verbose)
        region_state["mask"] = mask
        region_state["read_chain_len"] = read_chain_len
        gids = np.nonzero(mask)[0]
        if len(gids) == 0:
            return None
        gids_t = torch.as_tensor(gids, device=dev)
        # gids ascending + kmers sorted ⇒ the gathered table is sorted
        return graph.kmers[gids_t], gids_t

    use_region_join = graph.size >= _condense_threshold()
    reads = _resume("Reads", lambda r: ckpt.load_reads(r), "reads.json")
    if reads is not None:
        if verbose:
            print(f"Reads loaded from checkpoint: {len(reads)}")
    else:
        f1, f2 = settings.fastq_files()
        with prof.stage("read_mapping"):
            # first occurrence wins on a duplicated path; after a graph
            # checkpoint nothing was parsed and the mapper parses itself
            batches_by_path = None
            if input_batches is not None:
                batches_by_path = {}
                for path, b in input_batches:
                    batches_by_path.setdefault(path, b)
            reads = get_reads(
                graph, f1, f2, result.cycles, verbose=verbose,
                batches=batches_by_path, endpoints=input_endpoints or None,
                region_provider=_region_provider if use_region_join else None,
            )
        prof.count("read_mapping", reads=len(reads))
        if ckpt:
            ckpt.save_reads(_ck_path("reads.json"), reads)
    result.reads = reads
    if verbose:
        print(f"    ▸ Found {len(reads)} reads")
        print("🔸STEP 7: Order the spacers")

    region_mask = None
    if len(reads) and region_state.get("read_chain_len") == len(reads[0]):
        region_mask = region_state.get("mask")
    with prof.stage("spacer_ordering"):
        graph, found_systems = spacer_ordering_step(
            graph, reads, result.cycles, verbose, region_mask=region_mask
        )
    prof.count("spacer_ordering", systems=len(found_systems))
    result.graph = graph
    result.found_systems = found_systems

    if settings.benchmark_file:
        if verbose:
            print("🔸STEP 8: Compare to ground of truth using benchmark file")
        benchmark_results(settings, found_systems)
    elif verbose:
        print("🔸STEP 8: Results")
        print_results(found_systems)

    all_systems: dict[str, list[str]] = {}
    for fs in found_systems:
        all_systems[fs.repeat] = fs.spacers
    analyzer = CRISPRAnalyzer(
        all_systems, settings.output_file or "CRISPR_Arrays.txt", device=dev
    )
    with prof.stage("report"):
        result.report_text = analyzer.run_analysis()
    result.profile = prof
    if verbose:
        print(f"Saved in: {analyzer.output_path}")
        print("Stage timings:")
        print(prof.report())
        print(f"Total time: {time.time() - t0:.2f}s")
    return result
