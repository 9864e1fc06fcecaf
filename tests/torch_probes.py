"""Counters around one pipeline run of the torch port, and the rules
that hold a report to its planted truth, for the chip runs
(``chip_smoke.py``, ``scripts/torch_e2e_big.py``) and their CPU tests.
Nothing in the package is changed: each probe wraps a module attribute
for the length of a ``with`` block and puts it back.

``probe_pipeline()`` yields a dict that fills as the run goes:

- ``adjacency_chunks``: calls of ``graph/dbg.py::_adjacency_scatter_chunk``
  (more than one when the edge table passes ``ADJ_SINGLE_SHOT_MAX_EDGES``);
- ``count_parts``: row parts counted (``kmer/count.py::_count_edge_part``);
- ``unique_edges``: unique (k+1)-mers the single-device build counted
  (the rows the merge stack and the adjacency carry);
- ``rc_s`` and ``rc_reads``: seconds and reads of
  ``io/fastq.py::reverse_complement_batch`` (mate 2 of a paired run);
- ``ordering_pool_s``, ``subproblems`` and ``cycles_per_subproblem``:
  ``pipeline.py::_solve_subproblems``, the forked ordering pool;
- ``batched``: the report's calls that take the batched route, by the
  kernel each launches on a card: ``partial_ratio`` for
  ``CRISPRAnalyzer.filter_substring_spacers`` and ``ratio_matrix`` for
  ``validate_spacer_diversity``, each given more than ``BATCH_THRESHOLD``
  strings of at most 64 bases (a system the substring or length filter
  then cuts to 24 or fewer spacers launches the first and not the
  second).

``probe_sharded_count(device)`` yields the sharded build's count budget
(``parallel/sharded_graph.py``):

- ``rows``: the rows of each shard's count input of each row part
  (``count_unique``), the unit of ``SHARDED_COUNT_SHARD_ROWS``;
- ``peaks``: on a card, the allocated peak above the block's start of
  the count parts (read at the first drain of the merge stack), the node
  table (read as the adjacency starts), the adjacency and what follows;
  each reading starts a fresh peak.

The truth rules: :func:`spacer_recovery` (``bench.py``'s core rule),
:func:`arrays_found` (the exact repeat on error-free reads, a shared
23-mer on error-bearing ones, less for a repeat under 25 bases) and
:func:`reported_repeats`.
"""

from __future__ import annotations

import contextlib
import time

K = 23


@contextlib.contextmanager
def _wrapped(module, name: str, after):
    """Replace ``module.name`` by a call that runs it and then
    ``after(args, result, seconds)``."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        after(args, out, time.perf_counter() - t0)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def probe_pipeline():
    from mcaat_tpu_torch import pipeline
    from mcaat_tpu_torch.graph import dbg
    from mcaat_tpu_torch.io import fastq
    from mcaat_tpu_torch.kmer import count as kcount
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer

    got = {"adjacency_chunks": 0, "count_parts": 0, "unique_edges": 0, "rc_s": 0.0,
           "rc_reads": 0, "ordering_pool_s": 0.0, "subproblems": 0,
           "cycles_per_subproblem": [], "batched": {"partial_ratio": 0, "ratio_matrix": 0}}

    def batched(kernel):
        def after(a, _out, _s):
            analyzer, strings = a
            if len(strings) > analyzer.BATCH_THRESHOLD and all(len(x) <= 64 for x in strings):
                got["batched"][kernel] += 1

        return after

    def chunk(_a, _out, _s):
        got["adjacency_chunks"] += 1

    def part(_a, _out, _s):
        got["count_parts"] += 1

    def edges(_a, out, _s):
        got["unique_edges"] += int(out[0].shape[0])

    def rc(a, out, s):
        got["rc_s"] += s
        got["rc_reads"] += out.num_reads

    def pool(a, _out, s):
        got["ordering_pool_s"] += s
        got["subproblems"] += len(a[1])
        got["cycles_per_subproblem"] += [len(rc_) for _sg, _rr, rc_ in a[1]]

    with contextlib.ExitStack() as stack:
        stack.enter_context(_wrapped(dbg, "_adjacency_scatter_chunk", chunk))
        stack.enter_context(_wrapped(kcount, "_count_edge_part", part))
        stack.enter_context(_wrapped(dbg, "count_edges_parts", edges))
        stack.enter_context(_wrapped(fastq, "reverse_complement_batch", rc))
        stack.enter_context(_wrapped(pipeline, "_solve_subproblems", pool))
        stack.enter_context(_wrapped(CRISPRAnalyzer, "filter_substring_spacers",
                                     batched("partial_ratio")))
        stack.enter_context(_wrapped(CRISPRAnalyzer, "validate_spacer_diversity",
                                     batched("ratio_matrix")))
        yield got


@contextlib.contextmanager
def probe_sharded_count(device=None):
    import torch

    from mcaat_tpu_torch.parallel import sharded_graph

    cuda = device is not None and torch.device(device).type == "cuda"
    got = {"rows": [], "peaks": {}}
    peaks = got["peaks"]
    base = 0

    def mark(name: str) -> None:  # the peak since the last mark, then a fresh one
        if cuda:
            torch.cuda.synchronize(device)
            peaks[name] = torch.cuda.max_memory_allocated(device) - base
            torch.cuda.reset_peak_memory_stats(device)

    count_unique = sharded_graph.count_unique
    drain = sharded_graph._merge_stack_drain
    adjacency = sharded_graph._sharded_adjacency

    def count(x):  # one shard's count input of one row part
        got["rows"].append(int(x.numel()))
        return count_unique(x)

    def drained(*a):
        if "count" not in peaks:
            mark("count")
        return drain(*a)

    def adjacent(*a):
        mark("nodes")
        out = adjacency(*a)
        mark("adjacency")
        return out

    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    sharded_graph.count_unique, sharded_graph._merge_stack_drain = count, drained
    sharded_graph._sharded_adjacency = adjacent
    try:
        yield got
    finally:
        sharded_graph.count_unique, sharded_graph._merge_stack_drain = count_unique, drain
        sharded_graph._sharded_adjacency = adjacency
    mark("rest")


def _rc(seq: str) -> str:
    from mcaat_tpu_torch.io.fastq import reverse_complement

    return reverse_complement(seq)


def spacer_recovery(arrays: list, report: str) -> tuple[int, int]:
    """``bench.py``'s rule: planted spacers whose core ``sp[6:-6]`` is in
    the report on either strand; ``(found, planted)``."""
    spacers = [s for a in arrays for s in a["spacers"]]
    found = sum(1 for s in spacers if s[6:-6] in report or _rc(s[6:-6]) in report)
    return found, len(spacers)


def reported_repeats(report: str) -> list:
    """The repeat of every system of a ``CRISPR_Arrays.txt``: the line
    between the two dashed lines that open the system."""
    lines = report.splitlines()
    dash = "-" * 50
    return [
        lines[i] for i in range(1, len(lines) - 1)
        if lines[i - 1] == dash and lines[i + 1] == dash and lines[i]
        and set(lines[i]) <= set("ACGT")
    ]


def arrays_found(arrays: list, report: str, errors: bool) -> int:
    """Planted arrays with a system: on error-free reads the repeat less
    its last base is in the report (a reference quirk); on error-bearing
    reads a reported repeat shares a 23-mer with it, either strand (the
    reference may move a repeat's ends a base or two). A repeat of fewer
    than 25 bases need share only its length less two: the quirk alone
    leaves a 23-base repeat no 23-mer of its own."""
    if not errors:
        return sum(1 for a in arrays
                   if a["repeat"][:-1] in report or _rc(a["repeat"])[:-1] in report)
    reported = reported_repeats(report)
    kmers: dict = {}

    def shared(repeat: str) -> bool:
        k = min(K, len(repeat) - 2)
        if k not in kmers:
            kmers[k] = {r[i : i + k] for r in reported for i in range(len(r) - k + 1)}
        return any(repeat[i : i + k] in kmers[k] or _rc(repeat)[i : i + k] in kmers[k]
                   for i in range(len(repeat) - k + 1))

    return sum(1 for a in arrays if shared(a["repeat"]))
