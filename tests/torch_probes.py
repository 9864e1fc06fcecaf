"""Counters around one pipeline run of the torch port, for the chip
runs (``chip_smoke.py``, ``scripts/torch_e2e_big.py``) and their CPU
tests. Nothing in the package is changed: each probe wraps a module
attribute for the length of a ``with`` block and puts it back.

``probe_pipeline()`` yields a dict that fills as the run goes:

- ``adjacency_chunks``: calls of ``graph/dbg.py::_adjacency_scatter_chunk``
  (more than one when the edge table passes ``ADJ_SINGLE_SHOT_MAX_EDGES``);
- ``count_parts``: row parts counted (``kmer/count.py::_count_edge_part``);
- ``unique_edges``: unique (k+1)-mers the single-device build counted
  (the rows the merge stack and the adjacency carry);
- ``rc_s`` and ``rc_reads``: seconds and reads of
  ``io/fastq.py::reverse_complement_batch`` (mate 2 of a paired run);
- ``ordering_pool_s``, ``subproblems`` and ``cycles_per_subproblem``:
  ``pipeline.py::_solve_subproblems``, the forked ordering pool.
"""

from __future__ import annotations

import contextlib
import time


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

    got = {"adjacency_chunks": 0, "count_parts": 0, "unique_edges": 0, "rc_s": 0.0,
           "rc_reads": 0, "ordering_pool_s": 0.0, "subproblems": 0,
           "cycles_per_subproblem": []}

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
        yield got
