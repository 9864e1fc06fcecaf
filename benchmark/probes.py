"""Hooks around functions of the program, each for the length of a
``with`` block: the program itself is not changed. The idea is that of
``tests/torch_probes.py`` at commit 9d644f4 (wrap a module attribute, put
it back), frozen here with only what the benchmark reads.

- :func:`graph_digests`: after each graph build of a sample, the
  ``table_digest`` of the node table it gave (every run: the comparison
  that decides ``correct`` reads it).
- :func:`stage_spans`: each ``Profiler`` stage inside a
  ``torch.profiler.record_function`` range named ``stage.<name>``, so that
  a trace can say in which stage the device sat idle (traced runs).
- :func:`batched_scores`: the strings and the scores of each call of the
  report's batched route, one launch of one of its two kernels (every
  run: the comparison reads them, and the rooflines count their work).
- :func:`reserved_peak`: the caching allocator's peak of reserved bytes
  over a block, kept across the program's resets of the peak statistics.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _wrapped(owner, name: str, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def graph_digests(out: list):
    """Append ``table_digest(kmers, mult)`` of every graph that
    ``pipeline.build_graph_from_settings`` returns to ``out``."""
    from benchmark.reference import table_digest
    from mcaat_tpu_torch import pipeline

    def wrap(orig):
        def build(*args, **kwargs):
            graph = orig(*args, **kwargs)
            out.append(table_digest(graph.kmers, graph.mult))
            return graph

        return build

    with _wrapped(pipeline, "build_graph_from_settings", wrap):
        yield out


@contextlib.contextmanager
def stage_spans():
    """Every ``Profiler.stage(name)`` block inside ``record_function("stage.<name>")``."""
    import torch

    from mcaat_tpu_torch.utils.profiling import Profiler

    def wrap(orig):
        @contextlib.contextmanager
        def stage(self, name, **counters):
            with torch.profiler.record_function(f"stage.{name}"), \
                    orig(self, name, **counters) as stats:
                yield stats

        return stage

    with _wrapped(Profiler, "stage", wrap):
        yield


@contextlib.contextmanager
def batched_scores(out: list):
    """Append ``("partial_ratio", shorts, longs, scores)`` of every call of
    ``batched_fuzz.partial_ratio_pairs`` and ``("ratio_matrix", strings,
    scores)`` of every call of ``batched_fuzz.pairwise_ratio_matrix`` to
    ``out``: the analyzer's strings and what came back to it."""
    from mcaat_tpu_torch.report import batched_fuzz

    def pairs(orig):
        def call(shorts, longs, device):
            got = orig(shorts, longs, device)
            out.append(("partial_ratio", list(shorts), list(longs), got.copy()))
            return got

        return call

    def matrix(orig):
        def call(strings, device):
            got = orig(strings, device)
            out.append(("ratio_matrix", list(strings), got.copy()))
            return got

        return call

    with _wrapped(batched_fuzz, "partial_ratio_pairs", pairs), \
            _wrapped(batched_fuzz, "pairwise_ratio_matrix", matrix):
        yield out


@contextlib.contextmanager
def reserved_peak(out: dict):
    """``out["bytes"]``: the most bytes the caching allocator reserved on
    the current card from the start of the block to its end. The peak
    statistics are reset at the start, and each reset that the program
    makes inside the block (its ``Profiler`` resets them at every stage)
    first saves the peak it clears."""
    import torch

    def wrap(orig):
        def reset(device=None):
            out["bytes"] = max(out["bytes"], torch.cuda.max_memory_reserved(device))
            return orig(device)

        return reset

    torch.cuda.reset_peak_memory_stats()
    out["bytes"] = 0
    with _wrapped(torch.cuda, "reset_peak_memory_stats", wrap):
        yield out
    out["bytes"] = max(out["bytes"], torch.cuda.max_memory_reserved())
