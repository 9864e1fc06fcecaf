"""Passes a sample of the graph build's chunked adjacency: the program's
``adjacency_chunk`` spans (under ``graph_build/build/adjacency``, one a
chunk of the edge table), counted. None where the program has no such
span."""

from benchmark.spans import hook, per_sample  # noqa: F401

NAME = "graph_build/build/adjacency/adjacency_chunk"


def read(run):
    if not any(r["name"] == NAME for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: sum(r["name"] == NAME for r in recs))
