"""Seconds a sample of the program's ``adjacency_chunk`` spans (under
``graph_build/build/adjacency``, one a pass of the chunked adjacency: a
chunk of the edge table joined against the node table and scattered),
summed over the chunks. None where the program has no such span."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401

NAME = "graph_build/build/adjacency/adjacency_chunk"


def read(run):
    if not any(r["name"] == NAME for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: span_s(recs, NAME))
