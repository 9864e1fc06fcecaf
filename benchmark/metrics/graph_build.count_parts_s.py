"""Seconds a sample of the program's ``count_part`` spans (under
``graph_build/build/upload_count``, one a row part of the graph build:
the part's upload and its (k+1)-mer count), summed over the parts. None
where the program has no such span."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401

NAME = "graph_build/build/upload_count/count_part"


def read(run):
    if not any(r["name"] == NAME for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: span_s(recs, NAME))
