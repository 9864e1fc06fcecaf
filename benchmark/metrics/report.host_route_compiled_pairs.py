"""Pairs a sample that the report's host route scored in the program's
compiled code (the program's ``host_route_compiled_pairs`` counter: one
a ``ratio`` or ``partial_ratio`` that ``native/fuzz.cpp`` computed; equal
to ``report.host_route_pairs`` where that route takes every system).
None where the program has no such counter."""

from benchmark.spans import counter, hook, per_sample  # noqa: F401

NAME = "host_route_compiled_pairs"


def read(run):
    if not any(NAME in r["counters"] for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: counter(recs, NAME, "report"))
