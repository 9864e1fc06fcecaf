"""Pairs a sample that the report's host route scored (the program's
``host_route_pairs`` counter): one a ``ratio`` or ``partial_ratio`` call."""

from benchmark.spans import counter, hook, per_sample  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: counter(recs, "host_route_pairs", "report"))
