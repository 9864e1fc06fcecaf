"""Levels a sample of the cycles package's device BFS loops that made a
round trip to the host (the program's ``bfs_levels`` counter): the
self-reach probes and the union reach of cycle_search, and the region
growth (``cycles/neighborhood.py``) wherever a stage runs it."""

from benchmark.spans import counter, hook, per_sample  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: counter(recs, "bfs_levels"))
