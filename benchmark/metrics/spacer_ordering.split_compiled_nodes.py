"""Nodes a sample that the SCC split of spacer_ordering placed in a
subgraph in the program's compiled code (the program's
``split_compiled_nodes`` counter, in span ``region_split/scc_split``: the
nodes of the components of more than one node that ``native/split.cpp``
labelled; 0 where the split took its Python route). None where the
program has no such counter."""

from benchmark.spans import counter, hook, per_sample  # noqa: F401

NAME = "split_compiled_nodes"


def read(run):
    if not any(NAME in r["counters"] for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: counter(recs, NAME, "spacer_ordering"))
