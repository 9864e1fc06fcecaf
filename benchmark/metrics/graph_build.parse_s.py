"""Seconds a sample of the program's ``graph_build/parse`` span: the native
FASTQ parse and encode of every input file (``pipeline._load_input_batches``)."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: span_s(recs, "graph_build/parse"))
