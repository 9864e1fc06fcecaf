"""Seconds a sample of the program's ``graph_build/parse/gzip_parse``
spans: the parse of each gzipped input file, its inflate included,
whichever route parses it (``io/fastq.py::read_encoded_batches``). None
where no record holds the span's ``gzip_bytes`` counter."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401

NAME = "graph_build/parse/gzip_parse"


def read(run):
    if not any(r["name"] == NAME and "gzip_bytes" in r["counters"]
               for recs in run.probes.get("spans") or [] for r in recs):
        return None
    return per_sample(run, lambda recs: span_s(recs, NAME))
