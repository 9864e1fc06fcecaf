"""The gzip route's rate: the ``gzip_bytes`` counter (the gzipped files'
sizes on disk) of the program's ``graph_build/parse/gzip_parse`` spans
over those spans' seconds, in MiB of compressed input a second, over the
window's samples. None where no record holds the counter."""

from benchmark.spans import hook, span_s  # noqa: F401

NAME = "graph_build/parse/gzip_parse"


def read(run):
    recs = [r for sample in run.probes.get("spans") or [] for r in sample
            if r["name"] == NAME and "gzip_bytes" in r["counters"]]
    seconds = span_s(recs, NAME)
    if not recs or seconds <= 0:
        return None
    return sum(r["counters"]["gzip_bytes"] for r in recs) / 2**20 / seconds
