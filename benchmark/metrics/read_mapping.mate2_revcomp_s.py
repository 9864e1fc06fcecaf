"""Seconds a sample of the program's ``read_mapping/mate2_revcomp`` span: mate
2's rows reverse-complemented on the host (``io.fastq.reverse_complement_batch``)."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: span_s(recs, "read_mapping/mate2_revcomp"))
