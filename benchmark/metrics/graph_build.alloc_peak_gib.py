"""The largest device peak (``max_memory_allocated``) of any stage of any
sample, in GiB: the graph build's window sort."""

from benchmark.stages import peak_stage


def read(run):
    s = peak_stage(run)
    return None if s is None else s["device_peak_mb"] / 1024
