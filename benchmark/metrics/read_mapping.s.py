"""Seconds of the program's ``read_mapping`` stage a sample, over the window."""

from benchmark.stages import mean_stage_s


def read(run):
    return mean_stage_s(run, "read_mapping")
