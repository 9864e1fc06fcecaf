"""Seconds of the program's ``report`` stage a sample, over the window."""

from benchmark.stages import mean_stage_s


def read(run):
    return mean_stage_s(run, "report")
