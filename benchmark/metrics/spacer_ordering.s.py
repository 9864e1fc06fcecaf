"""Seconds of the program's ``spacer_ordering`` stage a sample, over the window."""

from benchmark.stages import mean_stage_s


def read(run):
    return mean_stage_s(run, "spacer_ordering")
