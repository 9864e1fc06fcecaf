"""Seconds of a sample outside the program's stages: the CLI, the
pipeline's glue, the output folders, the result's printing."""

from benchmark.stages import unstaged_s


def read(run):
    return unstaged_s(run)
