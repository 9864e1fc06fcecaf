"""Seconds a sample costs: the window's length over the samples it finished."""


def read(run):
    return run.window_s / len(run.samples) if run.samples else None
