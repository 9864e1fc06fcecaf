"""Seconds from the start of the process to the start of the window:
imports, the libraries' build or look-up, the input's generation and the
cold sample."""


def read(run):
    return run.setup_s
