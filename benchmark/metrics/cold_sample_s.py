"""Wall seconds of the process's first sample, the CLI module's import
included: what a one-sample CLI process pays. A part of ``setup_s``, read
in the traced run too (the cold sample runs before the profiler starts)."""


def read(run):
    return run.cold_sample_s or None
