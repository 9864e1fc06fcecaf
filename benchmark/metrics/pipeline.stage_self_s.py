"""Seconds a sample of the five stages that their direct child spans and
timers do not cover (their self time, summed): what the program's
tracing does not see."""

from benchmark.spans import hook, per_sample, self_s  # noqa: F401


def read(run):
    return per_sample(run, self_s)
