"""Seconds a sample of the program's ``host_route`` timer in the ``report``
stage: the host's ``ratio`` and ``partial_ratio`` loops of the report's
diversity check and substring filter, for systems of 24 spacers or fewer."""

from benchmark.spans import hook, per_sample, timer_s  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: timer_s(recs, "report", "host_route"))
