"""Seconds a sample of the program's ``spacer_ordering/solve`` span: the
ordering subproblems solved, in the forked pool (its fork and the wait on
its futures) or in the serial loop (``pipeline._solve_subproblems``)."""

from benchmark.spans import hook, per_sample, span_s  # noqa: F401


def read(run):
    return per_sample(run, lambda recs: span_s(recs, "spacer_ordering/solve"))
