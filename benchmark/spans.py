"""The program's spans, timers and counters (``mcaat_tpu_torch.utils.profiling``:
one list of records a sample, each record a stage or a span inside one,
with its counters and timers) and the arithmetic the per-layer readers
share.

:func:`hook` keeps ``result.profile.span_records()`` of every
``pipeline.run_pipeline`` call in the window in ``run.probes["spans"]``
(a hook is open in the traced run alone). A program without spans gives
no records, and every reader then returns None.
"""

from __future__ import annotations

import contextlib

# the stages of a sample whose self time pipeline.stage_self_s sums
STAGES = ("graph_build", "cycle_search", "read_mapping", "spacer_ordering", "report")


@contextlib.contextmanager
def hook(run):
    """``run.probes["spans"]``: the records of each sample of the window."""
    from benchmark.probes import _wrapped
    from mcaat_tpu_torch import pipeline

    out = run.probes.setdefault("spans", [])

    def wrap(orig):
        def run_pipeline(*args, **kwargs):
            result = orig(*args, **kwargs)
            records = getattr(result.profile, "span_records", None)
            if records is not None:
                out.append(records())
            return result

        return run_pipeline

    with _wrapped(pipeline, "run_pipeline", wrap):
        yield out


def per_sample(run, value):
    """``value(records)`` summed over the window's samples, over the
    number of samples; None where no sample left records."""
    samples = run.probes.get("spans") or []
    if not samples or not run.samples:
        return None
    return sum(value(records) for records in samples) / len(run.samples)


def _seconds(rec) -> float:
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


def _in_stage(rec, stage: str) -> bool:
    return rec["name"] == stage or rec["name"].startswith(stage + "/")


def span_s(records, name: str) -> float:
    """Seconds of the spans named ``name`` (a path: ``graph_build/parse``)."""
    return sum(_seconds(r) for r in records if r["name"] == name)


def timer_s(records, stage: str, name: str) -> float:
    """Seconds of the timer ``name`` over a stage and its spans."""
    return sum(r["timers"][name]["seconds"] for r in records
               if _in_stage(r, stage) and name in r["timers"])


def counter(records, name: str, stage: str | None = None) -> float:
    """The counter ``name`` summed over the records (of ``stage`` alone
    when one is named)."""
    return sum(r["counters"].get(name, 0) for r in records
               if stage is None or _in_stage(r, stage))


def self_s(records, stages=STAGES) -> float:
    """Seconds of the stages ``stages`` that their direct child spans and
    their own timers do not cover, summed."""
    total = 0.0
    for st in records:
        if st["parent"] is not None or st["name"] not in stages:
            continue
        a, b = st["start_ns"], st["end_ns"]
        covered, last = 0, a
        kids = sorted((max(r["start_ns"], a), min(r["end_ns"], b))
                      for r in records if r["parent"] == st["name"])
        for s, e in kids:  # the union of the children's intervals
            s = max(s, last)
            if e > s:
                covered += e - s
                last = e
        timers = sum(t["seconds"] for t in st["timers"].values())
        total += max((b - a - covered) / 1e9 - timers, 0.0)
    return total
