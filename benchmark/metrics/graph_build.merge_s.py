"""Seconds a sample of the graph build's merge stack: the program's timer
``part_merge`` (each counted part pushed, merging equal levels) and its
span ``graph_build/build/upload_count/final_merge`` (what is left merged
into one table). None where the program has neither."""

from benchmark.spans import hook, per_sample, span_s, timer_s  # noqa: F401

FINAL = "graph_build/build/upload_count/final_merge"


def _has(recs) -> bool:
    return any(r["name"] == FINAL or "part_merge" in r["timers"] for r in recs)


def read(run):
    if not any(_has(recs) for recs in run.probes.get("spans") or []):
        return None
    return per_sample(run, lambda recs: timer_s(recs, "graph_build", "part_merge")
                      + span_s(recs, FINAL))
