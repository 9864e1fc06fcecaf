"""The comparison that decides ``correct``.

Each number compared has a limit of its own, kept with the cell in
``benchmark/checks/<workload>.json`` beside the readings it was set from
(``PERF.md`` gives them too). A run is correct when every number is at
or under its limit.

- ``graph_builds_missing``: samples of the window whose graph build the
  digest hook did not see (each sample builds one graph).
- ``nodes_gap``, ``mult_sum_gap``: the largest gap, over the window's
  samples, between the node count (the sum of the multiplicities) of the
  program's node table and the reference's.
- ``tables_differing``: samples whose node table's digest is not the
  reference's.
- ``reports_differing``: samples whose report is not, byte for byte, the
  cold sample's.
- ``report_kmers_absent``: k-mers of the reported spacers that are no
  node of the reference's table.
- ``spacers_missed_pct``: the share of the planted spacers whose core the
  report does not hold, in percent.
- ``spacers_extra_pct``: the share of the reported spacers that hold no
  planted spacer's core, or only cores an earlier reported spacer holds
  (spacers the substring filter should have dropped, systems of no
  planted array), in percent.
- ``kernel_score_gap``: the widest gap between a score that the report's
  batched route (``partial_ratio_pairs``, ``pairwise_ratio_matrix``: the
  two kernels) gave in a window sample and the reference's score of the
  same strings; 0 where the window made no such call.

The report lists a system's spacers longest first (MCAAT's post-processing
keeps them in a set and its substring filter sorts them by length), so it
holds no order of spacers to compare.
"""

from __future__ import annotations

import json
import os

from benchmark import reference

NAMES = ("graph_builds_missing", "nodes_gap", "mult_sum_gap", "tables_differing",
         "reports_differing", "report_kmers_absent", "spacers_missed_pct", "spacers_extra_pct",
         "kernel_score_gap")


def load_limits(bench_dir: str, workload: str) -> dict:
    with open(os.path.join(bench_dir, "checks", f"{workload}.json")) as fh:
        limits = json.load(fh)["limits"]
    missing = [n for n in NAMES if n not in limits]
    if missing:
        raise ValueError(f"checks/{workload}.json gives no limit for {missing}")
    return limits


def readings(ref: dict, digests: list, n_samples: int, reports: list, cold_report: bytes,
             arrays: list, score_gap: float) -> dict:
    """Every number compared, from the reference's graph (``ref``, of
    :func:`reference.reference_graph` with the cold report's k-mers
    probed), the window's digests and reports, the planted arrays and the
    scores' gap (:func:`reference.score_gap`)."""
    found, planted = reference.spacers_found(arrays, cold_report.decode())
    extra, reported = reference.spacers_extra(arrays, cold_report.decode())
    return {
        "graph_builds_missing": n_samples - len(digests),
        "nodes_gap": max((abs(d["nodes"] - ref["nodes"]) for d in digests), default=0),
        "mult_sum_gap": max((abs(d["mult_sum"] - ref["mult_sum"]) for d in digests), default=0),
        "tables_differing": sum(1 for d in digests if d["digest"] != ref["digest"]),
        "reports_differing": sum(1 for r in reports if r != cold_report),
        "report_kmers_absent": ref["absent"],
        "spacers_missed_pct": 100.0 * (planted - found) / max(planted, 1),
        "spacers_extra_pct": 100.0 * extra / max(reported, 1),
        "kernel_score_gap": score_gap,
    }


def reference_for(codes, lengths, cold_report: bytes, device, keep_bits=reference.KMER_BITS):
    """The reference's graph with the cold report's k-mers probed."""
    probe = reference.pack_kmers(reference.report_spacers(cold_report.decode()))
    return reference.reference_graph(codes, lengths, device, probe, keep_bits=keep_bits)


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
