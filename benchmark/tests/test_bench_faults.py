"""The check must fail a broken timed path, and the control.

Each fault is planted underneath a run of the harness on the CPU (its look
for a card skipped), and the run must come out not correct:

- half of the batch left out: the program's graph build gets every
  other read of each file;
- an answer altered where it is produced: the report the program writes
  has one base of every spacer changed; the report's two kernels give 0
  for every score; every system of the report is written twice;
- the controls: the reference kept in int32 k-mers (``keep_bits=32``), and
  the reference's scores rounded to float16, each put in the program's
  place, against the reference.

The cell has no training step whose state could come back unchanged and
runs on one card, with no exchange between cards to leave out.
"""

import time

import numpy as np
import torch
from conftest import TINY

from benchmark import compare, fragments, harness, reference


def _run(bench_copy, seed=5):
    root, bench = bench_copy
    cell = harness.load_cell(harness.load_spec(root), TINY, root=root, bench_dir=bench)
    return harness.execute(cell, seed, 1.0, False, time.perf_counter(), device="cpu",
                           bench_dir=bench)


def test_half_of_the_reads_left_out(bench_copy, cpu_program, monkeypatch):
    from mcaat_tpu_torch import pipeline
    from mcaat_tpu_torch.io.fastq import ReadBatch

    orig = pipeline._load_input_batches

    def half(settings):
        return [(p, ReadBatch(codes=b.codes[::2], lengths=b.lengths[::2]))
                for p, b in orig(settings)]

    monkeypatch.setattr(pipeline, "_load_input_batches", half)
    line = _run(bench_copy)
    assert line["correct"] is False
    assert line["checks"]["nodes_gap"]["value"] > 0
    assert line["checks"]["tables_differing"]["value"] == line["attempted"]


def test_a_spacer_base_altered_in_the_report(bench_copy, cpu_program, monkeypatch):
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer

    orig = CRISPRAnalyzer.run_analysis
    swap = str.maketrans("ACGT", "CATG")

    def altered(self):
        text = orig(self)
        spacers = set(reference.report_spacers(text))
        lines = [ln[: len(ln) // 2] + ln[len(ln) // 2].translate(swap) + ln[len(ln) // 2 + 1:]
                 if ln in spacers else ln for ln in text.split("\n")]
        with open(self.output_path, "w") as fh:
            fh.write("\n".join(lines))
        return "\n".join(lines)

    monkeypatch.setattr(CRISPRAnalyzer, "run_analysis", altered)
    line = _run(bench_copy)
    assert line["correct"] is False
    assert line["checks"]["report_kmers_absent"]["value"] > 0
    assert line["checks"]["spacers_missed_pct"]["value"] > 90


def test_the_control_fails(bench_copy, tmp_path):
    _root, bench = bench_copy
    params = harness.load_cell(harness.load_spec(bench_copy[0]), TINY, root=bench_copy[0],
                               bench_dir=bench).params()
    made = fragments.write_input(str(tmp_path), seed=9, **params)
    codes, lengths = reference.encode_reads(made["mates"], made["lengths"])
    ref = reference.reference_graph(codes, lengths, "cpu")
    control = reference.reference_graph(codes, lengths, "cpu", keep_bits=32)
    # the control's table stands where the program's would, one digest a sample
    got = compare.readings(ref, [control] * 2, 2, [b"r", b"r"], b"r", made["arrays"], 0.0)
    correct, checks = compare.judge(got, compare.load_limits(bench, TINY))
    assert not correct
    assert checks["nodes_gap"]["value"] > 0.01 * ref["nodes"]
    assert checks["mult_sum_gap"]["value"] == 0  # the same windows, fewer nodes
    assert np.isfinite(checks["spacers_missed_pct"]["value"])


def test_the_kernels_scores_zeroed(bench_copy, cpu_program, monkeypatch):
    from mcaat_tpu_torch.report import batched_fuzz

    monkeypatch.setattr(batched_fuzz, "partial_ratio_table",
                        lambda codes, lengths, s_idx, l_idx: torch.zeros(
                            s_idx.shape[0], dtype=torch.float32, device=codes.device))
    monkeypatch.setattr(batched_fuzz, "ratio_matrix",
                        lambda codes, lengths: torch.zeros(
                            (codes.shape[0],) * 2, dtype=torch.float32, device=codes.device))
    line = _run(bench_copy)
    assert line["correct"] is False
    assert line["checks"]["kernel_score_gap"]["value"] > 50


def test_every_system_written_twice(bench_copy, cpu_program, monkeypatch):
    from mcaat_tpu_torch.report.analyzer import CRISPRAnalyzer

    orig = CRISPRAnalyzer.run_analysis

    def twice(self):
        text = orig(self)
        head, sep, rest = text.partition("-" * 50 + "\n")
        body, tail = rest.rsplit("Number of Systems:", 1)
        doubled = head + sep + body + body + "Number of Systems:" + tail
        with open(self.output_path, "w") as fh:
            fh.write(doubled)
        return doubled

    monkeypatch.setattr(CRISPRAnalyzer, "run_analysis", twice)
    line = _run(bench_copy)
    assert line["correct"] is False
    assert line["checks"]["spacers_extra_pct"]["value"] >= 50
    assert line["checks"]["report_kmers_absent"]["value"] == 0


def test_the_scores_control_fails(bench_copy, tmp_path):
    """The reference's scores in float16 in the program's place, on the
    spacer tables of a generated input."""
    from mcaat_tpu_torch.report import batched_fuzz

    root, bench = bench_copy
    params = harness.load_cell(harness.load_spec(root), TINY, root=root,
                               bench_dir=bench).params()
    made = fragments.make_fragments(seed=2**33 + 7, **params)
    table = [s for a in made["arrays"] for s in a["spacers"]][:40]
    shorts = [table[i] for i in range(len(table)) for _ in range(i)]
    longs = [table[j] for i in range(len(table)) for j in range(i)]
    cpu = torch.device("cpu")
    calls = [("partial_ratio", shorts, longs, batched_fuzz.partial_ratio_pairs(shorts, longs, cpu)),
             ("ratio_matrix", table, batched_fuzz.pairwise_ratio_matrix(table, cpu))]
    limit = compare.load_limits(bench, TINY)["kernel_score_gap"]
    sound = reference.score_gap(calls, "cpu")
    control = reference.score_gap(calls, "cpu", dtype=np.float16)
    assert sound <= limit < control
