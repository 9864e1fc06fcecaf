"""A pe150-shaped sample larger than the single-pass budget, through the
whole CLI (``cli.run_cli`` with its defaults) on the CPU: the budgets of
``graph/dbg.py`` and ``kmer/count.py`` are lowered so that the build goes
in at least 3 row parts, spills every counted part to the host and
chunks the adjacency at least 4 ways, as the ``pe150-parted``
configuration of the benchmark does at full size on one card.

The node table must be the plain reference's (``benchmark/reference.py``),
the report the single pass's byte for byte and the planted spacers found
by the benchmark's own comparison (``benchmark/compare.py``); each part is
one ``count_part`` span and each adjacency pass one ``adjacency_chunk``."""

import json
import os

import pytest

import mcaat_tpu_torch.graph.dbg as tdbg
import mcaat_tpu_torch.kmer.count as tcount
import mcaat_tpu_torch.pipeline as tpipeline
from benchmark import compare, fragments, probes, reference
from mcaat_tpu_torch.cli import run_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "pe150-parted.short-arrays-40"
UC = "graph_build/build/upload_count"
ADJ = "graph_build/build/adjacency"
# the lowered budgets: about 846k windows in parts of 300k, edge chunks of 20k
WINDOWS, EDGES = 300_000, 20_000


def _bench(*path):
    with open(os.path.join(ROOT, "benchmark", *path)) as fh:
        return json.load(fh)


def _cli(made, out, mp) -> dict:
    """One sample through ``run_cli``: its report, node-table digest and
    span records."""
    records, digests = [], []
    orig = tpipeline.run_pipeline

    def keep(*args, **kwargs):
        result = orig(*args, **kwargs)
        records.append(result.profile.span_records())
        return result

    mp.setattr(tpipeline, "run_pipeline", keep)
    with probes.graph_digests(digests):
        assert run_cli(["--input-files", *made["files"], "--output-folder", out]) is not None
    mp.setattr(tpipeline, "run_pipeline", orig)
    with open(os.path.join(out, "CRISPR_Arrays.txt"), "rb") as fh:
        return {"report": fh.read(), "digest": digests[0], "records": records[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sample (30 kbp of the configuration's community and 4 arrays of
    the traffic's spacer counts: about 1,660 pairs) in one pass and in
    parts."""
    params = dict(_bench("configs", "pe150-parted.json")["params"], background_len=30_000)
    mix = dict(_bench("traffic", "short-arrays-40.json")["params"], n_arrays=4)
    folder = tmp_path_factory.mktemp("parted")
    made = fragments.write_input(str(folder / "input"), seed=2**40 + 17, **params, **mix)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCAAT_TORCH_DEVICE", "cpu")
        single = _cli(made, str(folder / "single"), mp)
        mp.setattr(tdbg, "SINGLE_PASS_MAX_WINDOWS", WINDOWS)
        mp.setattr(tcount, "DEVICE_PARTS_BUDGET", 0)
        mp.setattr(tdbg, "ADJ_SINGLE_SHOT_MAX_EDGES", EDGES)
        parted = _cli(made, str(folder / "parted"), mp)
    codes, lengths = reference.encode_reads(made["mates"], made["lengths"])
    ref = compare.reference_for(codes, lengths, parted["report"], "cpu")
    return {"made": made, "single": single, "parted": parted, "ref": ref}


def _total(records, name):
    return sum(r["counters"].get(name, 0) for r in records)


def _spans(records, name):
    return [r for r in records if r["name"] == name]


def test_the_build_went_in_parts_spills_and_chunks(runs):
    recs = runs["parted"]["records"]
    assert _total(recs, "windows") > 2 * WINDOWS
    assert _total(recs, "parts") >= 3
    assert _total(recs, "host_spilled") >= 1
    assert len(_spans(recs, f"{ADJ}/adjacency_chunk")) >= 4
    single = runs["single"]["records"]
    assert (_total(single, "parts"), _total(single, "host_spilled")) == (1, 0)


def test_the_node_table_is_the_references(runs):
    ref = runs["ref"]
    for run in ("single", "parted"):
        got = runs[run]["digest"]
        assert (got["nodes"], got["mult_sum"], got["digest"]) == (
            ref["nodes"], ref["mult_sum"], ref["digest"]), run


def test_the_report_is_the_single_passs_byte_for_byte(runs):
    assert runs["parted"]["report"] == runs["single"]["report"]
    assert runs["parted"]["report"].count(b"\n") > 10


def test_the_planted_spacers_are_found_by_the_benchmarks_rule(runs):
    made, report = runs["made"], runs["parted"]["report"]
    got = compare.readings(runs["ref"], [runs["parted"]["digest"]], 1, [report], report,
                           made["arrays"], 0.0)
    correct, checks = compare.judge(got, compare.load_limits(os.path.join(ROOT, "benchmark"),
                                                             CELL))
    assert correct, checks
    found, planted = reference.spacers_found(made["arrays"], report.decode())
    assert found == planted > 0


@pytest.mark.parametrize("run", ["single", "parted"])
def test_a_span_a_part_and_a_chunk(runs, run):
    recs = runs[run]["records"]
    parts = _spans(recs, f"{UC}/count_part")
    assert len(parts) == _total(recs, "parts")
    (uc,) = _spans(recs, UC)
    chunks = _spans(recs, f"{ADJ}/adjacency_chunk")
    (adj,) = _spans(recs, ADJ)
    step = EDGES if run == "parted" else tdbg.ADJ_SINGLE_SHOT_MAX_EDGES
    assert len(chunks) == -(-uc["counters"]["unique_24mers"] // step) >= 1
    for outer, inner in [(uc, parts), (adj, chunks)]:
        ends = [(r["start_ns"], r["end_ns"]) for r in inner]
        assert ends == sorted(ends)
        assert all(outer["start_ns"] <= s <= e <= outer["end_ns"] for s, e in ends)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))  # one after another
