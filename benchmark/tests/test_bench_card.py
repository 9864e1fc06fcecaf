"""On a card: the reference's node table on the card is the one it builds
on the CPU, and a run of the harness on the small cell is correct.
Each test decides inside itself whether a card is present."""

import time

import pytest
from conftest import TINY

from benchmark import fragments, harness, reference


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(bench_copy, tmp_path):
    _card()
    root, bench = bench_copy
    params = harness.load_cell(harness.load_spec(root), TINY, root=root, bench_dir=bench).params()
    made = fragments.write_input(str(tmp_path), seed=2**32 + 3, **params)
    codes, lengths = reference.encode_reads(made["mates"], made["lengths"])
    probe = reference.pack_kmers([a["spacers"][0] for a in made["arrays"]])
    assert (reference.reference_graph(codes, lengths, "cuda", probe)
            == reference.reference_graph(codes, lengths, "cpu", probe))


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct(bench_copy, monkeypatch):
    _card()
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cuda")
    root, bench = bench_copy
    cell = harness.load_cell(harness.load_spec(root), TINY, root=root, bench_dir=bench)
    line = harness.execute(cell, 2**31 + 1, 2.0, True, time.perf_counter(), bench_dir=bench)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["device.idle_share"]["value"] < 100
