"""Stage checkpoints and ``--resume`` of the port, and their exchange with
``mcaat_tpu``.

Both packages write the same ``.npz`` keys and JSON layouts, so a run of
either resumes from the other's files and writes the same report; every
comparison is exact (integers, strings, report bytes).
"""

import os

import numpy as np
import pytest
import torch

import mcaat_tpu.checkpoint as jckpt
import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.checkpoint as tckpt
import mcaat_tpu_torch.cycles.finder as tfinder
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.reads.chains import Chains
from mcaat_tpu_torch.settings import Settings
from tests.test_torch_graph import CPU, port_graph, rand_reads
from tests.test_torch_pipeline import DATA, _require_native_umap

GOLDEN = os.path.join(DATA, "golden_reads.fq")
ARTIFACTS = ("graph.npz", "graph_pruned.npz", "cycles.json", "reads.json")
LOADED = (
    "Graph loaded from checkpoint:",
    "Cycles loaded from checkpoint:",
    "Reads loaded from checkpoint:",
)
FIELDS = ("kmers", "mult", "out", "in_", "valid")


def small_graph():
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads

    b = encode_sequences(rand_reads(21))
    return build_dbg_from_reads(b.codes, b.lengths, device=CPU)


def test_graph_round_trip(tmp_path):
    g = small_graph()
    g = g.set_invalid(torch.arange(g.size) % 3 == 0)
    path = str(tmp_path / "sub" / "graph.npz")
    tckpt.save_graph(path, g)
    back = tckpt.load_graph(path, CPU)
    assert back.k == g.k
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(g, f)), f
    assert torch.equal(tckpt.load_graph(path[: -len(".npz")], CPU).kmers, g.kmers)


def test_cycles_reads_systems_round_trip(tmp_path):
    cycles = {5: [[5, 2, 3], [5, 9]], 11: [[11, 7]]}
    tckpt.save_cycles(str(tmp_path / "c.json"), cycles)
    assert tckpt.load_cycles(str(tmp_path / "c.json")) == cycles
    reads = Chains.from_lists([[1, 2, 3], [], [4]])
    tckpt.save_reads(str(tmp_path / "r.json"), reads)
    assert tckpt.load_reads(str(tmp_path / "r.json")) == reads
    tckpt.save_reads(str(tmp_path / "l.json"), [[7, 8]])
    assert tckpt.load_reads(str(tmp_path / "l.json")).tolists() == [[7, 8]]
    fs = [tpipeline.FoundSystem("ACGTAC", "ACG", ["TT", "GG"], 0.5, 1.0)]
    tckpt.save_systems(str(tmp_path / "s.json"), fs)
    assert tckpt.load_systems(str(tmp_path / "s.json")) == fs


def test_port_graph_loads_in_jax(tmp_path):
    g = small_graph()
    tckpt.save_graph(str(tmp_path / "graph.npz"), g)
    jg = jckpt.load_graph(str(tmp_path / "graph.npz"))
    assert jg.k == g.k
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(g, f).numpy(), f)


def test_jax_graph_loads_in_port_with_its_padding(tmp_path):
    """A JAX checkpoint keeps its bucket padding (SENTINEL k-mers,
    ``valid=False``); the port loads it as it is."""
    from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
    from mcaat_tpu.io.fastq import encode_sequences

    b = encode_sequences(rand_reads(21))
    jg = jax_build(b.codes, b.lengths, k=23)
    jckpt.save_graph(str(tmp_path / "graph.npz"), jg)
    g = tckpt.load_graph(str(tmp_path / "graph.npz"), CPU)
    ref = port_graph(jg)
    assert g.size == jg.size > int(g.valid.sum())
    for f in FIELDS:
        assert torch.equal(getattr(g, f), getattr(ref, f)), f


def _port_run(ck, out, capsys=None):
    s = Settings(input_files=GOLDEN, output_file=str(out))
    r = tpipeline.run_pipeline(s, verbose=capsys is not None, checkpoint_dir=str(ck), device="cpu")
    printed = capsys.readouterr().out if capsys is not None else ""
    return r.report_text, printed


def test_run_pipeline_resumes_from_checkpoints(tmp_path, capsys):
    """A first run writes the four artifacts; a second loads all three
    stages; a third, without reads.json and cycles.json, loads the graph
    and runs the rest. All three reports are the golden one."""
    _require_native_umap()
    expected = open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")).read()
    ck = tmp_path / "ck"
    first, printed = _port_run(ck, tmp_path / "1.txt", capsys)
    assert first == expected
    assert sorted(os.listdir(ck)) == sorted(ARTIFACTS)
    assert not any(line in printed for line in LOADED)
    second, printed = _port_run(ck, tmp_path / "2.txt", capsys)
    assert second == expected
    assert all(line in printed for line in LOADED)
    assert "STEP 6" in printed and "graph_build" not in printed
    os.remove(ck / "reads.json")
    os.remove(ck / "cycles.json")
    third, printed = _port_run(ck, tmp_path / "3.txt", capsys)
    assert third == expected
    assert LOADED[0] in printed and LOADED[1] not in printed and LOADED[2] not in printed
    assert sorted(os.listdir(ck)) == sorted(ARTIFACTS)


def test_full_resume_reads_only_the_pruned_graph(tmp_path, monkeypatch):
    """With cycles.json and graph_pruned.npz in place, graph.npz is not
    loaded: the pruned graph is the one every later stage reads."""
    _require_native_umap()
    ck = tmp_path / "ck"
    _port_run(ck, tmp_path / "1.txt")
    loaded = []
    orig = tckpt.load_graph

    def spy(path, *args, **kwargs):
        loaded.append(os.path.basename(path))
        return orig(path, *args, **kwargs)

    monkeypatch.setattr(tckpt, "load_graph", spy)
    _port_run(ck, tmp_path / "2.txt")
    assert loaded == ["graph_pruned.npz"]


@pytest.mark.parametrize(
    "damage,drop",
    [
        ("truncate", "graph_pruned.npz"),
        ("remove", "graph_pruned.npz"),
        ("truncate", "cycles.json"),
        ("truncate", "graph.npz"),
    ],
)
def test_resume_recomputes_a_damaged_stage(damage, drop, tmp_path, capsys):
    """An artifact cut short (as by a kill in a writer that wrote in
    place) or missing makes its stage run again; the report is the same
    and the rewritten artifact loads. A damaged graph.npz matters only
    once the cycle stage must rerun, so cycles.json goes with it."""
    _require_native_umap()
    expected = open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")).read()
    ck = tmp_path / "ck"
    _port_run(ck, tmp_path / "1.txt")
    os.remove(ck / "reads.json")
    victims = [drop] + (["cycles.json"] if drop == "graph.npz" else [])
    for name in victims:
        path = ck / name
        if damage == "truncate" and name == drop:
            path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
        else:
            os.remove(path)
    got, printed = _port_run(ck, tmp_path / "2.txt", capsys)
    assert got == expected
    assert LOADED[1] not in printed
    if drop == "graph.npz":
        assert "Graph built:" in printed and LOADED[0] not in printed
    if damage == "truncate":
        assert "checkpoint unreadable" in printed
    assert sorted(os.listdir(ck)) == sorted(ARTIFACTS)
    tckpt.load_graph(str(ck / "graph_pruned.npz"), CPU)
    tckpt.load_cycles(str(ck / "cycles.json"))


def test_a_failed_write_leaves_no_artifact(tmp_path, monkeypatch):
    """Artifacts are written beside their name and renamed into place: a
    writer that dies leaves neither a truncated file nor its temporary."""
    g = small_graph()
    calls = []
    orig = np.lib.format.write_array

    def dies_on_the_second_member(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return orig(*args, **kwargs)

    monkeypatch.setattr(np.lib.format, "write_array", dies_on_the_second_member)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_graph(str(tmp_path / "graph.npz"), g)
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(tckpt.json, "dump", lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError):
        tckpt.save_cycles(str(tmp_path / "cycles.json"), {1: [[1, 2]]})
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("drop", [(), ("reads.json",), ("reads.json", "cycles.json")])
def test_port_resumes_jax_checkpoints(drop, tmp_path, monkeypatch):
    """The port resumes a checkpoint directory written by
    ``mcaat_tpu.run_pipeline``, fully or from an earlier stage. The JAX
    graph is padded to 5120 rows over 4544 live nodes; with the big-graph
    thresholds set between the two, the resumed graph takes the
    neighbourhood, lazy-clip, region-first and condense branches while a
    fresh port build does not, and the report is the same."""
    _require_native_umap()
    ck = tmp_path / "ck"
    want = jpipeline.run_pipeline(
        JSettings(input_files=GOLDEN, output_file=str(tmp_path / "j.txt"), mesh="off"),
        verbose=False, checkpoint_dir=str(ck),
    ).report_text
    assert sorted(os.listdir(ck)) == sorted(ARTIFACTS)
    for name in drop:
        os.remove(ck / name)
    monkeypatch.setattr(tfinder, "NEIGHBORHOOD_MIN_NODES", 5000)
    monkeypatch.setattr(tfinder, "LAZY_CLIP_MIN_NODES", 5000)
    monkeypatch.setattr(tpipeline, "REGION_CONDENSE_MIN_NODES", 5000)
    condensed = []
    orig = tpipeline.spacer_ordering_step

    def spy(graph, *args, **kwargs):
        condensed.append(graph.size >= 5000)
        return orig(graph, *args, **kwargs)

    monkeypatch.setattr(tpipeline, "spacer_ordering_step", spy)
    fresh = tpipeline.run_pipeline(
        Settings(input_files=GOLDEN, output_file=str(tmp_path / "f.txt")),
        verbose=False, device="cpu",
    ).report_text
    got, _ = _port_run(ck, tmp_path / "t.txt")
    assert condensed == [False, True]
    assert got == want == fresh


def test_cli_resume_keeps_the_graph_folder(tmp_path, monkeypatch):
    from mcaat_tpu_torch.cli import main

    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    out = tmp_path / "out"
    argv = ["--input-files", GOLDEN, "--output-folder", str(out), "--resume"]
    assert main(argv) == 0
    assert sorted(os.listdir(out / "graph")) == sorted(ARTIFACTS)
    report = (out / "CRISPR_Arrays.txt").read_bytes()
    os.remove(out / "CRISPR_Arrays.txt")
    assert main(argv) == 0
    assert (out / "CRISPR_Arrays.txt").read_bytes() == report


def test_settings_file_resume_true(tmp_path, monkeypatch):
    from mcaat_tpu_torch.cli import main, parse_arguments

    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    out = tmp_path / "out"
    cfg = tmp_path / "s.txt"
    cfg.write_text(f"input_files={GOLDEN}\noutput_folder={out}\nresume=true\n")
    assert parse_arguments(["--settings", str(cfg)]).resume
    assert main(["--settings", str(cfg)]) == 0
    assert sorted(os.listdir(out / "graph")) == sorted(ARTIFACTS)
    cfg.write_text(f"input_files={GOLDEN}\noutput_folder={out}\nresume=false\n")
    assert not parse_arguments(["--settings", str(cfg)]).resume
