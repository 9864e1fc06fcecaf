"""The debug pipeline (``--debug-pipeline``) of the port against
``mcaat_tpu``: each host module on the same graph, then the whole run.

The modules get the graph of a planted metagenome whose phage genome
carries parts of two spacers, built and pruned by each package on its
own, so the protospacer paths and the phage beam search find something.
``run_debug_pipeline`` must write the same four files, byte for byte, as
the JAX package and as the expected files in ``tests/torch_data/debug/``
(written by the JAX package; see ``tests/torch_debug_inputs.py``). Every
comparison is exact.
"""

import importlib
import os

import numpy as np
import pytest

import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.cycles.finder import find_cycles as jax_find_cycles
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.cycles.finder import find_cycles
from mcaat_tpu_torch.settings import Settings
from tests import torch_debug_inputs as inputs
from tests.test_torch_graph import CPU
from tests.test_torch_pipeline import _require_native_umap


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """``(jax_host, port_host, jax_cycles, port_cycles)`` after the debug
    pipeline's build and full prune, on the phage-bearing input."""
    tmp = str(tmp_path_factory.mktemp("phage"))
    fq = inputs.input_files("planted_2x26_phage", tmp)
    jg = jpipeline.build_graph_from_settings(JSettings(input_files=fq, mesh="off"))
    jg, jcyc = jax_find_cycles(jg, verbose=False, full_prune=True)
    tg = tpipeline.build_graph_from_settings(Settings(input_files=fq), device=CPU)
    tg, tcyc = find_cycles(tg, verbose=False, full_prune=True)
    return jg.to_host(), tg.to_host(), jcyc, tcyc


def test_cycles_match(graphs):
    _jh, _th, jcyc, tcyc = graphs
    assert jcyc == tcyc and len(tcyc) >= 2


def test_host_dbg_neighbour_lists(graphs):
    jh, th, _jc, _tc = graphs
    n = th.size
    assert int(jh.valid[:n].sum()) == int(th.valid.sum())
    for node in range(0, n, 7):
        assert th.outgoing_list(node) == jh.outgoing_list(node)
        assert th.incoming_list(node) == jh.incoming_list(node)
        assert th.band_outgoing_list(node) == jh.band_outgoing_list(node)
        assert th.band_incoming_list(node) == jh.band_incoming_list(node)


def test_filters_match(graphs):
    from mcaat_tpu.systems.filters import Filters as JFilters
    from mcaat_tpu_torch.systems.filters import Filters

    jh, th, jcyc, tcyc = graphs
    got = Filters(th, tcyc).list_arrays()
    assert got == JFilters(jh, jcyc).list_arrays()
    assert len(got[0]) >= 2 and got[1] > 40


def test_filters_require_multiple_cycles():
    from tests.test_aux_components import toy_host_graph
    from mcaat_tpu_torch.systems.filters import Filters

    g = toy_host_graph({i: "A" * 23 for i in range(5)}, {})
    assert Filters(g, {0: [[0, 1, 2]]}).list_arrays() == ({}, 0)


def _protospacer_stages(pkg, host, cycles):
    """The debug pipeline's stages from Filters to the phage curator, in
    one package; returns what each stage produced."""
    mod = importlib.import_module(f"{pkg}.protospacers")
    filters = importlib.import_module(f"{pkg}.systems.filters")
    systems, _n = filters.Filters(host, cycles).list_arrays()
    r2s = mod.create_repeat_to_spacer_nodes(host, systems)
    iso = mod.IsolateProtospacers.from_repeat_to_spacer_nodes(host, r2s)
    in_map, out_map = iso.get_protospacer_nodes()
    grouped = iso.depth_limited_paths_from_in_to_out(in_map, out_map, 50, 1)
    return r2s, in_map, out_map, grouped


def test_protospacer_sets_and_paths_match(graphs):
    jh, th, jcyc, tcyc = graphs
    got = _protospacer_stages("mcaat_tpu_torch", th, tcyc)
    want = _protospacer_stages("mcaat_tpu", jh, jcyc)
    for a, b in zip(got, want):
        assert a == b
    assert got[3]  # the phage's protospacer paths were found


def test_protospacer_in_out_discovery_toy():
    from tests.test_aux_components import toy_host_graph
    from mcaat_tpu_torch.protospacers import IsolateProtospacers, _contains_subsequence

    g = toy_host_graph({i: "ACGT" for i in range(5)}, {0: [1], 1: [2], 2: [3, 4], 3: [1]})
    iso = IsolateProtospacers(graph=g, cycle_nodes={1: {1, 2, 3}}, cycle_to_group={1: 99})
    assert iso.get_protospacer_nodes() == ({1: {0}}, {1: {4}})
    assert _contains_subsequence([1, 2, 3, 4], [2, 3])
    assert not _contains_subsequence([1, 2, 3, 4], [2, 4])


def test_protospacer_paths_file_round_trip(tmp_path):
    from mcaat_tpu.protospacers import IsolateProtospacers as J
    from mcaat_tpu_torch.protospacers import IsolateProtospacers as T

    paths = {7: {3: [[1, 2, 3], [9, 10]]}, 8: {5: [[4, 5]]}}
    T.write_paths_to_file(paths, str(tmp_path / "t.txt"))
    J.write_paths_to_file(paths, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert T.read_paths_from_file(str(tmp_path / "t.txt")) == paths


def test_phage_beam_search_and_top_paths_match(graphs, tmp_path):
    from mcaat_tpu.phage import PhageCurator as JCurator
    from mcaat_tpu_torch.phage import PhageCurator

    jh, th, jcyc, tcyc = graphs
    grouped = _protospacer_stages("mcaat_tpu_torch", th, tcyc)[3]
    cur = PhageCurator(graph=th, grouped_paths=grouped, cycles=tcyc)
    jcur = JCurator(graph=jh, grouped_paths=grouped, cycles=jcyc)
    assert cur.avg_spacers == jcur.avg_spacers and cur.cycle_nodes == jcur.cycle_nodes
    starts = [p[-1] for g in grouped.values() for ps in g.values() for p in ps]
    n_paths = 0
    for start in starts:
        base = float(th.mult[start])
        args = (start, 300, 310, cur.cycle_nodes, 8, max(0.1 * base, 1.0), 5.0 * base)
        paths = cur.beam_search_paths_avoiding(*args)
        assert paths == jcur.beam_search_paths_avoiding(*args)
        top = cur.get_top_paths_from_beam_paths(paths, 20, 5, 2)
        assert top == jcur.get_top_paths_from_beam_paths(paths, 20, 5, 2)
        n_paths += len(paths)
    assert n_paths
    cur.find_quality_paths_beam_search(3000, 3010, str(tmp_path / "t.fa"), 50)
    jcur.find_quality_paths_beam_search(3000, 3010, str(tmp_path / "j.fa"), 50)
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    assert (tmp_path / "t.fa").stat().st_size > 3000


def test_phage_beam_search_toys():
    from tests.test_aux_components import toy_host_graph
    from mcaat_tpu_torch.phage import PhageCurator

    g = toy_host_graph({i: "ACGTA"[i % 5] * 23 for i in range(5)},
                       {i: [i + 1] for i in range(4)}, mult=[10] * 5)
    paths = PhageCurator(graph=g).beam_search_paths_avoiding(0, 3, 4, set(), 5, 1.0, 100.0)
    assert paths and all(3 <= len(p) - 1 <= 4 for p in paths)
    g = toy_host_graph({i: "A" * 23 for i in range(4)}, {0: [1], 1: [2], 2: [3]},
                       mult=[10, 10, 1, 10])
    assert PhageCurator(graph=g).beam_search_paths_avoiding(0, 2, 3, set(), 5, 1.0, 100.0) == []


@pytest.mark.parametrize("native", [True, False])
def test_poa_consensus_matches(native, monkeypatch):
    import mcaat_tpu.poa as jpoa
    import mcaat_tpu_torch.native as tnative
    import mcaat_tpu_torch.poa as tpoa

    if native and tnative.poa_consensus(["ACGT"]) is None:
        pytest.skip("the native library is not built")
    if not native:
        monkeypatch.setattr(tnative, "poa_consensus", lambda *a, **k: None)
    rng = np.random.default_rng(17)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    cases = [[], ["ACGT"], ["ACGTACGT"] * 3, ["ACGTACGTAC", "ACGTACGTAC", "ACGTTCGTAC"]]
    for _ in range(6):
        seqs = []
        for _ in range(int(rng.integers(2, 6))):
            s = list(base)
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, len(s)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    s[p] = "ACGT"[int(rng.integers(0, 4))]
                elif op == 1:
                    del s[p]
                else:
                    s.insert(p, "ACGT"[int(rng.integers(0, 4))])
            seqs.append("".join(s))
        cases.append(seqs)
    for seqs in cases:
        want = jpoa.compute_consensus_py(seqs)
        assert tpoa.compute_consensus(seqs) == want
        assert tpoa.compute_consensus_py(seqs) == want


def test_export_matches(graphs, tmp_path):
    from mcaat_tpu.io import export as jexport
    from mcaat_tpu_torch.io import export as texport

    jh, th, jcyc, tcyc = graphs
    n = th.size
    # the JAX graph's bucket padding is dropped: the dump and the GFA of
    # the live rows are the same bytes
    jlive = type(jh)(k=jh.k, kmers=jh.kmers[:n], mult=jh.mult[:n], out=jh.out[:n],
                     in_=jh.in_[:n], valid=jh.valid[:n])
    for fn, kw in ((texport.write_nodes_gfa, {}), (texport.write_nodes_gfa, {"with_sequences": True}),
                   (texport.write_graph_dump, {})):
        jfn = getattr(jexport, fn.__name__)
        fn(str(tmp_path / "t"), th, **kw)
        jfn(str(tmp_path / "j"), jlive, **kw)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    texport.write_cycles(str(tmp_path / "t.json"), tcyc)
    jexport.write_cycles(str(tmp_path / "j.json"), jcyc)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert texport.read_cycles(str(tmp_path / "t.json")) == tcyc
    path = next(iter(tcyc.values()))[0]
    texport.PathWriter(th, path, str(tmp_path / "tg"))
    jexport.PathWriter(jh, path, str(tmp_path / "jg"))
    for f in ("cycles.txt", "labels.txt"):
        assert (tmp_path / "tg" / f).read_bytes() == (tmp_path / "jg" / f).read_bytes()


def test_node_counter_matches():
    from mcaat_tpu.io.export import NodeCounter as JNodeCounter
    from mcaat_tpu_torch.io.export import NodeCounter

    cycles = {0: [10, 11, 12], 1: [20, 21, 12], 2: [30, 11]}
    nc, jnc = NodeCounter(cycles), JNodeCounter(cycles)
    assert nc.get_counts() == jnc.get_counts()
    nc.filter_only_unique_nodes()
    jnc.filter_only_unique_nodes()
    assert nc.get_counts() == jnc.get_counts()


@pytest.mark.parametrize("name", inputs.NAMES)
def test_debug_pipeline_outputs_match_jax_and_expected(name, tmp_path):
    _require_native_umap()
    tkw = inputs.settings_kwargs(name, str(tmp_path / "t"))
    jkw = inputs.settings_kwargs(name, str(tmp_path / "j"))
    result = tpipeline.run_debug_pipeline(Settings(**tkw), verbose=False, device="cpu")
    jpipeline.run_debug_pipeline(JSettings(**jkw, mesh="off"), verbose=False)
    got = inputs.read_outputs(tkw["output_folder"])
    assert got == inputs.read_outputs(jkw["output_folder"])
    expected = inputs.read_outputs(os.path.join(inputs.EXPECTED, name))
    assert got == expected
    assert result.report_text.encode() == got["CRISPR_Arrays.txt"]
    assert [s.name for s in result.profile.stages] == [
        "graph_build", "histogram", "cycle_search", "filters", "report",
        "protospacers", "phage",
    ]


def test_cli_debug_pipeline_flag_and_settings_key(tmp_path, monkeypatch):
    """``--debug-pipeline`` and ``debug_pipeline=true`` run it through
    ``main``; the graph folder is left as the JAX package leaves it."""
    from mcaat_tpu_torch.cli import main

    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    fq = inputs.input_files("golden", str(tmp_path))
    expected = inputs.read_outputs(os.path.join(inputs.EXPECTED, "golden"))
    out = tmp_path / "a"
    assert main(["--input-files", fq, "--output-folder", str(out), "--debug-pipeline"]) == 0
    assert inputs.read_outputs(str(out)) == expected
    cfg = tmp_path / "s.txt"
    cfg.write_text(f"input_files={fq}\noutput_folder={tmp_path / 'b'}\ndebug_pipeline=true\n")
    assert main(["--settings", str(cfg)]) == 0
    assert inputs.read_outputs(str(tmp_path / "b")) == expected
