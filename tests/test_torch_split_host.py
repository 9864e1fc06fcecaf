"""The spacer-ordering stage's SCC split in compiled code
(``mcaat_tpu_torch/native/split.cpp``) against the port's Python route and
the JAX package's split: on seeded graphs with invalid nodes, empty slots
between live ones, self loops, repeated neighbours and one-node components
(with and without a self loop, never a subgraph), the subgraphs come out
in the same order with the same ``nodes`` and ``adjacency`` (content and
iteration order), edge and node counts, and a label array that names each
node's subgraph. The relevance filter reads that label array and gives
what it gives from hand-built subgraphs; with the library forced off the
Python route runs and the counter ``split_compiled_nodes`` reads 0; a
whole ``spacer_ordering_step`` on a planted sample finds the same systems
and prints the same lines on both routes."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from mcaat_tpu.ordering import ordering as jord
from mcaat_tpu_torch import native as tnative
from mcaat_tpu_torch import pipeline as tpipeline
from mcaat_tpu_torch.ordering import ordering as tord
from mcaat_tpu_torch.settings import Settings
from mcaat_tpu_torch.utils import profiling as tprof
from tests.synthetic import make_metagenome, write_fastq

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX", "g++")) is None, reason="no C++ compiler"
)


def _graph(seed: int):
    """An [n, 4] out table and a validity mask: rings (strongly connected
    parts, some of them joined) over random edges, with -1 slots between
    live ones, self loops and repeated neighbours."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 400))
    out = np.full((n, 4), -1, dtype=np.int32)
    for u in range(n):
        for s in range(4):
            r = rng.random()
            if r < 0.25:
                out[u, s] = rng.integers(0, n)
            elif r < 0.3:
                out[u, s] = u  # a self loop
            elif r < 0.35 and s > 0:
                out[u, s] = out[u, s - 1]  # a repeated neighbour (or -1 again)
    perm = rng.permutation(n)
    start = 0
    while start < n - 1:  # rings of 2-12 nodes over free slots
        size = int(rng.integers(2, 13))
        ring = perm[start:start + size]
        for a, b in zip(ring, np.roll(ring, -1)):
            free = np.flatnonzero(out[a] < 0)
            if len(free):
                out[a, free[int(rng.integers(0, len(free)))]] = b
        start += size
    valid = rng.random(n) > 0.12
    return out, valid


def _python_route(monkeypatch):
    monkeypatch.setattr(tnative, "_split", None)
    monkeypatch.setattr(tnative, "_split_tried", True)


def _shape(subgraphs):
    """What a split is compared by: per subgraph, its nodes and adjacency
    in iteration order and its counts."""
    return [(list(sg.nodes), list(sg.adjacency.items()), sg.edge_count(), len(sg.nodes))
            for sg in subgraphs]


def _split(out, valid):
    """The subgraphs and the counters left on a stage."""
    prof = tprof.Profiler()
    with prof.stage("spacer_ordering"):
        got = tord.divide_graph_into_subgraphs(out, valid)
    return got, prof.span_records()[0]["counters"]


@pytest.mark.parametrize("seed", range(24))
def test_compiled_split_equals_both_python_routes(seed, monkeypatch):
    out, valid = _graph(seed)
    got, counters = _split(out, valid)
    assert got and all(isinstance(sg, tord.SplitSubgraph) for sg in got)
    # the counts read the arrays before anything is built
    counts = [(sg.edge_count(), sg.node_count()) for sg in got]
    assert counters["split_compiled_nodes"] == sum(c[1] for c in counts)
    label = got[0].split.label
    assert label.shape == (len(valid),)
    for i, sg in enumerate(got):
        assert (label[sorted(sg.nodes)] == i).all()
    assert (label >= 0).sum() == sum(len(sg.nodes) for sg in got)
    assert counts == [(sg.edge_count(), sg.node_count()) for sg in got]
    want_jax = jord.divide_graph_into_subgraphs(out, valid)
    with monkeypatch.context() as m:
        _python_route(m)
        want_port, port_counters = _split(out, valid)
    assert port_counters["split_compiled_nodes"] == 0
    assert not any(isinstance(sg, tord.SplitSubgraph) for sg in want_port)
    assert _shape(got) == _shape(want_port) == _shape(want_jax)


def test_the_graphs_hold_every_case():
    """Over the seeds of the test above: one-node components with and
    without a self loop, which no subgraph takes, invalid nodes with live
    slots, -1 slots between live ones, repeated neighbours, self loops
    inside subgraphs."""
    seen = set()
    for seed in range(24):
        out, valid = _graph(seed)
        label = tord.divide_graph_into_subgraphs(out, valid)[0].split.label
        loop = (out == np.arange(len(out))[:, None]).any(axis=1)
        single = valid & (label < 0)
        seen |= {"single with loop"} if (single & loop).any() else set()
        seen |= {"single without loop"} if (single & ~loop).any() else set()
        seen |= {"loop in subgraph"} if (loop & (label >= 0)).any() else set()
        seen |= {"invalid"} if (~valid & (out >= 0).any(axis=1)).any() else set()
        live = out >= 0
        seen |= {"gap"} if (live[:, :-2] & ~live[:, 1:-1] & live[:, 2:]).any() else set()
        seen |= {"repeat"} if ((out[:, 1:] == out[:, :-1]) & live[:, 1:]).any() else set()
    assert seen == {"single with loop", "single without loop", "loop in subgraph", "invalid",
                    "gap", "repeat"}


def _at(subgraphs, sg) -> int:
    return next(i for i, x in enumerate(subgraphs) if x is sg)


def _planted_chains(rng, subgraphs, n: int):
    """Reads and cycles over a graph of ``n`` nodes: random ones, and
    cycles inside each subgraph so that some subproblems survive."""
    reads = [rng.integers(0, n, size=int(rng.integers(1, 6))).tolist() for _ in range(80)]
    reads.append([])
    cycles = [rng.integers(0, n, size=int(rng.integers(1, 4))).tolist() for _ in range(20)]
    cycles.append([])
    for sg in subgraphs:
        nodes = sorted(sg.nodes)
        reads.append([nodes[0], int(rng.integers(0, n)), nodes[-1]])
        cycles += [[nodes[0], nodes[-1], nodes[0]], [nodes[-1]]]
        if len(nodes) >= 3:  # three cycles that a cover needs, twice
            cycles += [c.tolist() for c in np.array_split(nodes, 3)] * 2
    return reads, cycles


@pytest.mark.parametrize("seed", range(4))
def test_filter_reads_the_labels_as_it_reads_hand_built_subgraphs(seed):
    out, valid = _graph(100 + seed)
    n = len(valid)
    compiled = tord.divide_graph_into_subgraphs(out, valid)
    hand = []
    for sg in tord.divide_graph_into_subgraphs(out, valid):
        h = tord.Subgraph()
        for u, vs in sg.adjacency.items():
            for v in vs:
                h.add_edge(u, v)
        hand.append(h)
    reads, cycles = _planted_chains(np.random.default_rng(seed), hand, n)
    got = tord.filter_subproblems(n, compiled, reads, cycles)
    want = tord.filter_subproblems(n, hand, reads, cycles)
    # the filter took the label array: no subgraph's node set was built
    assert all(sg._nodes is None for sg in compiled)
    assert got, "no subproblem survived"
    assert [(_at(compiled, sg), rr.tolists(), rc) for sg, rr, rc in got] == \
        [(_at(hand, sg), rr.tolists(), rc) for sg, rr, rc in want]
    # a part of the list, or another order, takes the walk over the sets
    part, hand_part = compiled[1:][::-1], hand[1:][::-1]
    got_part = tord.filter_subproblems(n, part, reads, cycles)
    want_part = tord.filter_subproblems(n, hand_part, reads, cycles)
    assert [(_at(part, sg), rr.tolists(), rc) for sg, rr, rc in got_part] == \
        [(_at(hand_part, sg), rr.tolists(), rc) for sg, rr, rc in want_part]


def test_python_route_when_the_library_does_not_load(monkeypatch):
    out, valid = _graph(7)
    compiled, counters = _split(out, valid)
    _python_route(monkeypatch)
    assert tnative.scc_split(out, valid) is None
    fallback, fb_counters = _split(out, valid)
    assert counters["split_compiled_nodes"] > 0 and fb_counters["split_compiled_nodes"] == 0
    assert _shape(compiled) == _shape(fallback)


def test_a_slot_outside_the_table_takes_the_python_route():
    out, valid = _graph(8)
    out[3, 2] = len(valid)
    assert tnative.scc_split(out, valid) is None
    with pytest.raises(IndexError):
        tord.divide_graph_into_subgraphs(out, valid)


@pytest.fixture(scope="module")
def ordering_inputs(tmp_path_factory):
    """The graph, read chains and cycles that ``run_pipeline`` hands to
    ``spacer_ordering_step`` for a planted sample of three arrays."""
    meta = make_metagenome(seed=23, n_arrays=3, n_spacers=7, coverage=40.0)
    tmp = tmp_path_factory.mktemp("split")
    path = str(tmp / "r.fq")
    write_fastq(path, meta["reads"])
    got = []
    orig = tpipeline.spacer_ordering_step

    def spy(graph, reads, cycles, *args, **kwargs):
        got.append((graph, reads, cycles))
        return orig(graph, reads, cycles, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tpipeline, "spacer_ordering_step", spy)
        tpipeline.run_pipeline(Settings(input_files=path, output_file=str(tmp / "o.txt")),
                               verbose=False, device="cpu")
    (inputs,) = got
    return inputs


def _ordering(inputs, condense_min_nodes):
    graph, reads, cycles = inputs
    prof, console = tprof.Profiler(), io.StringIO()
    with prof.stage("spacer_ordering"), contextlib.redirect_stdout(console):
        _g, found = tpipeline.spacer_ordering_step(graph, reads, cycles, verbose=True,
                                                   condense_min_nodes=condense_min_nodes)
    compiled = sum(r["counters"].get("split_compiled_nodes", 0) for r in prof.span_records())
    return found, console.getvalue(), compiled


@pytest.mark.parametrize("condense", [False, True])
def test_ordering_step_finds_the_same_systems_on_both_routes(ordering_inputs, condense,
                                                             monkeypatch):
    threshold = 0 if condense else 10**12
    found, console, compiled = _ordering(ordering_inputs, threshold)
    _python_route(monkeypatch)
    want, want_console, fallback = _ordering(ordering_inputs, threshold)
    assert len(found) == 3 and compiled > 0 and fallback == 0
    assert found == want
    assert console == want_console and "Graph with" in console
    assert ("Region condensed" in console) == condense
