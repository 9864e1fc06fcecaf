"""The port's sharded pipeline (8 CPU shards) against the JAX package's
(8 virtual CPU devices) and against both single-device runs.

The cases mirror ``tests/test_sharded_pipeline.py``. Where the JAX case
is marked ``slow`` the JAX side is not run here: the port's sharded run
is held against the port's own single-device run (itself held to the JAX
package by ``tests/test_torch_pipeline.py``) and against the committed
golden reports. Tolerance: exact (reports byte for byte; node ids through
their k-mers).
"""

import os

import numpy as np
import pytest
import torch

import mcaat_tpu.cycles.finder as jfinder
import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.cycles.finder as tfinder
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.io.fastq import encode_sequences
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.parallel.exchange import host_replicated
from mcaat_tpu_torch.parallel.sharded_pipeline import (
    HostBitset,
    build_sharded_graph_for_pipeline,
    sharded_find_cycles,
    sharded_get_reads,
)
from mcaat_tpu_torch.settings import Settings
from mcaat_tpu_torch.utils import wire
from tests.synthetic import make_metagenome, write_fastq
from tests.torch_sharded_util import compact_ids, jax_layout
from tests.test_torch_pipeline import DATA, FIXTURES, _require_native_umap


@pytest.fixture(autouse=True)
def eight_cpu_shards(monkeypatch):
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "8")


def _run(tmp_path, meta, mesh, name):
    f1 = tmp_path / f"{name}.fq"
    write_fastq(str(f1), meta["reads"])
    s = Settings(input_files=str(f1), mesh=mesh, output_file=str(tmp_path / f"report_{name}.txt"))
    return tpipeline.run_pipeline(s, verbose=False, device="cpu")


def _same_systems(a, b):
    assert len(a.found_systems) == len(b.found_systems)
    for x, y in zip(a.found_systems, b.found_systems):
        assert x.full_sequence == y.full_sequence
        assert x.repeat == y.repeat
        assert x.spacers == y.spacers
        assert x.confidence_cycle_resolution == y.confidence_cycle_resolution
        assert x.confidence_topological_sort == y.confidence_topological_sort


def test_sharded_pipeline_matches_single_device(tmp_path):
    meta = make_metagenome(seed=11, n_arrays=1, n_spacers=6, coverage=40.0)
    res_single = _run(tmp_path, meta, "off", "single")
    wire.reset()
    res_sharded = _run(tmp_path, meta, "auto", "sharded")
    assert tpipeline._sharded_mode(Settings(), torch.device("cpu"))
    assert wire.snapshot()["build_route"]["bytes"] > 0  # the sharded path ran
    assert res_sharded.report_text == res_single.report_text
    assert "Number of Systems: 1" in res_sharded.report_text
    _same_systems(res_sharded, res_single)
    # same cycle structure (ids differ by layout; compare counts + lengths)
    assert sorted(len(c) for c in res_sharded.cycles) == sorted(len(c) for c in res_single.cycles)
    assert len(res_sharded.reads) == len(res_single.reads)


def test_sharded_pipeline_two_arrays(tmp_path):
    meta = make_metagenome(seed=23, n_arrays=2, n_spacers=5, coverage=40.0)
    res_single = _run(tmp_path, meta, "off", "single2")
    res_sharded = _run(tmp_path, meta, "auto", "sharded2")
    assert res_sharded.report_text == res_single.report_text
    _same_systems(res_sharded, res_single)
    assert len(res_sharded.found_systems) == 2


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_sharded_golden_report_byte_identical(name, tmp_path):
    """The four golden fixtures on 8 shards: the single-device report,
    which is the committed one."""
    _require_native_umap()
    files = " ".join(os.path.join(DATA, f) for f in FIXTURES[name].split())
    s = Settings(input_files=files, output_file=str(tmp_path / "CRISPR_Arrays.txt"))
    wire.reset()
    result = tpipeline.run_pipeline(s, verbose=False, device="cpu")
    assert wire.snapshot()["tag_adjacency"]["calls"] >= 2
    with open(os.path.join(DATA, f"{name}_CRISPR_Arrays.txt")) as fh:
        expected = fh.read()
    assert result.report_text == expected
    assert (tmp_path / "CRISPR_Arrays.txt").read_text() == expected


def test_sharded_cycles_match_kmers():
    """Cycle node ids from the port's sharded search name the same k-mers
    as the JAX package's sharded search and as both single-device
    searches (ids are layout-local; k-mer labels are not)."""
    from mcaat_tpu.cycles.finder import find_cycles as jfind
    from mcaat_tpu.graph.dbg import build_dbg_from_reads as jbuild
    from mcaat_tpu.parallel import sharded_pipeline as jsp
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads

    meta = make_metagenome(seed=5, n_arrays=1, n_spacers=5, coverage=40.0)
    batch = encode_sequences(meta["reads"])

    def labelled(results, km):
        return sorted(
            tuple(int(km[v]) for v in cyc) for cycles in results.values() for cyc in cycles
        )

    sj = jsp.build_sharded_graph_for_pipeline(batch.codes, batch.lengths, JSettings())
    _v, res_j = jsp.sharded_find_cycles(sj, verbose=False)
    want = labelled(res_j, np.asarray(sj.kmers).reshape(-1))
    gj = jbuild(batch.codes, batch.lengths, k=23)
    _g, res_js = jfind(gj, verbose=False)
    assert want == labelled(res_js, np.asarray(gj.kmers)) and want

    st = build_sharded_graph_for_pipeline(batch.codes, batch.lengths, Settings())
    tvalid, res_t = sharded_find_cycles(st, verbose=False)
    km_t = st.to_single_device()[0]
    assert labelled(res_t, km_t) == want
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23, device="cpu")
    _g2, res_ts = tfinder.find_cycles(g, verbose=False)
    assert labelled(res_ts, g.kmers.numpy()) == want
    # the start nodes and the pruned validity agree with the JAX package's
    Tj, n_live = jax_layout(sj)
    assert sorted(compact_ids(list(res_t), st.T, st.n_live)) == sorted(
        compact_ids(list(res_j), Tj, n_live)
    )
    from tests.torch_sharded_util import jax_live_rows

    np.testing.assert_array_equal(host_replicated(st.mesh, tvalid), jax_live_rows(sj, _v))


def test_sharded_read_mapping_skewed_input(tmp_path):
    """Low-complexity reads route every window to one kp shard: with
    exact-length buckets the lookup takes the skew as it comes, and the
    chains equal the JAX package's (which retries with doubled capacity)
    and the single-device mapper's."""
    from mcaat_tpu.parallel import sharded_pipeline as jsp
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads
    from mcaat_tpu_torch.reads.mapper import get_reads

    # all-A reads: every 23-mer is AAAA... -> one owner shard
    reads = ["A" * 60] * 64 + ["ACGT" * 15] * 64
    fq = tmp_path / "skew.fq"
    write_fastq(str(fq), reads)
    batch = encode_sequences(reads)

    def to_kmers(chains, km):
        return sorted(tuple(int(km[v]) if v >= 0 else -1 for v in ch) for ch in chains)

    sj = jsp.build_sharded_graph_for_pipeline(batch.codes, batch.lengths, JSettings())
    km_j = np.asarray(sj.kmers).reshape(-1)
    live_j = np.nonzero(km_j != np.iinfo(np.int64).max)[0]
    want = to_kmers(jsp.sharded_get_reads(sj, str(fq), None, [live_j.tolist()]), km_j)

    st = build_sharded_graph_for_pipeline(batch.codes, batch.lengths, Settings())
    km_t, _m, _o, valid_t, _i = st.to_single_device()
    wire.reset()
    # every node a "cycle node", so every read is kept
    chains = sharded_get_reads(st, str(fq), None, [np.nonzero(valid_t)[0].tolist()])
    assert len(chains) == 128
    assert to_kmers(chains, km_t) == want
    assert wire.snapshot()["read_lookup"]["calls"] == 2  # there and back
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23, device="cpu")
    chains_si = get_reads(g, str(fq), None, [list(range(g.size))])
    assert to_kmers(chains_si, g.kmers.numpy()) == want


def test_sharded_checkpoint_kill_and_resume(tmp_path, monkeypatch):
    """Sharded-path checkpoint and resume: the graph persists PER SHARD
    (no single-device compaction), a simulated crash after the cycle
    stage resumes from graph_sharded/ + cycles.json and reproduces the
    report, which is the JAX package's; a run on another kp rebuilds."""
    from mcaat_tpu_torch import checkpoint as ckpt
    from mcaat_tpu_torch.parallel.sharded import make_pipeline_mesh

    meta = make_metagenome(seed=23, n_arrays=1, n_spacers=4, coverage=35.0)
    f = tmp_path / "r.fq"
    write_fastq(str(f), meta["reads"])
    ck = str(tmp_path / "ck")
    want = jpipeline._run_pipeline_sharded(
        JSettings(input_files=str(f), output_file=str(tmp_path / "j.txt")), verbose=False,
        checkpoint_dir=str(tmp_path / "ck_jax"),
    )

    def run(name):
        s = Settings(input_files=str(f), output_file=str(tmp_path / name))
        return tpipeline._run_pipeline_sharded(s, verbose=False, checkpoint_dir=ck, device="cpu")

    r1 = run("a.txt")
    assert r1.report_text and r1.report_text == want.report_text
    for name in ("graph_sharded/meta.json", "cycles.json", "valid_pruned/meta.json", "reads.json"):
        assert os.path.exists(os.path.join(ck, name)), name
    assert not [n for n in os.listdir(os.path.join(ck, "graph_sharded")) if n.endswith(".tmp")]

    # the persisted graph round-trips bit-exactly per shard
    sg2 = ckpt.load_sharded_graph(os.path.join(ck, "graph_sharded"), make_pipeline_mesh())
    assert sg2.shard_capacity > 0 and len(sg2.n_live) == 8
    sg1 = build_sharded_graph_for_pipeline(*_codes(meta), Settings())
    for field in ("kmers", "mult", "out", "in_", "valid"):
        for a, b in zip(getattr(sg1, field), getattr(sg2, field)):
            assert torch.equal(a, b) and a.dtype == b.dtype, field

    # simulated crash after the cycle stage: the reads artifact is gone
    os.remove(os.path.join(ck, "reads.json"))
    r2 = run("b.txt")
    assert r2.report_text == r1.report_text
    assert len(r2.reads) == len(r1.reads)
    assert r2.cycles == r1.cycles
    ran = lambda r: {s.name for s in r.profile.stages if s.seconds > 0}
    assert not ran(r2) & {"graph_build", "cycle_search"} and "read_mapping" in ran(r2)
    # full resume (everything checkpointed) also reproduces the report
    r3 = run("c.txt")
    assert r3.report_text == r1.report_text
    assert "read_mapping" not in ran(r3)
    # another kp: the graph is built again and the stale ids are dropped
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "2")
    r4 = run("d.txt")
    assert r4.report_text == r1.report_text
    assert {"graph_build", "cycle_search", "read_mapping"} <= ran(r4)
    assert sorted(os.listdir(os.path.join(ck, "graph_sharded"))) == [
        "meta.json", "shard_0000.npz", "shard_0001.npz",
    ]


def _codes(meta):
    b = encode_sequences(meta["reads"])
    return b.codes, b.lengths


def test_sharded_lazy_path_matches_single_device(tmp_path, monkeypatch):
    """At >= LAZY_CLIP_MIN_NODES the sharded pipeline defers the tip clip
    (no chain collapse, no O(N) collective) and maps region-first; with
    the thresholds forced low, the port's sharded lazy run equals its
    single-device run and the JAX package's sharded lazy run."""
    for mod in (jfinder, tfinder):
        monkeypatch.setattr(mod, "LAZY_CLIP_MIN_NODES", 1)
        # keep the invariant LAZY >= NEIGHBORHOOD intact
        monkeypatch.setattr(mod, "NEIGHBORHOOD_MIN_NODES", 1)
    meta = make_metagenome(seed=41, n_arrays=2, n_spacers=5, coverage=40.0)
    res_single = _run(tmp_path, meta, "off", "lazy_single")
    wire.reset()
    res_sharded = _run(tmp_path, meta, "auto", "lazy_sharded")
    snap = wire.snapshot()
    assert "chain_collapse" not in snap and "region_table" in snap and "read_lookup" not in snap
    assert res_sharded.report_text == res_single.report_text
    _same_systems(res_sharded, res_single)
    want = jpipeline.run_pipeline(
        JSettings(
            input_files=str(tmp_path / "lazy_sharded.fq"), output_file=str(tmp_path / "j.txt")
        ),
        verbose=False,
    )
    assert res_sharded.report_text == want.report_text
    assert len(res_sharded.found_systems) == 2


def test_sharded_candidate_ids_matches_mask():
    """The per-shard two-stage candidate scan equals the JAX package's
    and the full-graph candidate mask (same predicate)."""
    import mcaat_tpu.parallel.sharded_graph as jsg
    import mcaat_tpu_torch.parallel.sharded_graph as tsg
    from mcaat_tpu.parallel import sharded_pipeline as jsp

    meta = make_metagenome(seed=7, n_arrays=1, n_spacers=4, coverage=35.0)
    codes, lengths = _codes(meta)
    sj = jsp.build_sharded_graph_for_pipeline(codes, lengths, JSettings())
    jvalid0 = jsg._vmult_filter(sj.valid, sj.mult)
    joutv, jinv = jsg.tagged_adjacency(sj, jvalid0)
    st = build_sharded_graph_for_pipeline(codes, lengths, Settings())
    tvalid0 = [v & (m > 1) for v, m in zip(st.valid, st.mult)]
    toutv, tinv = tsg.tagged_adjacency(st, tvalid0)
    assert tsg.tagged_adjacency(st, tvalid0)[0] is toutv  # cached for the epoch
    Tj, n_live = jax_layout(sj)
    for thr in (0, 20):
        want = jsg.sharded_candidate_ids(sj, jvalid0, joutv, jinv, thr)
        got = tsg.sharded_candidate_ids(st, tvalid0, toutv, tinv, thr)
        assert len(got) > 0 and (np.diff(got) > 0).all()
        np.testing.assert_array_equal(
            compact_ids(got, st.T, st.n_live), compact_ids(want, Tj, n_live)
        )
    tsg.release_tags(st)
    assert tsg.tagged_adjacency(st, tvalid0)[0] is not toutv


def test_host_bitset():
    rng = np.random.default_rng(0)
    idx = np.unique(rng.integers(0, 1000, size=200))
    b = HostBitset(1000)
    b.set(idx[:100])
    b.set(idx[50:])
    np.testing.assert_array_equal(b.to_indices(), idx)
    probe = np.arange(1000)
    np.testing.assert_array_equal(b.test(probe), np.isin(probe, idx))
    assert b.bits.nbytes == 125
