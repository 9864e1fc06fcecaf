"""The chunked (memory-bounded) build of the port against ``mcaat_tpu``
and against the port's own single pass.

Counting in row parts, merging the counted tables in a binary-counter
stack (with parts spilled to the host past the device budget) and
scattering the adjacency in edge chunks must change no table entry:
every comparison is exact integer equality. Mirrors
``tests/test_chunked.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mcaat_tpu.kmer.count as jcount
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu.io.fastq import encode_sequences
import mcaat_tpu_torch.kmer.count as tcount
from mcaat_tpu_torch.graph import dbg as tdbg
from tests.test_torch_graph import CPU, assert_same_graph

FIELDS = ("kmers", "mult", "out", "in_", "valid")


def reads_with_duplicates(seed: int, n: int = 120, lo: int = 15, hi: int = 90):
    """Seeded reads of mixed lengths (some shorter than k); a third of
    them again at the end, so counts above 1 straddle part boundaries."""
    rng = np.random.default_rng(seed)
    seqs = [
        "".join("ACGT"[i] for i in rng.integers(0, 4, size=int(rng.integers(lo, hi))))
        for _ in range(n)
    ]
    return encode_sequences(seqs + seqs[: n // 3] + seqs[5:9])


def t(x):
    return torch.as_tensor(np.asarray(x))


def assert_table(got, want_u, want_c):
    u, c, n = got
    assert n == len(want_u) == int(u.shape[0])
    np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))


def test_merge_counted():
    ua, ca = [2, 5, 9], [1, 2, 3]
    ub, cb = [2, 7, 9], [4, 5, 6]
    u, c, n, ovf = tcount.merge_counted(
        t(np.int64(ua)), t(np.int32(ca)), t(np.int64(ub)), t(np.int32(cb))
    )
    ju, jc, jn, jovf = jcount.merge_counted(
        jnp.array(ua, jnp.int64), jnp.array(ca, jnp.int32),
        jnp.array(ub, jnp.int64), jnp.array(cb, jnp.int32),
    )
    assert n == int(jn) == 4 and ovf == int(jovf) == 0
    assert u.tolist() == np.asarray(ju)[:n].tolist() == [2, 5, 7, 9]
    assert c.tolist() == np.asarray(jc)[:n].tolist() == [5, 2, 5, 9]


def test_merge_counted_overflow_guard():
    """A non-unique input is flagged in both packages."""
    ua, ca = [2, 2, 9], [1, 2, 3]
    ub, cb = [2, 7, 9], [4, 5, 6]
    _u, _c, _n, ovf = tcount.merge_counted(
        t(np.int64(ua)), t(np.int32(ca)), t(np.int64(ub)), t(np.int32(cb))
    )
    *_, jovf = jcount.merge_counted(
        jnp.array(ua, jnp.int64), jnp.array(ca, jnp.int32),
        jnp.array(ub, jnp.int64), jnp.array(cb, jnp.int32),
    )
    assert ovf > 0 and int(jovf) > 0
    with pytest.raises(RuntimeError, match="non-unique"):
        tcount._merge_two(
            tcount._Part(t(np.int64(ua)), t(np.int32(ca)), 0, CPU),
            tcount._Part(t(np.int64(ub)), t(np.int32(cb)), 0, CPU),
        )


@pytest.mark.parametrize("chunk_rows", [1, 37, 1000])
def test_count_unique_chunked_matches(chunk_rows):
    b = reads_with_duplicates(8)
    k = 13
    km = tcount.extract_kmers(t(b.codes), t(b.lengths), k).reshape(-1)
    u_ref, c_ref, _n = tcount.count_unique(km)
    ju, jc, jn = jcount.count_unique_chunked(b.codes, b.lengths, k, chunk_rows=chunk_rows)
    got = tcount.count_unique_chunked(b.codes, b.lengths, k, chunk_rows, device=CPU)
    assert_table(got, u_ref.numpy(), c_ref.numpy())
    assert_table(got, np.asarray(ju)[:jn], np.asarray(jc)[:jn])


@pytest.mark.parametrize("add_rc", [False, True])
@pytest.mark.parametrize("w_cap", [None, 40])
def test_count_edges_chunked_matches(add_rc, w_cap):
    b = reads_with_duplicates(5)
    k = 23
    single = tcount._count_edge_part(t(b.codes), t(b.lengths), k, w_cap, add_rc)
    ju, jc, jn = jcount.count_edges_chunked(
        b.codes, b.lengths, k, chunk_rows=29, w_cap=w_cap, add_rc=add_rc
    )
    got = tcount.count_edges_chunked(
        b.codes, b.lengths, k, chunk_rows=29, w_cap=w_cap, add_rc=add_rc, device=CPU
    )
    assert_table(got, single[0].numpy(), single[1].numpy())
    assert_table(got, np.asarray(ju)[:jn], np.asarray(jc)[:jn])


@pytest.mark.parametrize("add_rc", [False, True])
def test_count_edges_parts_matches(add_rc):
    """Parts of unequal sizes, each uploaded when the count calls its loader."""
    b = reads_with_duplicates(6)
    k, w_cap = 23, 70
    bounds = [(0, 50), (50, 51), (51, 120), (120, b.num_reads)]
    single = tcount._count_edge_part(t(b.codes), t(b.lengths), k, w_cap, add_rc)
    ju, jc, jn = jcount.count_edges_parts(
        [(jnp.asarray(b.codes[lo:hi]), jnp.asarray(b.lengths[lo:hi])) for lo, hi in bounds],
        k, w_cap=w_cap, add_rc=add_rc,
    )
    got = tcount.count_edges_parts(
        [lambda lo=lo, hi=hi: (t(b.codes[lo:hi]), t(b.lengths[lo:hi])) for lo, hi in bounds],
        k, w_cap=w_cap, add_rc=add_rc, verbose=True, device=CPU,
    )
    assert_table(got, single[0].numpy(), single[1].numpy())
    assert_table(got, np.asarray(ju)[:jn], np.asarray(jc)[:jn])


def test_count_kmers_for_reads_matches():
    b = reads_with_duplicates(9)
    ju, jc = jcount.count_kmers_for_reads(b.codes, b.lengths, 23)
    tu, tc = tcount.count_kmers_for_reads(b.codes, b.lengths, 23, device=CPU)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tc, jc)


def count_calls(monkeypatch, module, name: str) -> list:
    """Count the calls of ``module.name`` (looked up at call time)."""
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("add_rc", [False, True])
def test_parted_build_matches_single_pass_and_jax(add_rc, monkeypatch):
    b = reads_with_duplicates(4)
    parts = count_calls(monkeypatch, tcount, "_count_edge_part")
    eps_one, eps_parted, eps_jax = {}, {}, {}
    one = tdbg.build_dbg_from_reads(
        b.codes, b.lengths, add_reverse_complement=add_rc, chunk_windows=0,
        endpoints_out=eps_one, device=CPU,
    )
    assert len(parts) == 1
    parted = tdbg.build_dbg_from_reads(
        b.codes, b.lengths, add_reverse_complement=add_rc, chunk_windows=500,
        endpoints_out=eps_parted, verbose=True, device=CPU,
    )
    assert len(parts) > 4
    jg = jax_build(
        b.codes, b.lengths, k=23, add_reverse_complement=add_rc,
        chunk_windows=500, endpoints_out=eps_jax,
    )
    for f in FIELDS:
        assert torch.equal(getattr(parted, f), getattr(one, f)), f
    assert_same_graph(parted, jg)
    R = b.num_reads
    for key in ("first_km", "last_km"):
        assert torch.equal(eps_parted[key], eps_one[key])
        np.testing.assert_array_equal(eps_parted[key].numpy(), np.asarray(eps_jax[key])[:R])


@pytest.mark.parametrize("chunk_edges", [1, 7, 100])
def test_build_adjacency_chunked_matches_single_shot(chunk_edges, monkeypatch):
    b = reads_with_duplicates(3)
    passes = count_calls(monkeypatch, tdbg, "_adjacency_scatter_chunk")
    ref = tdbg.build_dbg_from_reads(b.codes, b.lengths, device=CPU)
    assert len(passes) == 1
    monkeypatch.setattr(tdbg, "ADJ_SINGLE_SHOT_MAX_EDGES", chunk_edges)
    got = tdbg.build_dbg_from_reads(b.codes, b.lengths, device=CPU)
    n_edges = int((ref.out >= 0).sum())
    assert len(passes) - 1 == -(-n_edges // chunk_edges)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_spill_path(monkeypatch):
    """With no device budget every stacked part goes to the host and is
    uploaded again at its merge; the table is the same."""
    b = reads_with_duplicates(2)
    ref = tdbg.build_dbg_from_reads(b.codes, b.lengths, chunk_windows=0, device=CPU)
    spills = count_calls(monkeypatch, tcount, "_spill")
    monkeypatch.setattr(tcount, "DEVICE_PARTS_BUDGET", 0)
    got = tdbg.build_dbg_from_reads(b.codes, b.lengths, chunk_windows=700, device=CPU)
    assert spills
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_spilled_part_is_a_host_copy():
    u = t(np.int64([1, 4, 8]))
    p = tcount._Part(u, t(np.int32([1, 1, 2])), 0, CPU)
    tcount._spill(p)
    assert p.spilled and p.u.data_ptr() != u.data_ptr()
    assert p.u.tolist() == [1, 4, 8]


def test_pipeline_with_the_budget_forced_low_matches_jax(tmp_path, monkeypatch):
    """The whole pipeline with the window budget forced low (so the graph
    is built in parts) writes the same report as ``mcaat_tpu``."""
    import mcaat_tpu.pipeline as jpipeline
    import mcaat_tpu_torch.pipeline as tpipeline
    from mcaat_tpu.settings import Settings as JSettings
    from mcaat_tpu_torch.settings import Settings
    from tests.synthetic import make_metagenome, write_fastq

    meta = make_metagenome(seed=3, n_arrays=1, n_spacers=8, background_len=3000, coverage=30.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    parts = count_calls(monkeypatch, tcount, "_count_edge_part")
    monkeypatch.setattr(tdbg, "SINGLE_PASS_MAX_WINDOWS", 20_000)
    want = jpipeline.run_pipeline(JSettings(input_files=fq, output_file=str(tmp_path / "j.txt")), verbose=False)
    got = tpipeline.run_pipeline(
        Settings(input_files=fq, output_file=str(tmp_path / "t.txt")), verbose=False, device="cpu"
    )
    assert len(parts) >= 4
    assert "Number of Systems: 1" in got.report_text
    assert got.report_text == want.report_text


@pytest.mark.parametrize("ram,expected", [(None, 1.0), (40.0, 0.5), (0.1, None)])
def test_ram_scales_the_window_budget(ram, expected, monkeypatch):
    """--ram scales the budget against 80 GB, down to a 2M-window floor."""
    import mcaat_tpu_torch.pipeline as tpipeline
    from mcaat_tpu_torch.settings import Settings
    from tests.test_torch_pipeline import DATA

    seen = {}

    def fake_build(codes, lengths, chunk_windows, **kwargs):
        seen["chunk_windows"] = chunk_windows
        raise StopIteration

    monkeypatch.setattr(tpipeline, "build_dbg_from_reads", fake_build)
    s = Settings(input_files=f"{DATA}/golden_reads.fq")
    if ram is not None:
        s.ram, s.ram_explicit = ram, True
    with pytest.raises(StopIteration):
        tpipeline.build_graph_from_settings(s, device=CPU)
    budget = tdbg.SINGLE_PASS_MAX_WINDOWS
    assert seen["chunk_windows"] == (int(budget * expected) if expected else 2_000_000)
