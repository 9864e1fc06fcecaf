"""The direct-call API of the port against mcaat_tpu's, on the CPU:
``map_reads_to_nodes``, ``chains_from_ids``, ``_map_sequences``,
``count_nodes_and_edges``, ``read_sequences``/``parse_fastx``, the
subpackage exports, and the device rule of ``lcs_batch``. Integers,
strings and bytes: every comparison is exact."""

import gzip
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcaat_tpu
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu.io import fastq as jfastq
from mcaat_tpu.kmer import count as jcount
from mcaat_tpu.reads import mapper as jmapper
from mcaat_tpu_torch.graph import dbg as tdbg
from mcaat_tpu_torch.io import fastq as tfastq
from mcaat_tpu_torch.kmer import count as tcount
from mcaat_tpu_torch.reads import mapper as tmapper
from mcaat_tpu_torch.report import batched_fuzz as tfuzz
from mcaat_tpu_torch.report import lcs_cuda
from tests.test_torch_graph import CPU, rand_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs_and_queries(seed=17):
    """Graphs of both packages over one read set, and a query batch of
    reads from it, mutated reads, reads shorter than k and an empty one."""
    rng = np.random.default_rng(seed)
    reads = rand_reads(seed, n=30, lo=60, hi=90)
    batch = jfastq.encode_sequences(reads)
    jg = jax_build(batch.codes, batch.lengths, k=23)
    tg = tdbg.build_dbg_from_reads(batch.codes, batch.lengths, k=23, device=CPU)
    queries = list(reads[:12])
    for s in reads[12:18]:
        i = int(rng.integers(5, len(s) - 5))
        queries.append(s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1 :])
    queries += [reads[0][:30], reads[1][:23], reads[2][:10], "", jfastq.reverse_complement(reads[3])]
    return jg, tg, queries


def test_map_reads_to_nodes_matches_jax():
    jg, tg, queries = _graphs_and_queries()
    jb, tb = jfastq.encode_sequences(queries), tfastq.encode_sequences(queries)
    j_ids, j_nw = jmapper.map_reads_to_nodes(jg, jb)
    t_ids, t_nw = tmapper.map_reads_to_nodes(tg, tb)
    assert isinstance(t_ids, np.ndarray) and t_ids.dtype == np.int32 and t_nw.dtype == np.int32
    np.testing.assert_array_equal(t_nw, j_nw)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert (t_ids[:12, 0] >= 0).all() and (t_ids == -1).any()
    # every window of a read of the build hits, and equals graph.lookup
    for r in range(12):
        assert (t_ids[r, : t_nw[r]] >= 0).all()
    km = tcount.extract_kmers(torch.as_tensor(tb.codes), torch.as_tensor(tb.lengths), 23)
    np.testing.assert_array_equal(tg.lookup(km.reshape(-1)).reshape(km.shape).numpy(), t_ids)


@pytest.mark.parametrize("queries", [[], ["ACGT", "AC"]], ids=["no reads", "all below k"])
def test_map_reads_to_nodes_without_windows(queries):
    jg, tg, _q = _graphs_and_queries()
    j = jmapper.map_reads_to_nodes(jg, jfastq.encode_sequences(queries))
    t = tmapper.map_reads_to_nodes(tg, tfastq.encode_sequences(queries))
    for a, b in zip(t, j):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_chains_from_ids_and_map_sequences_match_jax():
    jg, tg, queries = _graphs_and_queries()
    jb, tb = jfastq.encode_sequences(queries), tfastq.encode_sequences(queries)
    j_ids, j_nw = jmapper.map_reads_to_nodes(jg, jb)
    t_ids, t_nw = tmapper.map_reads_to_nodes(tg, tb)
    # cycle nodes: the first window of some reads, the last of others
    cyc = {int(t_ids[0, 0]), int(t_ids[5, t_nw[5] - 1]), int(t_ids[13, 0]), 10**9}
    jc = jmapper.chains_from_ids(j_ids, j_nw, jb.lengths, 23, cyc)
    tc = tmapper.chains_from_ids(t_ids, t_nw, tb.lengths, 23, cyc)
    np.testing.assert_array_equal(tc.flat, jc.flat)
    np.testing.assert_array_equal(tc.offsets, jc.offsets)
    assert len(tc) >= 3
    # _map_sequences decides keep from the endpoint k-mers and maps the kept
    # reads alone: the same chains
    cyc_in = {c for c in cyc if c < tg.size}
    jm = jmapper._map_sequences(jg, queries, cyc_in)
    tm = tmapper._map_sequences(tg, queries, cyc_in)
    np.testing.assert_array_equal(tm.flat, jm.flat)
    np.testing.assert_array_equal(tm.offsets, jm.offsets)
    np.testing.assert_array_equal(tm.flat, tc.flat)
    assert len(tmapper._map_sequences(tg, [], cyc_in)) == 0
    assert len(tmapper.chains_from_ids(t_ids[:0], t_nw[:0], tb.lengths[:0], 23, cyc)) == 0


def test_count_nodes_and_edges_matches_two_pass_and_jax():
    """Derived node multiset (prefix-of-edge + last window) == direct
    count. Covers len<k (no windows), len==k (one k-window, no edges),
    len==k+1."""
    rng = np.random.default_rng(7)
    k = 5
    lens = [3, k, k + 1, 9, 30, 17, k, 12, 25, 30]
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in lens]
    b = tfastq.encode_sequences(seqs)
    codes, lengths = torch.as_tensor(b.codes), torch.as_tensor(b.lengths)
    u_ref, c_ref, n_ref = tcount.count_unique(tcount.extract_kmers(codes, lengths, k).reshape(-1))
    km1 = tcount.extract_kmers(codes, lengths, k + 1).reshape(-1)
    u1_ref, _c, n1_ref = tcount.count_unique(km1)
    u, c, n, u1, n1 = tcount.count_nodes_and_edges(codes, lengths, k)
    assert (n, n1) == (n_ref, n1_ref)
    assert torch.equal(u, u_ref) and torch.equal(c, c_ref) and torch.equal(u1, u1_ref)
    ju, jc, jn, ju1, jn1 = jcount.count_nodes_and_edges(jnp.asarray(b.codes), jnp.asarray(b.lengths), k)
    assert (int(jn), int(jn1)) == (n, n1)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju)[:n])
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc)[:n])
    np.testing.assert_array_equal(u1.numpy(), np.asarray(ju1)[:n1])
    last = tcount.extract_last_kmer(codes, lengths, k)
    np.testing.assert_array_equal(
        tcount.node_multiset_from_edges(km1, last).numpy(),
        np.asarray(jcount.node_multiset_from_edges(jnp.asarray(km1.numpy()), jnp.asarray(last.numpy()))),
    )


def _fastx_files(tmp_path) -> dict:
    files = {
        "fastq": ("r.fq", "@r1\nACGT\n+\nIIII\n@r2\nGGCCTT\n+\nIIIIII\n"),
        "fasta multi-line": ("r.fa", ">r1\nACGT\nTTAA\n>r2\nGGCC\n"),
        "non-ACGT": ("n.fq", "@r1\nANGT\n+\nIIII\n"),
        "lower case": ("l.fa", ">r1\nacgtAC\n"),
    }
    paths = {}
    for name, (fname, text) in files.items():
        p = tmp_path / fname
        p.write_text(text)
        paths[name] = str(p)
    gz = tmp_path / "r.fq.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write("@r1\nACGTACGT\n+\nIIIIIIII\n")
    paths["gzip"] = str(gz)
    return paths


WANT = {
    "fastq": ["ACGT", "GGCCTT"],
    "fasta multi-line": ["ACGTTTAA", "GGCC"],
    "gzip": ["ACGTACGT"],
}


@pytest.mark.parametrize("case", ["fastq", "fasta multi-line", "gzip", "non-ACGT", "lower case"])
def test_read_sequences_and_parse_fastx_match_jax(case, tmp_path):
    from mcaat_tpu import native as jnative
    from mcaat_tpu_torch import native as tnative

    path = _fastx_files(tmp_path)[case]
    got = tfastq.read_sequences(path)
    assert got == jfastq.read_sequences(path)
    if case in WANT:
        assert got == WANT[case]
    assert tfastq._read_sequences_py(path) == jfastq._read_sequences_py(path)
    assert tnative.native_available() == jnative.native_available()
    if not tnative.native_available():
        with pytest.raises(ImportError):
            tnative.parse_fastx(path)
        return
    assert tnative.parse_fastx(path) == jnative.parse_fastx(path) == got
    if case == "non-ACGT":
        assert got == ["ATGT"]  # the native parser codes other characters as T
    codes, lengths = tnative.parse_fastx_batch(path)
    b = tfastq.read_encoded_batch(path)
    np.testing.assert_array_equal(b.codes, codes)
    assert [len(s) for s in got] == list(lengths)


def test_read_sequences_without_the_native_library(tmp_path, monkeypatch):
    from mcaat_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert tnative.native_available() is False
    paths = _fastx_files(tmp_path)
    for case, want in WANT.items():
        assert tfastq.read_sequences(paths[case]) == want
    assert tfastq.read_sequences(paths["non-ACGT"]) == ["ANGT"]  # the Python parser keeps it
    with pytest.raises(ImportError):
        tnative.parse_fastx(paths["fastq"])


# Names in an ``__all__`` of mcaat_tpu that the port leaves out on purpose.
NOT_PORTED = {
    # the JAX package's remote-TPU set-up (JAX_PLATFORMS against a forced
    # platform); the port's device is explicit (mcaat_tpu_torch.resolve_device)
    ("utils", "honor_cpu_env"),
}


def _jax_exports():
    for m in pkgutil.walk_packages(mcaat_tpu.__path__, "mcaat_tpu."):
        if not m.ispkg:
            continue
        mod = importlib.import_module(m.name)
        for name in getattr(mod, "__all__", []):
            yield m.name[len("mcaat_tpu."):], name


def test_every_export_of_the_jax_package_imports_from_the_port():
    exports = sorted(_jax_exports())
    assert len(exports) >= 40 and {sub for sub, _n in exports} >= {
        "io", "reads", "graph", "kmer", "cycles", "prune", "ordering", "report", "systems",
        "parallel", "utils",
    }
    for sub, name in exports:
        jmod = importlib.import_module(f"mcaat_tpu.{sub}")
        tmod = importlib.import_module(f"mcaat_tpu_torch.{sub}")
        if (sub, name) in NOT_PORTED:
            assert name not in tmod.__all__ and not hasattr(tmod, name)
            continue
        obj = getattr(tmod, name)
        assert name in tmod.__all__, (sub, name)
        assert type(obj) is type(getattr(jmod, name)) or callable(obj), (sub, name)
        mod_name = getattr(obj, "__module__", None)
        assert mod_name is None or mod_name.startswith("mcaat_tpu_torch"), (sub, name, mod_name)
    for sub in {sub for sub, _n in exports}:
        want = {n for s, n in exports if s == sub and (s, n) not in NOT_PORTED}
        assert set(importlib.import_module(f"mcaat_tpu_torch.{sub}").__all__) == want, sub


def test_importing_the_exports_builds_no_kernel_and_no_jax():
    code = (
        "import sys, os\n"
        "import mcaat_tpu_torch.report.lcs_cuda as lc\n"
        "from mcaat_tpu_torch.io import read_sequences, encode_sequences, reverse_complement, ReadBatch\n"
        "from mcaat_tpu_torch.reads import get_reads, map_reads_to_nodes\n"
        "from mcaat_tpu_torch.graph import DBG, build_dbg, build_dbg_from_reads\n"
        "from mcaat_tpu_torch.kmer import extract_kmers, count_unique, count_kmers_for_reads\n"
        "from mcaat_tpu_torch.cycles import CycleFinder, find_cycles, select_start_nodes\n"
        "from mcaat_tpu_torch.prune import prune_graph\n"
        "from mcaat_tpu_torch.ordering import order_cycles\n"
        "from mcaat_tpu_torch.report import CRISPRAnalyzer, ratio, partial_ratio\n"
        "from mcaat_tpu_torch.systems import get_systems\n"
        "from mcaat_tpu_torch.parallel import make_pipeline_mesh\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'mcaat_tpu', 'triton'))\n"
        "print(bad, lc._lib, lc.BUILD_INFO)\n"
        "sys.exit(1 if bad or lc._lib is not None or lc.BUILD_INFO else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _lcs_inputs(n=40, seed=3):
    rng = np.random.default_rng(seed)
    strings = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(0, 65)))) for _ in range(2 * n)]
    a_c, a_l = tfuzz.encode_batch(strings[:n])
    b_c, b_l = tfuzz.encode_batch(strings[n:])
    return strings, [torch.as_tensor(x) for x in (a_c, a_l, b_c, b_l)]


def test_lcs_batch_dispatch():
    """A CPU tensor takes the plain version (no launch); a tensor on
    another device than the CPU or a card raises."""
    from mcaat_tpu.report.fuzz import lcs_length

    strings, t_in = _lcs_inputs()
    before = lcs_cuda.launch_counts()
    got = tfuzz.lcs_batch(*t_in)
    assert lcs_cuda.launch_counts() == before
    assert got.dtype == torch.int32
    assert torch.equal(got, tfuzz.lcs_batch_plain(*t_in))
    assert torch.equal(got, tfuzz.lcs_ratio_plain(*t_in)[0])
    n = len(strings) // 2
    assert got.tolist() == [lcs_length(strings[i], strings[n + i]) for i in range(n)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfuzz.lcs_batch(*(t.to("meta") for t in t_in))


@pytest.mark.cuda
def test_lcs_batch_launches_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LCS kernel has no CPU mode")
    _strings, t_in = _lcs_inputs(n=4097)
    on_card = [t.cuda() for t in t_in]
    before = lcs_cuda.LAUNCHES
    got = tfuzz.lcs_batch(*on_card)
    assert lcs_cuda.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), tfuzz.lcs_batch_plain(*t_in))
    assert torch.equal(got, tfuzz.lcs_batch_plain(*on_card))
