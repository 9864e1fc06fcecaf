"""The sharded path past one card's ceiling, at test size on the CPU.

``scripts/torch_sharded_past_ceiling.py`` runs planted-20x30 with its
background grown past what one card holds: one process over N cards, N
processes of one card each, a range-by-range count of the node table on
one card and a ``--mesh off`` attempt. Here its rehearsal runs on CPU
shards and gloo processes, its range count is held against the sharded
node table and the JAX package's single-device table, and the byte-range
reader's numpy encoder (``io/fastq.encode_fastx_chunk``, which the
process-group path parses with) against the string parser and the JAX
package's ``read_host_shard``. Tolerance: exact.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcaat_tpu.parallel.multihost as jmh
import mcaat_tpu_torch.parallel.multihost as tmh
from mcaat_tpu.graph.dbg import build_dbg_from_reads as jax_build
from mcaat_tpu_torch.io import fastq as tfastq
from mcaat_tpu_torch.parallel.sharded import kmer_bounds, make_pipeline_mesh
from mcaat_tpu_torch.parallel.sharded_graph import build_sharded_dbg
from tests.synthetic import make_metagenome, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_sharded_past_ceiling.py")


def _script():
    spec = importlib.util.spec_from_file_location("torch_sharded_past_ceiling", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rehearsal_one_process_and_two_gloo_processes(tmp_path):
    """The script on the CPU: one process over a 2-shard mesh
    (``MCAAT_TORCH_SHARDS=2``) and 2 gloo processes give one node table
    (every shard's SHA-1, and ``stats_out``'s digest of the gathered
    k-mer column) and one report; the range count equals the table; the
    ``--mesh off`` run passes at this size with the same report."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    res = subprocess.run(
        [sys.executable, SCRIPT, "200000", "--cards", "2", "--device", "cpu", "--arrays", "2",
         "--json", str(tmp_path / "figures.json")],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "PAST CEILING PASSED" in res.stdout
    assert "equal to run 1's: True" in res.stdout and "report equal: True" in res.stdout
    assert "equal to the sharded table: True" in res.stdout
    assert "--mesh off passed; report equal to the sharded runs': True" in res.stdout
    import json

    fig = json.loads((tmp_path / "figures.json").read_text())
    assert fig["passed"] and fig["single"]["mesh"] == {"dp": 1, "kp": 2}
    assert [g["process"] for g in fig["group"]] == [0, 1]
    assert fig["recovery"]["arrays"] == 2 and fig["recovery"]["spacers"] == 60
    assert fig["single"]["wire"]["build_route"]["bytes"] > 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(seed=7, n_arrays=2, n_spacers=30, background_len=20_000, background_coverage=8.0,
             coverage=35.0),
        dict(seed=3, n_arrays=0, n_spacers=30, background_len=150_000, background_coverage=8.0,
             coverage=35.0),
        dict(seed=1, n_arrays=3, n_spacers=5, background_len=0, background_coverage=8.0,
             coverage=35.0),
    ],
)
def test_bulk_fastq_writer_gives_make_metagenome_bytes(tmp_path, kw):
    """The script's input is ``make_metagenome`` written by ``write_fastq``,
    byte for byte, across the read numbers' digit counts."""
    mod = _script()
    meta = make_metagenome(**kw)
    write_fastq(str(tmp_path / "want.fq"), meta["reads"])
    arrays, n = mod.write_planted_fastq(str(tmp_path / "got.fq"), **kw)
    assert n == len(meta["reads"]) and arrays == meta["arrays"]
    assert (tmp_path / "got.fq").read_bytes() == (tmp_path / "want.fq").read_bytes()


@pytest.mark.parametrize("kp,part_rows", [(2, 10_000), (4, 700), (8, 3_000)])
def test_range_count_equals_the_sharded_node_table(kp, part_rows):
    """``count_range`` over each owner range (in several row parts, so the
    merge stack merges) equals that shard's rows of the port's sharded
    build, and the ranges together equal the JAX package's single-device
    node table."""
    mod = _script()
    meta = make_metagenome(seed=5, n_arrays=1, n_spacers=4, coverage=20.0,
                           background_len=3000, background_coverage=6.0)
    batch = tfastq.encode_sequences(meta["reads"])
    sg = build_sharded_dbg(make_pipeline_mesh([torch.device("cpu")] * kp),
                           batch.codes, batch.lengths, k=23, add_rc=True)
    bounds = kmer_bounds(23, kp)
    got_k, got_m = [], []
    for s in range(kp):
        u, c = mod.count_range(batch.codes, batch.lengths, bounds[s], bounds[s + 1], "cpu",
                               part_rows=part_rows)
        assert torch.equal(u, sg.kmers[s]) and torch.equal(c, sg.mult[s]), s
        got_k.append(u.numpy())
        got_m.append(c.numpy())
    jg = jax_build(batch.codes, batch.lengths, k=23)
    n = int(np.asarray(jg.valid).sum())
    np.testing.assert_array_equal(np.concatenate(got_k), np.asarray(jg.kmers)[:n])
    np.testing.assert_array_equal(np.concatenate(got_m), np.asarray(jg.mult)[:n])


def _fastq_chunks(seed: int, n: int):
    """Byte chunks of FASTQ records: lengths 0-12, bases with N, lower
    case, whitespace at the ends, a chunk cut anywhere, a byte past
    ASCII."""
    rng = np.random.default_rng(seed)
    alphabet = list("ACGTNacgtn \r\t")
    p = [0.2, 0.2, 0.2, 0.2, 0.05, 0.03, 0.03, 0.03, 0.03, 0.01, 0.01, 0.01, 0.0]
    for _ in range(n):
        recs = []
        for i in range(int(rng.integers(0, 6))):
            L = int(rng.integers(0, 12))
            seq = "".join(rng.choice(alphabet, L, p=p))
            recs.append(f"@r{i}\n{seq}\n+\n{'I' * L}\n")
        s = "".join(recs).encode()
        if s and rng.random() < 0.3:
            s = s[: int(rng.integers(1, len(s) + 1))]
        if s and rng.random() < 0.05:
            s = s[:-1] + b"\xc3"
        yield s


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_fastx_chunk_equals_the_string_parser(seed):
    """The numpy chunk encoder gives ``encode_sequences(parse_fastx_chunk)``
    exactly (codes, lengths, dtypes, the empty case), or raises what the
    string parser raises, in blocks of 1-3 rows."""
    for i, chunk in enumerate(_fastq_chunks(seed, 500)):
        try:
            want = tfastq.encode_sequences(tfastq.parse_fastx_chunk(chunk))
        except UnicodeEncodeError:
            with pytest.raises(UnicodeEncodeError):
                tfastq.encode_fastx_chunk(chunk)
            continue
        got = tfastq.encode_fastx_chunk(chunk, block_rows=1 + i % 3)
        assert got.codes.shape == want.codes.shape and got.codes.dtype == want.codes.dtype
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.lengths.dtype == want.lengths.dtype


@pytest.mark.parametrize("n_proc", [2, 3])
def test_fastq_byte_ranges_parse_without_string_objects(tmp_path, monkeypatch, n_proc):
    """``read_host_shard`` on a plain FASTQ encodes its byte range with
    numpy, never through the string parser (which takes several times
    the chunk in host memory and about 6 µs a read), and still equals the
    JAX package's ``read_host_shard``; FASTA keeps the string parser."""
    meta = make_metagenome(seed=41, n_arrays=1, n_spacers=3, coverage=10.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as fh:
        for i, s in enumerate(meta["reads"][:50]):
            fh.write(f">r{i}\n{s[:40]}\n{s[40:]}\n")
    want = [jmh.read_host_shard(fq, p, n_proc) for p in range(n_proc)]
    want_fa = jmh.read_host_shard(fa, 1, n_proc)
    calls = []
    real = tfastq.parse_fastx_chunk
    monkeypatch.setattr(tfastq, "parse_fastx_chunk", lambda c: (calls.append(len(c)), real(c))[1])
    for p in range(n_proc):
        got = tmh.read_host_shard(fq, p, n_proc)
        np.testing.assert_array_equal(got.codes, want[p].codes)
        np.testing.assert_array_equal(got.lengths, want[p].lengths)
    assert calls == []
    got = tmh.read_host_shard(fa, 1, n_proc)
    np.testing.assert_array_equal(got.codes, want_fa.codes)
    assert len(calls) == 1


@pytest.mark.parametrize("field", ["out", "in_"])
def test_tag_adjacency_routes_only_the_present_entries(monkeypatch, field):
    """Found at 698.7M nodes over 2 cards: the tag of a shard's 4N
    adjacency slots sorted all of them with an int64 index, absent ones
    too, and ran out of memory in cycle_search. The route now carries
    only the present entries (``>= 0``), and every tag is what the
    validity says: ``g`` for a valid target, ``-2 - g`` for an invalid
    one, -1 for an absent slot."""
    import mcaat_tpu_torch.parallel.sharded_graph as tsg
    from mcaat_tpu_torch.parallel.exchange import host_replicated

    meta = make_metagenome(seed=9, n_arrays=1, n_spacers=4, coverage=20.0,
                           background_len=4000, background_coverage=6.0)
    batch = tfastq.encode_sequences(meta["reads"])
    sg = build_sharded_dbg(make_pipeline_mesh([torch.device("cpu")] * 4),
                           batch.codes, batch.lengths, k=23, add_rc=True)
    rng = np.random.default_rng(0)
    valid = [torch.as_tensor(rng.random(int(n)) > 0.3) for n in sg.n_live]
    routed = []
    real = tsg.route
    monkeypatch.setattr(tsg, "route", lambda mesh, values, *a, **k: (
        routed.append(sum(int(v.numel()) for v in values)), real(mesh, values, *a, **k))[1])
    adj = getattr(sg, field)
    tagged = tsg.tag_adjacency(sg.mesh, adj, valid, sg.T)
    raw = host_replicated(sg.mesh, adj).astype(np.int64)
    present = raw >= 0
    assert routed == [int(present.sum())] and present.sum() < raw.size
    ok = np.zeros(sg.mesh.kp * sg.T, dtype=bool)
    for s, v in enumerate(valid):
        ok[s * sg.T : s * sg.T + v.numel()] = v.numpy()
    want = np.where(present, np.where(ok[np.maximum(raw, 0)], raw, -2 - raw), -1)
    np.testing.assert_array_equal(host_replicated(sg.mesh, tagged), want)
    assert all(t.dtype == torch.int32 for t in tagged)
