"""The port's parse of gzipped FASTQ (``io/fastq.py::read_encoded_batches``)
against a plain reference parse (Python's ``gzip``, a line split and the
2-bit lookup, in NumPy): N bases, lowercase, ragged lengths, and a file
of two concatenated gzip members (as ``bgzip`` or ``cat a.gz b.gz``
write), and two gzipped files parsed together against each parsed alone.
Then the span ``gzip_parse`` and its counters: one a call around its
gzipped files, under the innermost open span whoever parses, through
``run_pipeline`` on a gzipped pair, and absent on a plain pair, which
keeps ``parse_fast_files``."""

import gzip
import os
import shutil

import numpy as np
import pytest

import mcaat_tpu_torch.io.fastq as tfastq
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu_torch.settings import Settings
from mcaat_tpu_torch.utils import profiling as tprof

DATA = os.path.join(os.path.dirname(__file__), "data")
PE = [os.path.join(DATA, "golden_pe_1.fq"), os.path.join(DATA, "golden_pe_2.fq")]

LUT = np.full(256, 3, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    LUT[_b] = LUT[_b + 32] = _i


def reference_parse(path: str):
    """Codes ``[R, Lmax]`` (0 past a read's end) and lengths of a gzipped
    FASTQ file of 4-line records: the second line of each."""
    with gzip.open(path, "rb") as fh:  # reads every member in turn
        seqs = fh.read().split(b"\n")[1::4]
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    codes = np.zeros((len(seqs), int(lengths.max())), dtype=np.uint8)
    for row, s in enumerate(seqs):
        codes[row, : len(s)] = LUT[np.frombuffer(s, dtype=np.uint8)]
    return codes, lengths


def _reads(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTNacgt"))
    p = [0.24, 0.24, 0.24, 0.24, 0.02, 0.005, 0.005, 0.005, 0.005]
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 160)), p=p)) for _ in range(n)]


def _fastq(reads: list[str]) -> bytes:
    return "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)).encode()


def _write_gz(path, members: list[bytes]) -> str:
    with open(path, "wb") as fh:
        for data in members:
            fh.write(gzip.compress(data, compresslevel=1, mtime=0))
    return str(path)


CASES = {
    "ragged-n-lowercase": [_fastq(_reads(1, 300))],
    "two-members": [_fastq(_reads(2, 200)), _fastq(_reads(3, 250))],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gzip_parse_equals_the_reference(case, tmp_path):
    path = _write_gz(tmp_path / f"{case}.fq.gz", CASES[case])
    batch = tfastq.read_encoded_batch(path)
    codes, lengths = reference_parse(path)
    assert batch.num_reads == sum(m.count(b"\n") for m in CASES[case]) // 4
    assert batch.codes.dtype == np.uint8 and batch.lengths.dtype == np.int32
    np.testing.assert_array_equal(batch.lengths, lengths)
    np.testing.assert_array_equal(batch.codes, codes)


def _gzip_counters(files: list) -> dict:
    """The counters of the span ``gzip_parse`` around the gzipped
    ``files`` parsed in one call: the port's parser takes them all where
    the compiler is there to build it."""
    fast = shutil.which(os.environ.get("CXX", "g++")) is not None
    return {"gzip_files": len(files), "gzip_bytes": sum(os.path.getsize(f) for f in files),
            "gzip_fast_files": len(files) if fast else 0}


def test_gzipped_files_parsed_together_equal_each_parsed_alone(tmp_path):
    """Two gzipped files of one call, a plain one between them: each
    file's batch in path order, equal to its parse alone."""
    paths = [_write_gz(tmp_path / "a.fq.gz", CASES["two-members"]),
             str(tmp_path / "plain.fq"),
             _write_gz(tmp_path / "b.fq.gz", CASES["ragged-n-lowercase"])]
    with open(paths[1], "wb") as fh:
        fh.write(_fastq(_reads(4, 120)))
    together = tfastq.read_encoded_batches(paths)
    for path, batch in zip(paths, together):
        alone = tfastq.read_encoded_batch(path)
        np.testing.assert_array_equal(batch.lengths, alone.lengths)
        np.testing.assert_array_equal(batch.codes, alone.codes)
    for path in (paths[0], paths[2]):
        codes, lengths = reference_parse(path)
        batch = together[paths.index(path)]
        np.testing.assert_array_equal(batch.lengths, lengths)
        np.testing.assert_array_equal(batch.codes, codes)


@pytest.mark.parametrize("stage", ["graph_build", "read_mapping"])
def test_the_span_sits_under_the_open_span_and_counts_the_file(stage, tmp_path):
    """The magic decides, not the name: a gzipped file named ``.fq`` is
    counted, a plain one named ``.gz`` is not. One span a call holds the
    call's gzipped files."""
    gz = _write_gz(tmp_path / "reads.fq", CASES["two-members"])
    plain = tmp_path / "plain.fq.gz"
    plain.write_bytes(CASES["ragged-n-lowercase"][0])
    prof = tprof.Profiler()
    with prof.stage(stage), tprof.span("parse"):
        tfastq.read_encoded_batches([gz, str(plain), gz])
    records = prof.span_records()
    got = [r for r in records if r["name"].endswith("gzip_parse")]
    assert [r["name"] for r in got] == [f"{stage}/parse/gzip_parse"]
    assert got[0]["counters"] == _gzip_counters([gz, gz])
    parse = next(r for r in records if r["name"] == f"{stage}/parse")
    assert "gzip_files" not in parse["counters"]


@pytest.mark.parametrize("kind", ["gz", "plain"])
def test_run_pipeline_spans_of_a_gzipped_and_a_plain_pair(kind, tmp_path):
    from mcaat_tpu_torch.native import umap_order

    if umap_order(["A", "B"]) is None:
        pytest.skip("the golden fixtures pin the native repeat-candidate order; build native/")
    files = PE
    if kind == "gz":
        files = []
        for src in PE:
            with open(src, "rb") as fh:
                files.append(_write_gz(tmp_path / (os.path.basename(src) + ".gz"), [fh.read()]))
    s = Settings(input_files=" ".join(files), output_file=str(tmp_path / "CRISPR_Arrays.txt"))
    result = tpipeline.run_pipeline(s, device="cpu")
    with open(os.path.join(DATA, "golden_pe_CRISPR_Arrays.txt")) as fh:
        assert result.report_text == fh.read()
    records = result.profile.span_records()
    got = [r for r in records if r["name"].endswith("gzip_parse")]
    parse = next(r for r in records if r["name"] == "graph_build/parse")
    fast = shutil.which(os.environ.get("CXX", "g++")) is not None
    if kind == "gz":
        assert [r["name"] for r in got] == ["graph_build/parse/gzip_parse"]
        assert got[0]["counters"] == _gzip_counters(files)
        assert "parse_fast_files" not in parse["counters"]
    else:
        assert got == []
        assert parse["counters"].get("parse_fast_files") == (2 if fast else None)
