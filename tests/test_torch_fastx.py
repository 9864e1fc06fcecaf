"""The port's FASTQ parser (``mcaat_tpu_torch/native/fastx.cpp``) against
the shared native parser (``native.parse_fastx_batch``) and the Python
one, codes and lengths byte for byte: ragged, N, IUPAC, lowercase and
CRLF lines; empty sequence lines, an unterminated last line and a
truncated last record; a quality line that starts with ``@``; one read;
more threads than records or bytes; and two or three threads' byte
ranges cut at every offset of a small file. Every case also gzipped at
levels 1 and 6 and inflated by the parser's zlib; then gzip members (an
empty one, one past the first guess of the size, a header CRC) and what
goes back to the shared route (an empty stream, FASTA, a truncated,
corrupt or garbage-tailed stream). FASTA and empty files take the shared route; the
counters read the files the new route took. Then ``run_cli`` on the pe150
fixture through both routes, with the ordering stage's forked pool after
the new parse."""

import gzip
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

import mcaat_tpu_torch.io.fastq as tfastq
from mcaat_tpu_torch import native as tnative
from mcaat_tpu_torch.utils import profiling as tprof

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX", "g++")) is None, reason="no C++ compiler"
)


def _rec(seq: str, name: str = "r", qual: str | None = None, nl: str = "\n") -> str:
    return f"@{name}{nl}{seq}{nl}+{nl}{qual if qual is not None else 'I' * len(seq)}{nl}"


# name -> (file bytes, the Python parser reads it alike)
CASES = {
    "ragged": ("".join(_rec("ACGT" * k + "A" * (k % 3), f"r{k}") for k in range(12)), True),
    "n-iupac-lower": (_rec("ACGTNNRYKMacgtnswbdhv") + _rec("nnnn") + _rec("GATTACA"), True),
    "crlf": ("".join(_rec(s, nl="\r\n") for s in ("ACGT", "GG", "TTTACG")), True),
    "empty-sequences": (_rec("") + _rec("ACG") + _rec("") + _rec("", qual=""), True),
    "unterminated-quality": (_rec("ACGT") + "@r\nGGCA\n+\nIIII", True),
    "unterminated-sequence": (_rec("ACGT") + "@r\nGGCAT", True),
    "truncated-after-plus": (_rec("ACGT") + "@r\nGGCAT\n+\n", True),
    "truncated-at-header": (_rec("ACGT") + "@r\n", True),
    "header-only": ("@only\n", True),
    "quality-starts-with-at": (_rec("ACGT", qual="@@II") + _rec("TTGA", qual="@III")
                               + _rec("C", qual="@"), True),
    "single-read": (_rec("ACGTACGTTTGCA"), True),
    "one-base": ("@\nA\n+\nI\n", True),
    # an unterminated '\r' stays in the shared parser's line (LineReader
    # drops it only before a '\n'); the Python parser strips it
    "crlf-unterminated-sequence": (_rec("ACGT", nl="\r\n") + "@r\r\nGGCA\r", False),
}
THREADS = [1, 2, 3, 7, 64]
# how a case's file is written: plain, or gzipped at a level
FORMS = ["plain", "gz1", "gz6"]


def _write(tmp_path, name: str, text: str) -> str:
    path = str(tmp_path / f"{name}.fq")
    with open(path, "wb") as fh:
        fh.write(text.encode())
    return path


def _write_gz(tmp_path, name: str, members: list, level: int = 1) -> str:
    """``members`` (bytes each) as one gzip member each, concatenated."""
    path = str(tmp_path / f"{name}.fq.gz")
    with open(path, "wb") as fh:
        for data in members:
            fh.write(gzip.compress(data, compresslevel=level, mtime=0))
    return path


def _parse_gz(path: str, threads=None):
    """``native.parse_gzip_fastq`` on one file: its (codes, lengths) or
    None."""
    (got,) = tnative.parse_gzip_fastq([path], threads)
    return got


def _shared(path: str):
    if tnative.native_available():
        return tnative.parse_fastx_batch(path)
    return None


def _python(path: str):
    b = tfastq.encode_sequences(tfastq._read_sequences_py(path))
    return b.codes, b.lengths


def _equal(got, want):
    assert got[0].dtype == want[0].dtype == np.uint8
    assert got[1].dtype == want[1].dtype == np.int32
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_codes_and_lengths_equal_the_shared_parsers(case, threads, form, tmp_path):
    text, py_alike = CASES[case]
    if form == "plain":
        path = _write(tmp_path, case, text)
        got = tnative.parse_plain_fastq(path, threads=threads)
    else:
        path = _write_gz(tmp_path, case, [text.encode()], level=int(form[2:]))
        got = _parse_gz(path, threads)
    assert got is not None
    shared = _shared(path)
    if shared is not None:
        _equal(got, shared)
    if py_alike:
        _equal(got, _python(path))
    else:
        assert shared is not None
    # the route read_encoded_batch takes gives the same arrays
    b = tfastq.read_encoded_batch(path)
    _equal((b.codes, b.lengths), got)


@pytest.mark.parametrize("ranges", [2, 3])
@pytest.mark.parametrize("case", ["crlf", "empty-sequences", "quality-starts-with-at",
                                  "unterminated-sequence"])
def test_thread_ranges_cut_at_every_byte_offset(case, ranges, tmp_path):
    """Two or three byte ranges whose inner cuts fall on every offset of
    the file, records and lines cut anywhere (empty ranges included)."""
    text, _ = CASES[case]
    text = text * 3
    path = _write(tmp_path, case, text)
    want = _python(path) if _shared(path) is None else _shared(path)
    size = os.path.getsize(path)
    for c in range(size + 1):
        cuts = [0, c, size] if ranges == 2 else [0, c, min(size, c + 5), size]
        got = tnative.parse_plain_fastq(path, threads=len(cuts) - 1, cuts=cuts)
        _equal(got, want)


@pytest.mark.parametrize("cuts", [[0], [1, 9], [0, 8], [0, 10], [0, 6, 3, 9]])
def test_cuts_that_do_not_cover_the_file_are_refused(cuts, tmp_path):
    path = _write(tmp_path, "nine", "@\nACGT\n+\n")  # 9 bytes
    with pytest.raises(ValueError):
        tnative.parse_plain_fastq(path, cuts=cuts)


def test_a_large_ragged_file_over_many_threads(tmp_path):
    """Every byte value in sequences, lengths 0-300, CRLF on some lines,
    over 1-8 threads of equal ranges."""
    rng = np.random.default_rng(16)
    parts = []
    for i in range(3000):
        n = int(rng.integers(0, 301))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTacgtNRY.-*", dtype=np.uint8), n))
        nl = b"\r\n" if i % 7 == 0 else b"\n"
        parts.append(b"@r%d" % i + nl + seq + nl + b"+" + nl + b"I" * n + nl)
    path = str(tmp_path / "big.fq")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    want = _python(path)
    if _shared(path) is not None:
        _equal(_shared(path), want)
    for threads in range(1, 9):
        _equal(tnative.parse_plain_fastq(path, threads=threads), want)


def _other_inputs(tmp_path) -> dict:
    plain = _write(tmp_path, "plain", CASES["ragged"][0])
    gz = str(tmp_path / "reads.fq.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(CASES["ragged"][0].encode())
    fasta = _write(tmp_path, "reads_fa", ">a\nACGT\nGG\n>b\nTTT\n")
    empty = _write(tmp_path, "empty", "")
    return {"plain": plain, "gz": gz, "fasta": fasta, "empty": empty}


@pytest.mark.parametrize("kind", ["gz", "fasta", "empty"])
def test_other_inputs_take_the_shared_route(kind, tmp_path, monkeypatch):
    """FASTA and empty files take the shared route; a gzipped FASTQ file
    now takes the port's parser, through its gzip entry."""
    paths = _other_inputs(tmp_path)
    took, took_gz = [], []
    real, real_gz = tnative.parse_plain_fastq, tnative.parse_gzip_fastq
    monkeypatch.setattr(tnative, "parse_plain_fastq",
                        lambda p, **kw: took.append(p) or real(p, **kw))
    monkeypatch.setattr(tnative, "parse_gzip_fastq",
                        lambda ps, *a, **kw: took_gz.append(list(ps)) or real_gz(ps, *a, **kw))
    prof = tprof.Profiler()
    with prof.stage("s"):
        b = tfastq.read_encoded_batch(paths[kind])
    assert took == []
    assert prof.span_records()[0]["counters"] == {}
    want = _shared(paths[kind]) or _python(paths[kind])
    _equal((b.codes, b.lengths), want)
    if kind == "gz":
        assert took_gz == [[paths["gz"]]]
        (gz,) = [r for r in prof.span_records() if r["name"] == "s/gzip_parse"]
        assert gz["counters"]["gzip_fast_files"] == 1
        _equal((b.codes, b.lengths), tnative.parse_plain_fastq(paths["plain"]))
    else:
        assert took_gz == []


def _crc_header_member(data: bytes, good: bool = True) -> bytes:
    """A gzip member of ``data`` whose header carries FHCRC, the low 16
    bits of the header's CRC-32 (wrong unless ``good``)."""
    head = b"\x1f\x8b\x08\x02" + b"\x00" * 4 + b"\x00\xff"
    crc16 = (zlib.crc32(head) & 0xFFFF) ^ (0 if good else 1)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = co.compress(data) + co.flush()
    return head + struct.pack("<H", crc16) + body + struct.pack("<II", zlib.crc32(data),
                                                                len(data) & 0xFFFFFFFF)


def _flip(data: bytes, at: int) -> bytes:
    return data[:at] + bytes([data[at] ^ 0x55]) + data[at + 1:]


RAGGED = CASES["ragged"][0].encode()
_BASES = np.random.default_rng(22).choice(list("ACGT"), size=(400, 240))
BIG = "".join(_rec("".join(row), f"r{i}") for i, row in enumerate(_BASES)).encode()  # 200 KB
# name -> (the file's bytes, whether the port's parser takes it)
GZ_CASES = {
    "two-members": (gzip.compress(RAGGED, mtime=0)
                    + gzip.compress(CASES["n-iupac-lower"][0].encode(), mtime=0), True),
    "empty-member-first": (gzip.compress(b"", mtime=0) + gzip.compress(RAGGED, mtime=0), True),
    "empty-member-last": (gzip.compress(RAGGED, mtime=0) + gzip.compress(b"", mtime=0), True),
    # the last ISIZE (0) and the compressed size are far below the output
    "past-the-first-guess": (gzip.compress(BIG, mtime=0) * 3 + gzip.compress(b"", mtime=0), True),
    "header-crc": (_crc_header_member(RAGGED), True),
    "header-crc-wrong": (_crc_header_member(RAGGED, good=False), False),
    "empty-stream": (gzip.compress(b"", mtime=0), False),
    "fasta": (gzip.compress(b">a\nACGT\nGG\n>b\nTTT\n", mtime=0), False),
    "truncated": (gzip.compress(BIG, mtime=0)[:-9], False),
    "truncated-in-the-second-member": (gzip.compress(RAGGED, mtime=0)
                                       + gzip.compress(BIG, mtime=0)[:20000], False),
    "corrupt": (_flip(gzip.compress(BIG, mtime=0), 300), False),
    "garbage-after-the-member": (gzip.compress(RAGGED, mtime=0) + b"\x00" * 7, False),
    "magic-after-the-member": (gzip.compress(RAGGED, mtime=0) + b"\x1f\x8b", False),
}


@pytest.mark.parametrize("case", sorted(GZ_CASES))
def test_gzip_members_and_what_goes_back_to_the_shared_route(case, tmp_path):
    """The port's parser takes the files it can inflate exactly and
    leaves every other one to the shared route, which decides what such a
    file gives; ``read_encoded_batch`` gives the shared parser's arrays
    either way. zlib checks a header CRC."""
    data, taken = GZ_CASES[case]
    path = str(tmp_path / f"{case}.fq.gz")
    with open(path, "wb") as fh:
        fh.write(data)
    got = _parse_gz(path)
    want = _shared(path) or _python(path)
    if taken:
        assert got is not None
        _equal(got, want)
        if tnative.native_available():
            with gzip.open(path, "rb") as fh:
                plain = _write(tmp_path, "plain", fh.read().decode())
            _equal(got, tnative.parse_plain_fastq(plain))
    else:
        assert got is None
    b = tfastq.read_encoded_batch(path)
    _equal((b.codes, b.lengths), want)


@pytest.mark.parametrize("threads", [0, 3])
def test_counters_read_the_files_the_new_route_parsed(threads, tmp_path):
    paths = _other_inputs(tmp_path)
    second = _write(tmp_path, "second", CASES["crlf"][0])
    order = [paths["plain"], paths["gz"], second, paths["fasta"], paths["empty"]]
    tnative.set_threads(threads)
    try:
        prof = tprof.Profiler()
        with prof.stage("s"):
            with tprof.span("parse"):
                batches = tfastq.read_encoded_batches(order)
    finally:
        tnative.set_threads(0)
    counters = prof.span_records()[1]["counters"]
    want_threads = threads or len(os.sched_getaffinity(0))
    assert counters == {"parse_fast_files": 2, "parse_threads": want_threads}
    for p, b in zip(order, batches):
        want = _shared(p) or _python(p)
        _equal((b.codes, b.lengths), want)


def test_a_failed_build_keeps_the_shared_route(tmp_path, monkeypatch):
    path = _write(tmp_path, "plain", CASES["n-iupac-lower"][0])
    monkeypatch.setattr(tnative, "_fastx", None)
    monkeypatch.setattr(tnative, "_fastx_tried", True)
    assert tnative.parse_plain_fastq(path) is None
    prof = tprof.Profiler()
    with prof.stage("s"):
        b = tfastq.read_encoded_batch(path)
    assert prof.span_records()[0]["counters"] == {}
    _equal((b.codes, b.lengths), _python(path))


def test_a_compiler_that_fails_is_reported_not_raised(tmp_path, monkeypatch, capsys):
    """A build that fails leaves no library and no partial file behind."""
    src = tmp_path / "fastx.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_ROOT", str(tmp_path))
    assert tnative._build(str(src)) is None
    assert "fastx build failed" in capsys.readouterr().out
    assert os.listdir(tmp_path / "build" / "mcaat_tpu_torch") == []


@pytest.fixture(scope="module")
def pe150_small(tmp_path_factory):
    import torch_fragments as tf

    got = tf.make_named(tf.FIXTURE_INPUT, str(tmp_path_factory.mktemp("pe150")))
    assert got["sha1"] == tf.fixture_sha1()
    return got


@pytest.mark.parametrize("route", ["new", "old"])
def test_run_cli_writes_the_same_report_through_either_route(route, pe150_small, tmp_path,
                                                             monkeypatch):
    """``run_cli`` with ``--threads 2`` on the pe150 fixture: the new
    route parses both mates (counters 2 and 2), then the ordering stage
    forks its pool of 2 and it completes; the old route, patched in,
    writes the same report, the fixture's."""
    from mcaat_tpu_torch import pipeline as tpipeline
    import torch_fragments as tf
    from mcaat_tpu_torch.cli import run_cli

    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MCAAT_ORDERING_PROCS", raising=False)
    if route == "old":
        monkeypatch.setattr(tfastq, "_parse_plain", lambda path: None)
    out = tmp_path / "out"
    try:
        result = run_cli(["--input-files", *pe150_small["files"], "--output-folder", str(out),
                          "--threads", "2"])
    finally:
        tpipeline.configure_threads(0)
    assert (out / "CRISPR_Arrays.txt").read_bytes() == tf.fixture_report()
    records = result.profile.span_records()
    parse = next(r for r in records if r["name"] == "graph_build/parse")
    want = {"parse_fast_files": 2, "parse_threads": 2} if route == "new" else {}
    assert {k: v for k, v in parse["counters"].items() if k != "reads"} == want
    solve = next(r for r in records if r["name"] == "spacer_ordering/solve")
    assert solve["counters"] == {"workers": 2}
