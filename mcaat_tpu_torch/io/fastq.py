"""FASTQ/FASTA ingest.

Replaces the reference's kseqpp-based reader (``src/reads.cpp:3-18``) and
megahit's ``SequenceLibCollection`` binary read library (reference
``src/sdbg_build.cpp:59-115``). Reads are parsed on host, 2-bit encoded,
and packed into a dense padded ``[R, Lmax]`` uint8 matrix ready for device
k-mer extraction — the device-ready equivalent of megahit's packed read
format.

Base encoding: A=0, C=1, G=2, T=3. Any non-ACGT character is encoded as T,
mirroring the reference's lookup coding where "other" maps to the same code
as T (``src/reads.cpp:44-53``: A=1,C=2,G=3,T/other=4).

FASTQ, plain or gzipped, is parsed by the port's own multi-threaded
parser (``mcaat_tpu_torch/native/fastx.cpp``); other inputs by the shared
native C++ extension (``native/``) when it is built, otherwise by a
pure-Python parser.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")

# base -> 2-bit code lookup table; non-ACGT -> 3 (T)
_ENCODE_LUT = np.full(256, 3, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    _ENCODE_LUT[ord(b)] = i
    _ENCODE_LUT[ord(b.lower())] = i


def _is_gzip(path: str) -> bool:
    """True when the file starts with gzip's magic ``1f 8b``, whatever its
    name."""
    try:
        with open(path, "rb") as fh:
            return fh.read(2) == b"\x1f\x8b"
    except OSError:
        return False


def _open_maybe_gzip(path: str):
    if _is_gzip(path):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_sequences(path: str) -> list[str]:
    """Parse FASTA or FASTQ (optionally gzipped) and return sequences.

    Behavioral parity with ``extract_sequences_from_fastq_file``
    (reference ``src/reads.cpp:3-18``): returns the sequence of every
    record, in file order.
    """
    try:
        from mcaat_tpu_torch.native import native_available, parse_fastx

        if native_available():
            return parse_fastx(path)
    except ImportError:
        pass
    return _read_sequences_py(path)


def _read_sequences_py(path: str) -> list[str]:
    try:
        with _open_maybe_gzip(path) as fh:
            return _parse_fastx_handle(fh)
    except Exception as e:  # parity: reference logs and returns what it has
        print(f'Error reading file "{path}" sequences because: {e}')
        return []


def parse_fastx_chunk(chunk: bytes) -> list[str]:
    """Parse FASTA/FASTQ records from an in-memory byte slice that starts
    at a record boundary, with the parser the whole-file path uses (the
    byte-range reader of ``parallel/multihost.py`` calls it, so chunked
    and whole-file parsing cannot diverge)."""
    import io

    if not chunk:
        return []
    return _parse_fastx_handle(io.StringIO(chunk.decode("ascii", errors="replace")))


def _parse_fastx_handle(fh) -> list[str]:
    sequences: list[str] = []
    first = fh.read(1)
    if not first:
        return sequences
    if first == ">":
        # FASTA (possibly multi-line sequences)
        seq_parts: list[str] = []
        fh.readline()  # rest of header
        for line in fh:
            line = line.rstrip("\n\r")
            if line.startswith(">"):
                if seq_parts:
                    sequences.append("".join(seq_parts))
                    seq_parts = []
            elif line:
                seq_parts.append(line)
        if seq_parts:
            sequences.append("".join(seq_parts))
    elif first == "@":
        # FASTQ: 4-line records
        fh.readline()  # rest of header
        while True:
            seq = fh.readline()
            if not seq:
                break
            sequences.append(seq.strip())
            plus = fh.readline()
            qual = fh.readline()
            if not plus or not qual:
                break
            header = fh.readline()
            if not header:
                break
    else:
        raise ValueError(f"Unrecognized FASTA/FASTQ start byte {first!r}")
    return sequences


def reverse_complement(sequence: str) -> str:
    """Reverse complement; non-ACGT characters pass through reversed.

    Parity with ``reverse_pair_ends_sequence`` (reference
    ``src/reads.cpp:20-31``).
    """
    return sequence.translate(_COMP)[::-1]


@dataclass
class ReadBatch:
    """Dense padded 2-bit-coded reads: ``codes[R, Lmax]`` uint8, lengths[R]."""

    codes: np.ndarray  # uint8 [R, Lmax], padded with 0
    lengths: np.ndarray  # int32 [R]

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])


def encode_sequences(
    sequences: Iterable[str], max_len: Optional[int] = None, pad_to_multiple: int = 1
) -> ReadBatch:
    """Encode ASCII sequences into a padded 2-bit-code matrix."""
    seqs = list(sequences)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    if max_len is None:
        max_len = int(lengths.max()) if len(seqs) else 0
    if pad_to_multiple > 1 and max_len % pad_to_multiple:
        max_len += pad_to_multiple - max_len % pad_to_multiple
    codes = np.zeros((len(seqs), max_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)[:max_len]
        codes[i, : len(raw)] = _ENCODE_LUT[raw]
    return ReadBatch(codes=codes, lengths=np.minimum(lengths, max_len))


# the ASCII bytes str.strip() removes
_STRIP = np.zeros(256, dtype=bool)
_STRIP[[9, 10, 11, 12, 13, 28, 29, 30, 31, 32]] = True


def encode_fastx_chunk(chunk: bytes, block_rows: int = 1 << 18) -> ReadBatch:
    """``encode_sequences(parse_fastx_chunk(chunk))`` without a Python
    string a read: for FASTQ the sequence line of every 4-line record is
    cut out of the bytes with numpy, in blocks of ``block_rows`` reads.
    FASTA, and FASTQ whose sequence lines have whitespace at an end or a
    byte past ASCII, go through the string parser, so every chunk gives
    what that parser gives, about four times faster and with no string
    object a read (the string parser's host memory grows by several times
    the chunk)."""
    buf = np.frombuffer(chunk, dtype=np.uint8)
    if buf.size == 0 or buf[0] != ord("@"):
        return encode_sequences(parse_fastx_chunk(chunk))
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [buf.size]])
    if buf[-1] == ord("\n"):  # no line after the last newline
        starts, ends = starts[:-1], ends[:-1]
    s, lengths = starts[1::4], ends[1::4] - starts[1::4]
    live = lengths > 0
    if (_STRIP[buf[s[live]]] | _STRIP[buf[s[live] + lengths[live] - 1]]).any():
        return encode_sequences(parse_fastx_chunk(chunk))
    R = int(s.shape[0])
    L = int(lengths.max()) if R else 0
    codes = np.zeros((R, L), dtype=np.uint8)
    cols = np.arange(L, dtype=np.int64)
    for r0 in range(0, R, block_rows):
        ss, ll = s[r0 : r0 + block_rows], lengths[r0 : r0 + block_rows]
        raw = buf.take(ss[:, None] + cols[None, :], mode="clip")
        # the bytes past a short line belong to the lines after it
        past = cols[None, :] >= ll[:, None] if int(ll.min()) < L else None
        if past is not None:
            raw[past] = ord("A")
        if (raw >= 0x80).any():
            return encode_sequences(parse_fastx_chunk(chunk))
        block = _ENCODE_LUT.take(raw)
        if past is not None:
            block[past] = 0
        codes[r0 : r0 + ss.shape[0]] = block
    return ReadBatch(codes=codes, lengths=lengths.astype(np.int32))


def _is_plain_fastq(path: str) -> bool:
    """True when the file starts with ``@`` (so it is not gzip, whose
    magic is ``1f 8b``, nor FASTA, nor empty)."""
    try:
        with open(path, "rb") as fh:
            return fh.read(1) == b"@"
    except OSError:
        return False


def _parse_plain(path: str) -> Optional[ReadBatch]:
    """The port's multi-threaded parser (``native/fastx.cpp``) for a
    plain FASTQ file; None for any other input or when it is not built."""
    if not _is_plain_fastq(path):
        return None
    from mcaat_tpu_torch.native import parse_plain_fastq

    res = parse_plain_fastq(path)
    return None if res is None else ReadBatch(codes=res[0], lengths=res[1])


def _parse_shared(path: str) -> ReadBatch:
    """The shared native parser (FASTA/FASTQ, gzipped or not), else the
    Python one."""
    try:
        from mcaat_tpu_torch.native import parse_fastx_batch

        res = parse_fastx_batch(path)
        if res is not None:
            codes, lengths = res
            return ReadBatch(codes=codes, lengths=lengths)
    except ImportError:
        pass
    return encode_sequences(_read_sequences_py(path))


def _parse_gzipped(paths: list[str]) -> list[ReadBatch]:
    """The gzipped files ``paths`` parsed together in the span
    ``gzip_parse`` (see :func:`read_encoded_batches`)."""
    from mcaat_tpu_torch.native import parse_gzip_fastq
    from mcaat_tpu_torch.utils.profiling import count, span

    with span("gzip_parse"):
        count(gzip_files=len(paths), gzip_bytes=sum(os.path.getsize(p) for p in paths))
        got = parse_gzip_fastq(paths) or [None] * len(paths)
        count(gzip_fast_files=sum(g is not None for g in got))
        return [_parse_shared(p) if g is None else ReadBatch(codes=g[0], lengths=g[1])
                for p, g in zip(paths, got)]


def read_encoded_batches(paths: list[str]) -> list[ReadBatch]:
    """Parse FASTA/FASTQ(.gz) files into ReadBatches, one a path, in path
    order.

    Plain FASTQ goes through the port's parser, which codes the file on
    every host thread straight into the padded matrix, one file after the
    other. The files that start with gzip's magic ``1f 8b`` are parsed
    first, together: the port's parser inflates them with zlib at once,
    one thread a file, and codes each inflated FASTQ buffer on every
    thread. FASTA and empty files, a gzipped file that does not inflate
    exactly or holds no FASTQ, and every file when that parser is not
    built, go through the shared native parser (no Python string a read),
    else the Python one. Every route
    gives the same codes and lengths. Counts, in the innermost open span,
    ``parse_fast_files`` (the plain files the port's parser took) and
    ``parse_threads`` (its threads), when it took any. The gzipped files'
    parse is one span ``gzip_parse`` under that span, with the counters
    ``gzip_files`` (their count), ``gzip_bytes`` (their sizes on disk,
    summed) and ``gzip_fast_files`` (those the port's parser inflated)."""
    from mcaat_tpu_torch.native import parse_threads
    from mcaat_tpu_torch.utils.profiling import count

    gz = [i for i, p in enumerate(paths) if _is_gzip(p)]
    out = dict(zip(gz, _parse_gzipped([paths[i] for i in gz]))) if gz else {}
    fast = 0
    for i, path in enumerate(paths):
        if i not in out:
            batch = _parse_plain(path)
            fast += batch is not None
            out[i] = batch if batch is not None else _parse_shared(path)
    if fast:
        count(parse_fast_files=fast, parse_threads=parse_threads())
    return [out[i] for i in range(len(paths))]


def read_encoded_batch(path: str) -> ReadBatch:
    """Parse a FASTA/FASTQ(.gz) file directly into a ReadBatch (see
    :func:`read_encoded_batches`)."""
    return read_encoded_batches([path])[0]


def reverse_complement_batch(batch: ReadBatch) -> ReadBatch:
    """Reverse-complement every row of a code matrix (host numpy): each
    row's first ``length`` codes reversed and complemented (``3 - c``,
    modulo 256), zeros past it. The rows of one length go in one
    reversed copy, so a run of untrimmed reads is one copy."""
    codes = batch.codes
    lengths = np.asarray(batch.lengths)
    out = np.zeros_like(codes)
    three = np.uint8(3)
    for n in np.unique(lengths).tolist():
        if n <= 0:
            continue
        rows = lengths == n
        if rows.all():
            block = out[:, :n]
            block[...] = codes[:, n - 1 :: -1]
            np.subtract(three, block, out=block)
        else:
            idx = np.flatnonzero(rows)
            block = codes[idx, n - 1 :: -1]
            np.subtract(three, block, out=block)
            out[idx, :n] = block
    return ReadBatch(codes=out, lengths=batch.lengths.copy())


def decode_kmer(packed: int, k: int) -> str:
    """Decode a 2-bit packed k-mer integer (big-endian base order) to str."""
    chars = []
    for shift in range(2 * (k - 1), -2, -2):
        chars.append("ACGT"[(int(packed) >> shift) & 3])
    return "".join(chars)


def encode_kmer(kmer: str) -> int:
    """Pack a k-mer string into a 2-bit integer (first base = high bits;
    a non-ACGT character codes as T, like the parser)."""
    v = 0
    for ch in kmer:
        v = (v << 2) | {"A": 0, "C": 1, "G": 2, "T": 3}.get(ch.upper(), 3)
    return v
