"""The benchmark's traffic generator: a metagenome as Illumina sequences it,
2x150-bp fragment pairs with trimmed lengths, N bases and substitutions
that rise towards the 3' end, from CRISPR arrays of varied repeat, spacer
and array lengths, written as two FASTQ files.

A frozen copy of ``tests/torch_fragments.py`` (``make_fragments``,
``write_input``) and ``tests/torch_reads.py`` (``write_fastq_matrix``) at
commit 9d644f4, so that later edits there cannot move the benchmark's
inputs. With ``shape_seed`` unset it writes the same bytes as the
original for the same parameters (``benchmark/tests`` checks it on
``mixed-pe150-small``). The additions are ``shape_seed`` and the read
shape's parameters (``insert_mean``, ``insert_sd``, ``trim_share``,
``short_share``), which default to the original's constants:

- **shape_seed unset**: every draw comes from ``default_rng(seed)``, as in
  the original: each array's spacer count, repeat length, spacer lengths
  and bases, then the background, the fragments, the trimming and the
  errors.
- **shape_seed set**: the arrays' shapes (spacer count, repeat length and
  every spacer's length) are those the original draws at ``seed =
  shape_seed``; ``default_rng(seed)`` then shuffles which array takes
  which shape and draws everything else (bases, flanks, background,
  fragments, trimming, errors). Every seed so gets the same set of array
  sizes in another order, and the work of a sample moves little from seed
  to seed.

Steps (from the original's docstring): arrays of 23-47-base repeats and
spacers of a base length on 26-44 with a jitter of -3..+3 a spacer (the
repeat plus the longest spacer at most 75 bases), each between two 400-bp
flanks; ``background_len`` uniform bases; ``ceil(len * coverage / 300)``
fragments a template with inserts normal(insert_mean, insert_sd), by
default normal(320, 40), clipped to 160 and to the template, mate 2 the
reverse complement of the fragment's last 150 bases, the pairs shuffled
once; ``short_share`` of mates (by default 2%) trimmed to 15-40 bases and
``trim_share`` (30%) to 100-150; substitutions at 0.1% on the first
cycle rising to 1% on the 150th, and N at 0.05%. No indels; a constant quality line ``I``.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import os

import numpy as np

READ_LEN = 150
FLANK = 400
REPEAT_LEN = (23, 47)
SPACER_BASE_LEN = (26, 44)
SPACER_JITTER = 3
MAX_UNIT = 75  # repeat plus the longest spacer
INSERT_MEAN, INSERT_SD, INSERT_MIN = 320.0, 40.0, 160
SUB_FIRST, SUB_LAST = 0.001, 0.01  # at the first and the 150th cycle
N_RATE = 0.0005
SHORT_SHARE, SHORT_LEN = 0.02, (15, 40)
TRIM_SHARE, TRIM_LEN = 0.30, (100, 150)

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")


def _bases(rng, n: int) -> np.ndarray:
    return _BASE[rng.integers(0, 4, size=n)]


def _shape(rng, n_spacers: int):
    """The rejection draws of one array's lengths: ``(repeat_len, lens)``."""
    while True:
        repeat_len = int(rng.integers(REPEAT_LEN[0], REPEAT_LEN[1] + 1))
        base = int(rng.integers(SPACER_BASE_LEN[0], SPACER_BASE_LEN[1] + 1))
        lens = base + rng.integers(-SPACER_JITTER, SPACER_JITTER + 1, size=n_spacers)
        if repeat_len + int(lens.max()) <= MAX_UNIT:
            return repeat_len, lens


def _array_of_shape(rng, repeat_len: int, lens: np.ndarray):
    """One array of the given lengths: ``(bytes, repeat, spacers)``."""
    repeat = _bases(rng, repeat_len)
    spacer_bases = _bases(rng, int(lens.sum()))
    spacers = np.split(spacer_bases, np.cumsum(lens)[:-1])
    parts = [p for sp in spacers for p in (repeat, sp)] + [repeat]
    return (np.concatenate(parts), repeat.tobytes().decode(),
            [s.tobytes().decode() for s in spacers])


def _planted(seq, repeat, spacers) -> dict:
    return {"sequence": seq.tobytes().decode(), "repeat": repeat, "spacers": spacers}


def array_shapes(shape_seed: int, n_arrays: int, spacer_counts) -> list:
    """The ``(repeat_len, spacer lengths)`` of each array that the
    original draws at ``seed = shape_seed``, in its order."""
    rng = np.random.default_rng(shape_seed)
    shapes = []
    for _ in range(n_arrays):
        n_spacers = int(spacer_counts[int(rng.integers(0, len(spacer_counts)))])
        repeat_len, lens = _shape(rng, n_spacers)
        _array_of_shape(rng, repeat_len, lens)  # its bases, to keep the draws in step
        _bases(rng, FLANK), _bases(rng, FLANK)
        shapes.append((repeat_len, lens))
    return shapes


def templates(seed: int, n_arrays: int, spacer_counts, coverage: float, background_len: int,
              background_coverage: float, shape_seed: int | None = None):
    """Arrays and background: ``(rng, arrays, [(template bytes, coverage), ...])``."""
    shapes = None if shape_seed is None else array_shapes(shape_seed, n_arrays, spacer_counts)
    rng = np.random.default_rng(seed)
    if shapes is not None:
        shapes = [shapes[i] for i in rng.permutation(n_arrays)]
    arrays, out = [], []
    for i in range(n_arrays):
        if shapes is None:
            n_spacers = int(spacer_counts[int(rng.integers(0, len(spacer_counts)))])
            repeat_len, lens = _shape(rng, n_spacers)
        else:
            repeat_len, lens = shapes[i]
        seq, repeat, spacers = _array_of_shape(rng, repeat_len, lens)
        arrays.append(_planted(seq, repeat, spacers))
        out.append((np.concatenate([_bases(rng, FLANK), seq, _bases(rng, FLANK)]), coverage))
    if background_len:
        out.append((_bases(rng, background_len), background_coverage))
    return rng, arrays, out


def n_fragments(length: int, coverage: float) -> int:
    return int(np.ceil(length * coverage / (2 * READ_LEN)))


def sample_fragments(rng, template: np.ndarray, coverage: float,
                     insert_mean: float = INSERT_MEAN, insert_sd: float = INSERT_SD):
    """One template's fragments: ``(starts, inserts, mate 1, mate 2)``, the
    mates as ``[n, 150]`` byte rows (mate 2 reverse-complemented)."""
    n, length = n_fragments(len(template), coverage), len(template)
    inserts = np.clip(np.rint(rng.normal(insert_mean, insert_sd, size=n)), INSERT_MIN, length)
    inserts = inserts.astype(np.int64)
    starts = (rng.random(n) * (length - inserts + 1)).astype(np.int64)
    view = np.lib.stride_tricks.sliding_window_view(template, READ_LEN)
    return starts, inserts, view[starts], _COMP[view[starts + inserts - READ_LEN][:, ::-1]]


def trim_lengths(rng, n: int, trim_share: float = TRIM_SHARE,
                 short_share: float = SHORT_SHARE) -> np.ndarray:
    """The length of each of ``n`` mates."""
    u = rng.random(n)
    lengths = np.full(n, READ_LEN, dtype=np.int32)
    short = u < short_share
    cut = (u >= short_share) & (u < short_share + trim_share)
    lengths[cut] = rng.integers(TRIM_LEN[0], TRIM_LEN[1] + 1, size=int(cut.sum()))
    lengths[short] = rng.integers(SHORT_LEN[0], SHORT_LEN[1] + 1, size=int(short.sum()))
    return lengths


def substitution_rate() -> np.ndarray:
    """The substitution probability of each of the 150 cycles."""
    return SUB_FIRST + (SUB_LAST - SUB_FIRST) * np.arange(READ_LEN) / (READ_LEN - 1)


def add_read_errors(rng, reads: np.ndarray, lengths: np.ndarray,
                    block_rows: int = 1 << 18) -> tuple[int, int]:
    """Substitutions and N bases, in place on ``reads`` (ASCII ``ACGT`` rows
    of 150 bytes): returns ``(substitutions, N bases)`` inside the lengths."""
    sub = substitution_rate().astype(np.float32)
    n_cut = sub + np.float32(N_RATE)
    cols = np.arange(READ_LEN)
    subs = ns = 0
    for r0 in range(0, reads.shape[0], block_rows):
        block = reads[r0 : r0 + block_rows]
        u = rng.random(block.shape, dtype=np.float32)
        inside = cols[None, :] < lengths[r0 : r0 + block_rows, None]
        hit = (u < sub) & inside
        nb = (u >= sub) & (u < n_cut) & inside
        codes = _CODE[block[hit]]
        block[hit] = _BASE[(codes + rng.integers(1, 4, size=codes.size, dtype=np.uint8)) & 3]
        block[nb] = ord("N")
        subs += codes.size
        ns += int(nb.sum())
    return subs, ns


def make_fragments(seed: int, n_arrays: int, spacer_counts, coverage: float,
                   background_len: int, background_coverage: float,
                   shape_seed: int | None = None, insert_mean: float = INSERT_MEAN,
                   insert_sd: float = INSERT_SD, trim_share: float = TRIM_SHARE,
                   short_share: float = SHORT_SHARE) -> dict:
    """``arrays`` (the planted truth), ``mates`` (two ``[P, 150]`` byte
    matrices), ``lengths`` (two length vectors) and the counts."""
    rng, arrays, temps = templates(seed, n_arrays, spacer_counts, coverage, background_len,
                                   background_coverage, shape_seed)
    m1, m2 = [], []
    for template, cov in temps:
        _s, _i, a, b = sample_fragments(rng, template, cov, insert_mean, insert_sd)
        m1.append(a)
        m2.append(b)
    del temps
    order = rng.permutation(sum(len(a) for a in m1))
    mates = [np.concatenate(m)[order] for m in (m1, m2)]
    del m1, m2
    lengths = [trim_lengths(rng, len(order), trim_share, short_share) for _ in mates]
    subs = ns = 0
    for m, ln in zip(mates, lengths):
        s, n = add_read_errors(rng, m, ln)
        subs, ns = subs + s, ns + n
    return {"arrays": arrays, "mates": mates, "lengths": lengths, "n_pairs": len(order),
            "substitutions": subs, "n_bases": ns}


def _fastq_blocks(reads: np.ndarray, block_rows: int, lengths: np.ndarray | None = None):
    """The FASTQ bytes of ``reads`` (``@read{i}``, the row, ``+``, ``I`` a
    base), block by block; with ``lengths``, each row cut to its length."""
    n, read_len = reads.shape
    d, lo = 1, 0  # records of one width for every i of one digit count
    while lo < n:
        hi = min(10**d, n)
        for a in range(lo, hi, block_rows):
            b = min(a + block_rows, hi)
            rec = np.empty((b - a, 10 + d + 2 * read_len), dtype=np.uint8)
            rec[:, :5] = np.frombuffer(b"@read", dtype=np.uint8)
            idx = np.arange(a, b)
            for j in range(d):
                rec[:, 5 + j] = 48 + (idx // 10 ** (d - 1 - j)) % 10
            rec[:, 5 + d] = 10
            rec[:, 6 + d : 6 + d + read_len] = reads[a:b]
            rec[:, 6 + d + read_len : 9 + d + read_len] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 9 + d + read_len : -1] = ord("I")
            rec[:, -1] = 10
            if lengths is None:
                yield rec.tobytes()
                continue
            short = np.arange(read_len)[None, :] >= lengths[a:b, None]
            keep = np.ones(rec.shape, dtype=bool)
            keep[:, 6 + d : 6 + d + read_len] = ~short
            keep[:, 9 + d + read_len : -1] = ~short
            yield rec[keep].tobytes()
        d, lo = d + 1, hi


def write_fastq_matrix(path: str, reads: np.ndarray, gz: bool = False,
                       block_rows: int = 1 << 20, lengths: np.ndarray | None = None) -> str:
    """Write ``reads`` as FASTQ (gzipped at level 1, no name, time 0, with
    ``gz``). Returns the SHA-1 of the FASTQ bytes."""
    sha = hashlib.sha1()
    with open(path, "wb") as raw, (
        gzip.GzipFile(filename="", mode="wb", compresslevel=1, fileobj=raw, mtime=0)
        if gz else contextlib.nullcontext(raw)
    ) as fh:
        for data in _fastq_blocks(reads, block_rows, lengths):
            sha.update(data)
            fh.write(data)
    return sha.hexdigest()


def write_input(folder: str, gz: bool = False, **spec) -> dict:
    """:func:`make_fragments` of ``spec``, written into ``folder`` as
    ``reads_1.fq`` and ``reads_2.fq``. Returns ``files``, ``sha1`` (of the
    two files' SHA-1s), ``arrays``, ``mates``, ``lengths``, ``n_pairs`` and
    the counts of the errors."""
    got = make_fragments(**spec)
    os.makedirs(folder, exist_ok=True)
    ext = ".fq.gz" if gz else ".fq"
    files, digests = [], []
    for name, m, ln in zip(("reads_1", "reads_2"), got["mates"], got["lengths"]):
        files.append(os.path.join(folder, name + ext))
        digests.append(write_fastq_matrix(files[-1], m, gz=gz, lengths=ln))
    got.update(files=files, sha1=hashlib.sha1("".join(digests).encode()).hexdigest())
    return got
