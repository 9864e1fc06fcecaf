"""Reads as a sequencer gives them: the reads of a
``synthetic.make_metagenome`` call with uniform substitution errors,
split into paired-end mates, written as FASTQ or gzipped FASTQ.

Everything works on a byte matrix (one read a row), so tens of millions
of reads are made and written in seconds, with no Python string a read:

- :func:`metagenome_matrix` draws what ``make_metagenome`` draws, in the
  same order, and returns its reads as rows (``write_fastq_matrix`` of
  them is the file ``write_fastq(path, make_metagenome(...)["reads"])``
  writes, byte for byte);
- :func:`add_substitutions` replaces each base with probability ``rate``
  by one of the other three, chosen uniformly, from
  ``np.random.default_rng(error_seed)`` over blocks of rows;
- :func:`split_mates` puts the first half of the reads into mate 1 and
  the reverse complement of the second half into mate 2, as
  ``scripts/make_golden_fixtures.py`` makes ``golden_pe``;
- :func:`write_reads` does all of it and writes ``reads_1.fq`` and
  ``reads_2.fq`` (or ``reads.fq``; ``.fq.gz`` at level 1 with ``gz``),
  each numbered from ``@read0``, and returns the planted truth, the
  substitution count and a SHA-1 of the FASTQ bytes (before compression,
  so a plain input and its gzipped twin have one digest; for two mates,
  of the two files' digests).

Substitutions only: insertions and deletions are not modelled.

The named inputs (``INPUTS``) are the ones ``PERF.md`` and the chip runs
use. ``python3 tests/torch_reads.py NAME FOLDER [--gz]`` writes one.

``tests/torch_data/err_pe_1M/`` holds the report that the JAX package
writes for ``planted-20x30-err-pe-1M`` and the SHA-1 of that input;
``tests/test_torch_reads_realistic.py`` and ``chip_smoke.py`` phase 21
check the SHA-1 first (a generator that drifted fails as such) and then
hold the port's report to it. Rewrite both with

    JAX_PLATFORMS=cpu python3 tests/torch_reads.py --write-fixture

from the repository root.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_data", "err_pe_1M")
FIXTURE_INPUT = "planted-20x30-err-pe-1M"

# make_metagenome's call for each named input (PERF.md §4), with the
# error rate and seed applied to its reads; every one is paired-end
PLANTED_20X30 = dict(seed=7, n_arrays=20, n_spacers=30, background_len=10_000_000,
                     background_coverage=8.0, coverage=35.0)
SAMPLE_1B = dict(seed=7, n_arrays=400, n_spacers=6, background_len=62_000_000,
                 background_coverage=10.4, coverage=35.0)
INPUTS = {
    "planted-20x30-err-pe": dict(PLANTED_20X30, error_rate=0.005, error_seed=1),
    "planted-20x30-err-pe-1M": dict(PLANTED_20X30, background_len=1_000_000,
                                    error_rate=0.005, error_seed=1),
    "sample-1.03B-err-pe": dict(SAMPLE_1B, error_rate=0.005, error_seed=1),
    "sample-1.03B-err1-pe": dict(SAMPLE_1B, error_rate=0.01, error_seed=1),
}

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")


def _sampled(rng, template: np.ndarray, read_len: int, coverage: float) -> np.ndarray:
    """``synthetic.sample_reads`` on a uint8 template: the same draws, the
    reads as rows of a ``[n, read_len]`` matrix."""
    n = int(np.ceil(len(template) * coverage / read_len))
    starts = rng.integers(0, max(len(template) - read_len, 1), size=n)
    if len(template) <= read_len:
        raise ValueError("a template no longer than a read gives short reads")
    return np.lib.stride_tricks.sliding_window_view(template, read_len)[starts]


def metagenome_matrix(seed: int, n_arrays: int, n_spacers: int, background_len: int,
                      background_coverage: float, coverage: float, read_len: int = 100,
                      flank_len: int = 300):
    """``make_metagenome(...)`` with the reads as rows of an ASCII byte
    matrix: the same random draws in the same order. Returns ``(arrays,
    reads)``, ``arrays`` as ``make_metagenome`` gives them."""
    from synthetic import BASES, make_crispr_array, random_seq

    rng = np.random.default_rng(seed)
    arrays, parts = [], []
    for _ in range(n_arrays):
        arr_seq, repeat, spacers = make_crispr_array(rng, n_spacers=n_spacers)
        template = random_seq(rng, flank_len) + arr_seq + random_seq(rng, flank_len)
        arrays.append({"sequence": arr_seq, "repeat": repeat, "spacers": spacers})
        parts.append(_sampled(rng, np.frombuffer(template.encode(), dtype=np.uint8), read_len,
                              coverage))
    if background_len:
        bg = BASES[rng.integers(0, 4, size=background_len)]
        parts.append(_sampled(rng, bg, read_len, background_coverage))
        del bg
    reads = np.concatenate(parts)
    del parts
    return arrays, reads[rng.permutation(reads.shape[0])]


def add_substitutions(reads: np.ndarray, rate: float, error_seed: int,
                      block_rows: int = 1 << 18) -> int:
    """Substitute, in place, each base of ``reads`` (an ASCII ``ACGT``
    matrix) with probability ``rate`` by one of the other three bases,
    uniformly. The draws come from ``np.random.default_rng(error_seed)``
    block by block of ``block_rows`` rows: a uniform float32 a base, then
    a shift of 1-3 for each base hit. Returns the number substituted."""
    if not rate:
        return 0
    rng = np.random.default_rng(error_seed)
    total = 0
    for r0 in range(0, reads.shape[0], block_rows):
        block = reads[r0 : r0 + block_rows]
        hit = rng.random(block.shape, dtype=np.float32) < rate
        n = int(np.count_nonzero(hit))
        codes = _CODE[block[hit]]
        if (codes == 255).any():
            raise ValueError("add_substitutions takes reads of A, C, G and T only")
        block[hit] = _BASE[(codes + rng.integers(1, 4, size=n, dtype=np.uint8)) & 3]
        total += n
    return total


def reverse_complement_matrix(reads: np.ndarray) -> np.ndarray:
    """Every row reverse-complemented (rows of one length)."""
    return _COMP[reads[:, ::-1]]


def split_mates(reads: np.ndarray):
    """(mate 1, mate 2): the first ``n // 2`` reads, and the reverse
    complement of the rest (mate 2 is stored reverse-complemented)."""
    half = reads.shape[0] // 2
    return reads[:half], reverse_complement_matrix(reads[half:])


def _fastq_blocks(reads: np.ndarray, block_rows: int, lengths: np.ndarray | None = None):
    """The bytes of ``synthetic.write_fastq(path, reads)``, block by block;
    with ``lengths``, each row cut to its length."""
    n, read_len = reads.shape
    # records of one width for every i of one digit count
    d, lo = 1, 0
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
            # the records at full width, less the bytes past each row's length
            short = np.arange(read_len)[None, :] >= lengths[a:b, None]
            keep = np.ones(rec.shape, dtype=bool)
            keep[:, 6 + d : 6 + d + read_len] = ~short
            keep[:, 9 + d + read_len : -1] = ~short
            yield rec[keep].tobytes()
        d, lo = d + 1, hi


def write_fastq_matrix(path: str, reads: np.ndarray, gz: bool = False,
                       block_rows: int = 1 << 20, lengths: np.ndarray | None = None) -> str:
    """Write ``reads`` as ``synthetic.write_fastq`` would
    (``@read{i}\\n{seq}\\n+\\n{'I' * len(seq)}\\n``; with ``lengths``, each
    row cut to its length), gzipped at level 1 (no name, time 0) with
    ``gz``. Returns the SHA-1 of the FASTQ bytes."""
    sha = hashlib.sha1()
    with open(path, "wb") as raw, (
        gzip.GzipFile(filename="", mode="wb", compresslevel=1, fileobj=raw, mtime=0)
        if gz else contextlib.nullcontext(raw)
    ) as fh:
        for data in _fastq_blocks(reads, block_rows, lengths):
            sha.update(data)
            fh.write(data)
    return sha.hexdigest()


def write_reads(folder: str, reads: np.ndarray, paired: bool = True, gz: bool = False) -> dict:
    """Write ``reads`` into ``folder`` as one file or as two mates.
    Returns ``{"files": [...], "sha1": ...}``: one file's SHA-1 of its
    FASTQ bytes, or for two mates the SHA-1 of their two SHA-1s (hex, in
    order); either way taken before compression."""
    os.makedirs(folder, exist_ok=True)
    ext = ".fq.gz" if gz else ".fq"
    mates = split_mates(reads) if paired else (reads,)
    names = ("reads_1", "reads_2") if paired else ("reads",)
    files, digests = [], []
    for name, m in zip(names, mates):
        files.append(os.path.join(folder, name + ext))
        digests.append(write_fastq_matrix(files[-1], m, gz=gz))
    sha = hashlib.sha1("".join(digests).encode()).hexdigest() if paired else digests[0]
    return {"files": files, "sha1": sha}


def make_input(folder: str, error_rate: float, error_seed: int = 1, paired: bool = True,
               gz: bool = False, **metagenome) -> dict:
    """A ``make_metagenome(**metagenome)`` sample with substitutions at
    ``error_rate`` (``error_seed``), written by :func:`write_reads`.
    Returns ``files``, ``sha1``, ``arrays`` (the planted truth),
    ``n_reads``, ``read_len`` and ``substitutions``."""
    arrays, reads = metagenome_matrix(**metagenome)
    subs = add_substitutions(reads, error_rate, error_seed)
    out = write_reads(folder, reads, paired=paired, gz=gz)
    out.update(arrays=arrays, n_reads=int(reads.shape[0]), read_len=int(reads.shape[1]),
               substitutions=subs)
    return out


def make_named(name: str, folder: str, gz: bool = False) -> dict:
    """One of ``INPUTS``, paired-end, written into ``folder``."""
    return make_input(folder, paired=True, gz=gz, **INPUTS[name])


def fixture_sha1() -> str:
    """The SHA-1 of ``FIXTURE_INPUT``'s FASTQ bytes when the fixture was written."""
    with open(os.path.join(FIXTURE, "input.sha1")) as fh:
        return fh.read().split()[0]


def fixture_report() -> bytes:
    """The JAX package's ``CRISPR_Arrays.txt`` for ``FIXTURE_INPUT``."""
    with open(os.path.join(FIXTURE, "CRISPR_Arrays.txt"), "rb") as fh:
        return fh.read()


def _write_fixture() -> None:
    import tempfile

    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    with tempfile.TemporaryDirectory() as tmp:
        got = make_named(FIXTURE_INPUT, tmp)
        out = os.path.join(tmp, "CRISPR_Arrays.txt")
        run_pipeline(Settings(input_files=" ".join(got["files"]), output_file=out), verbose=False)
        with open(out, "rb") as fh:
            data = fh.read()
    os.makedirs(FIXTURE, exist_ok=True)
    with open(os.path.join(FIXTURE, "CRISPR_Arrays.txt"), "wb") as fh:
        fh.write(data)
    with open(os.path.join(FIXTURE, "input.sha1"), "w") as fh:
        fh.write(f"{got['sha1']}  {FIXTURE_INPUT}: reads_1.fq + reads_2.fq, "
                 f"{got['n_reads']} reads, {got['substitutions']} substitutions\n")
    print(f"wrote {os.path.relpath(FIXTURE, HERE)} ({len(data)} report bytes, "
          f"{got['n_reads']} reads)")


if __name__ == "__main__":
    import argparse
    import sys

    # run as a script: synthetic from this directory, the packages from its parent
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", choices=sorted(INPUTS))
    ap.add_argument("folder", nargs="?")
    ap.add_argument("--gz", action="store_true")
    ap.add_argument("--write-fixture", action="store_true",
                    help="run the JAX package on FIXTURE_INPUT and write tests/torch_data/err_pe_1M/")
    args = ap.parse_args()
    if args.write_fixture:
        from mcaat_tpu.utils.env import honor_cpu_env

        honor_cpu_env()
        _write_fixture()
    elif args.name and args.folder:
        got = make_named(args.name, args.folder, gz=args.gz)
        print(f"{args.name}: {got['n_reads']} reads, {got['substitutions']} substitutions, "
              f"files {got['files']}, sha1 {got['sha1']}")
    else:
        ap.error("give NAME FOLDER, or --write-fixture")
