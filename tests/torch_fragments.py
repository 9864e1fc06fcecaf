"""A metagenome as Illumina sequences it: 2x150-bp fragment pairs with
trimmed lengths, N bases and substitutions that rise towards the 3' end,
from CRISPR arrays of varied repeat, spacer and array lengths.

Everything works on byte matrices and length vectors (one read a row),
so tens of millions of reads are made and written in seconds, with no
Python string a read. Every draw comes from one
``np.random.default_rng(seed)``, in this order:

1. **Arrays.** For each of ``n_arrays``: the spacer count, an index into
   the input's ``spacer_counts``; the repeat length, uniform on 23-47; a
   base spacer length, uniform on 26-44, and a jitter a spacer, uniform
   on -3...+3 (the three drawn again, together, until the repeat plus the
   longest spacer is at most 75 bases, so that every repeat-spacer unit
   lies inside the default cycle window of 27-77 and every spacer inside
   the spacer window of 23-50); then the repeat's bases, the spacers'
   bases and two random 400-bp flanks. ``arrays`` has
   ``synthetic.make_metagenome``'s shape (``sequence``, ``repeat``,
   ``spacers``).
2. **Background**: ``background_len`` uniform bases.
3. **Fragments**, template by template (the arrays with their flanks at
   ``coverage``, then the background at ``background_coverage``):
   ``ceil(len * coverage / 300)`` fragments, insert lengths
   normal(320, 40) rounded and clipped to 160 and to the template's
   length, starts uniform over the template. Mate 1 is a fragment's first
   150 bases, mate 2 the reverse complement of its last 150. The pairs
   are shuffled once and keep their order across the two files.
4. **Trimming**, per mate (file 1's, then file 2's): 2% cut to a length
   uniform on 15-40 (some mates then have no (k+1)-window at k = 23), 30%
   to a length uniform on 100-150, the rest kept at 150.
5. **Errors**, per mate, over blocks of rows: one uniform float32 a
   cycle. A base at cycle i (0-based, from the mate's 5' end) is
   substituted with probability 0.1% + 0.9% * i / 149, rising from 0.1%
   at the first cycle to 1% at the 150th (mean 0.55% over an untrimmed
   mate), by one of the other three bases chosen uniformly; it is an N
   with probability 0.05%. Trimming keeps a mate's first cycles, so it
   removes the worst of them.

No insertions or deletions: ``tests/test_torch_reads_indels.py`` holds
the two packages to one report on reads with them, on the CPU. The
quality line is constant (``I``), as in ``tests/torch_reads.py``.

:func:`write_input` writes ``reads_1.fq`` and ``reads_2.fq`` (``.fq.gz``
at level 1 with ``gz``), each numbered from ``@read0``, and returns the
planted truth, the counts and the SHA-1 of the two files' SHA-1s, each
taken on the FASTQ bytes before compression (``tests/torch_reads.py``'s
contract and writer). The named inputs (``INPUTS``) are those of
``PERF.md`` §4:

    python3 tests/torch_fragments.py NAME FOLDER [--gz]

writes one. ``tests/torch_data/pe150_small/`` holds the report that the
JAX package writes for ``mixed-pe150-small`` and the SHA-1 of that
input; rewrite both with

    JAX_PLATFORMS=cpu python3 tests/torch_fragments.py --write-fixture

from the repository root.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
from torch_reads import _BASE, _CODE, _COMP, write_fastq_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_data", "pe150_small")
FIXTURE_INPUT = "mixed-pe150-small"

READ_LEN = 150
K = 23
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

MIXED = dict(seed=7, n_arrays=40, spacer_counts=(4, 8, 16, 30, 45, 60), coverage=35.0,
             background_len=10_000_000, background_coverage=8.0)
INPUTS = {
    "mixed-pe150": MIXED,
    "mixed-pe150-small": dict(MIXED, n_arrays=8, background_len=300_000),
    # 2,020,240 pairs: the padded windows, 2 * mates * (150 - 23), come to
    # 1,026,281,920, inside 1.00-1.05B and under SINGLE_PASS_MAX_WINDOWS (1.1B)
    "sample-pe150": dict(seed=7, n_arrays=400, spacer_counts=tuple(range(3, 13)),
                         coverage=35.0, background_len=56_500_000, background_coverage=10.4),
}

# The JAX package's own report on the planted arrays of each input:
# (arrays with a system by tests/torch_probes.py::arrays_found, spacers
# found, spacers planted). mixed-pe150-small's is the committed fixture's;
# the other two are of the same arrays (drawn before the background) with
# a 300 kbp background, the most the CPU runs in minutes, where the port
# wrote the same bytes. The reference leaves out what it cannot report: a
# 23-base repeat loses its last base and falls under the 23-base minimum
# unless the spacers' common ends extend it again.
JAX_TRUTH = {
    "mixed-pe150-small": (8, 207, 209),
    "mixed-pe150": (37, 794, 842),
    "sample-pe150": (377, 2764, 3014),
}


def truth_floor(name: str) -> tuple[int, float]:
    """What a run of ``name`` must reach: the arrays with a system and the
    share of the spacers of the JAX package's report, each share less 2
    points (``(arrays, share of spacers)``)."""
    arrays, found, planted = JAX_TRUTH[name]
    n_arrays = INPUTS[name]["n_arrays"]
    return int(np.ceil((arrays / n_arrays - 0.02) * n_arrays - 1e-9)), found / planted - 0.02

def _bases(rng, n: int) -> np.ndarray:
    return _BASE[rng.integers(0, 4, size=n)]


def make_array(rng, n_spacers: int):
    """One array: ``(bytes, repeat, spacers)``, the draws of step 1."""
    while True:
        repeat_len = int(rng.integers(REPEAT_LEN[0], REPEAT_LEN[1] + 1))
        base = int(rng.integers(SPACER_BASE_LEN[0], SPACER_BASE_LEN[1] + 1))
        lens = base + rng.integers(-SPACER_JITTER, SPACER_JITTER + 1, size=n_spacers)
        if repeat_len + int(lens.max()) <= MAX_UNIT:
            break
    repeat = _bases(rng, repeat_len)
    spacer_bases = _bases(rng, int(lens.sum()))
    spacers = np.split(spacer_bases, np.cumsum(lens)[:-1])
    parts = [p for sp in spacers for p in (repeat, sp)] + [repeat]
    return (np.concatenate(parts), repeat.tobytes().decode(),
            [s.tobytes().decode() for s in spacers])


def templates(seed: int, n_arrays: int, spacer_counts, coverage: float, background_len: int,
              background_coverage: float):
    """Steps 1 and 2: ``(rng, arrays, [(template bytes, coverage), ...])``."""
    rng = np.random.default_rng(seed)
    arrays, out = [], []
    for _ in range(n_arrays):
        n_spacers = int(spacer_counts[int(rng.integers(0, len(spacer_counts)))])
        seq, repeat, spacers = make_array(rng, n_spacers)
        arrays.append({"sequence": seq.tobytes().decode(), "repeat": repeat,
                       "spacers": spacers})
        out.append((np.concatenate([_bases(rng, FLANK), seq, _bases(rng, FLANK)]), coverage))
    if background_len:
        out.append((_bases(rng, background_len), background_coverage))
    return rng, arrays, out


def n_fragments(length: int, coverage: float) -> int:
    return int(np.ceil(length * coverage / (2 * READ_LEN)))


def sample_fragments(rng, template: np.ndarray, coverage: float):
    """Step 3 on one template: ``(starts, inserts, mate 1, mate 2)``, the
    mates as ``[n, 150]`` byte rows (mate 2 reverse-complemented)."""
    n, length = n_fragments(len(template), coverage), len(template)
    inserts = np.clip(np.rint(rng.normal(INSERT_MEAN, INSERT_SD, size=n)), INSERT_MIN, length)
    inserts = inserts.astype(np.int64)
    starts = (rng.random(n) * (length - inserts + 1)).astype(np.int64)
    view = np.lib.stride_tricks.sliding_window_view(template, READ_LEN)
    return starts, inserts, view[starts], _COMP[view[starts + inserts - READ_LEN][:, ::-1]]


def trim_lengths(rng, n: int) -> np.ndarray:
    """Step 4: the length of each of ``n`` mates."""
    u = rng.random(n)
    lengths = np.full(n, READ_LEN, dtype=np.int32)
    short = u < SHORT_SHARE
    cut = (u >= SHORT_SHARE) & (u < SHORT_SHARE + TRIM_SHARE)
    lengths[cut] = rng.integers(TRIM_LEN[0], TRIM_LEN[1] + 1, size=int(cut.sum()))
    lengths[short] = rng.integers(SHORT_LEN[0], SHORT_LEN[1] + 1, size=int(short.sum()))
    return lengths


def substitution_rate() -> np.ndarray:
    """The substitution probability of each of the 150 cycles."""
    return SUB_FIRST + (SUB_LAST - SUB_FIRST) * np.arange(READ_LEN) / (READ_LEN - 1)


def add_read_errors(rng, reads: np.ndarray, lengths: np.ndarray,
                    block_rows: int = 1 << 18) -> tuple[int, int]:
    """Step 5, in place on ``reads`` (ASCII ``ACGT`` rows of 150 bytes):
    returns ``(substitutions, N bases)`` inside the mates' lengths."""
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
                   background_len: int, background_coverage: float) -> dict:
    """Steps 1-5: ``arrays``, ``mates`` (two ``[P, 150]`` byte matrices),
    ``lengths`` (two length vectors) and the counts."""
    rng, arrays, temps = templates(seed, n_arrays, spacer_counts, coverage, background_len,
                                   background_coverage)
    m1, m2 = [], []
    for template, cov in temps:
        _s, _i, a, b = sample_fragments(rng, template, cov)
        m1.append(a)
        m2.append(b)
    del temps
    order = rng.permutation(sum(len(a) for a in m1))
    mates = [np.concatenate(m)[order] for m in (m1, m2)]
    del m1, m2
    lengths = [trim_lengths(rng, len(order)) for _ in mates]
    subs = ns = 0
    for m, ln in zip(mates, lengths):
        s, n = add_read_errors(rng, m, ln)
        subs, ns = subs + s, ns + n
    return {"arrays": arrays, "mates": mates, "lengths": lengths, "n_pairs": len(order),
            "substitutions": subs, "n_bases": ns}


def window_counts(lengths) -> dict:
    """The build's (k+1)-windows of both strands of both files: padded (the
    ``R x (Lmax - k) x 2`` that ``graph/dbg.py`` budgets and sorts) and
    real (inside each mate's length)."""
    n = sum(len(x) for x in lengths)
    real = sum(int(np.maximum(x.astype(np.int64) - K, 0).sum()) for x in lengths)
    return {"padded_windows": 2 * n * (READ_LEN - K), "real_windows": 2 * real}


def write_input(folder: str, gz: bool = False, **spec) -> dict:
    """:func:`make_fragments` of ``spec``, written into ``folder`` as two
    mate files. Returns ``files``, ``sha1``, ``arrays``, ``n_pairs``,
    ``n_reads`` (mates in both files), the counts of the errors and of
    the windows, and ``length_counts`` (mates of 150 bases, trimmed to
    100-149, and of 15-40)."""
    got = make_fragments(**spec)
    os.makedirs(folder, exist_ok=True)
    ext = ".fq.gz" if gz else ".fq"
    files, digests = [], []
    for name, m, ln in zip(("reads_1", "reads_2"), got["mates"], got["lengths"]):
        files.append(os.path.join(folder, name + ext))
        digests.append(write_fastq_matrix(files[-1], m, gz=gz, lengths=ln))
    lengths = np.concatenate(got["lengths"])
    return dict(
        files=files, sha1=hashlib.sha1("".join(digests).encode()).hexdigest(),
        arrays=got["arrays"], n_pairs=got["n_pairs"], n_reads=2 * got["n_pairs"],
        substitutions=got["substitutions"], n_bases=got["n_bases"],
        bases=int(lengths.sum()),
        length_counts={"150": int((lengths == READ_LEN).sum()),
                       "100-149": int(((lengths >= 100) & (lengths < READ_LEN)).sum()),
                       "15-40": int((lengths <= SHORT_LEN[1]).sum())},
        **window_counts(got["lengths"]),
    )


def make_named(name: str, folder: str, gz: bool = False) -> dict:
    """One of ``INPUTS``, written into ``folder``."""
    return write_input(folder, gz=gz, **INPUTS[name])


def spacer_lengths(arrays: list) -> tuple[int, int]:
    lens = [len(s) for a in arrays for s in a["spacers"]]
    return min(lens), max(lens)


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

    from torch_probes import spacer_recovery

    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    with tempfile.TemporaryDirectory() as tmp:
        got = make_named(FIXTURE_INPUT, tmp)
        out = os.path.join(tmp, "CRISPR_Arrays.txt")
        run_pipeline(Settings(input_files=" ".join(got["files"]), output_file=out), verbose=False)
        with open(out, "rb") as fh:
            data = fh.read()
    found, planted = spacer_recovery(got["arrays"], data.decode())
    os.makedirs(FIXTURE, exist_ok=True)
    with open(os.path.join(FIXTURE, "CRISPR_Arrays.txt"), "wb") as fh:
        fh.write(data)
    with open(os.path.join(FIXTURE, "input.sha1"), "w") as fh:
        fh.write(f"{got['sha1']}  {FIXTURE_INPUT}: reads_1.fq + reads_2.fq, {got['n_pairs']} "
                 f"pairs, {got['substitutions']} substitutions, {got['n_bases']} N; the JAX "
                 f"report recovers {found}/{planted} spacers\n")
    print(f"wrote {os.path.relpath(FIXTURE, HERE)} ({len(data)} report bytes, {got['n_pairs']} "
          f"pairs, spacers {found}/{planted}; JAX_TRUTH holds the counts)")


if __name__ == "__main__":
    import argparse
    import sys

    # run as a script: the helpers from this directory, the packages from its parent
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", choices=sorted(INPUTS))
    ap.add_argument("folder", nargs="?")
    ap.add_argument("--gz", action="store_true")
    ap.add_argument("--write-fixture", action="store_true",
                    help="run the JAX package on FIXTURE_INPUT and write tests/torch_data/pe150_small/")
    args = ap.parse_args()
    if args.write_fixture:
        from mcaat_tpu.utils.env import honor_cpu_env

        honor_cpu_env()
        _write_fixture()
    elif args.name and args.folder:
        got = make_named(args.name, args.folder, gz=args.gz)
        print(f"{args.name}: {got['n_pairs']} pairs, {got['bases']} bases, lengths "
              f"{got['length_counts']}, {got['substitutions']} substitutions, {got['n_bases']} N, "
              f"{got['padded_windows']} padded and {got['real_windows']} real windows, spacers "
              f"{spacer_lengths(got['arrays'])[0]}-{spacer_lengths(got['arrays'])[1]} bases, "
              f"files {got['files']}, sha1 {got['sha1']}")
    else:
        ap.error("give NAME FOLDER, or --write-fixture")
