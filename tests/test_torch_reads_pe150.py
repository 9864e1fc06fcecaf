"""A metagenome as Illumina sequences it (``tests/torch_fragments.py``):
2x150-bp fragment pairs, trimmed mates, N bases, substitutions rising
towards the 3' end, arrays of varied repeat, spacer and array lengths.

The generator's own model on small calls: mate 2 is the reverse
complement of the fragment's last 150 bases before errors; the trimmed
and short-mate shares and the N and substitution rates lie within
binomial limits (five standard deviations); one seed gives one byte
stream, plain or gzipped; the ragged files parse back to the mates as
the port's parsers read them; every array of the named inputs lies
inside the default cycle and spacer windows. Then the committed input:
the SHA-1 of ``mixed-pe150-small`` first, so that a generator that
drifted fails as such, and the port's report on the CPU against the one
the JAX package wrote (``tests/torch_data/pe150_small/``), byte for byte.
"""

import gzip

import numpy as np
import pytest

import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu_torch.io.fastq import encode_fastx_chunk, read_encoded_batch
from mcaat_tpu_torch.settings import Settings
from tests import torch_fragments as tf
from tests.torch_reads import write_fastq_matrix
from tests.torch_probes import (
    arrays_found,
    probe_pipeline,
    reported_repeats,
    spacer_recovery,
)

TINY = dict(seed=3, n_arrays=2, spacer_counts=(5, 30), coverage=10.0, background_len=5000,
            background_coverage=2.0)
SIGMAS = 5.0


def _within_binomial(count: int, n: int, p: float) -> bool:
    return abs(count - n * p) <= SIGMAS * np.sqrt(n * p * (1 - p))


def _rc(row: np.ndarray) -> np.ndarray:
    return tf._COMP[row[::-1]]


def _rc_str(seq: str) -> str:
    return _rc(np.frombuffer(seq.encode(), dtype=np.uint8)).tobytes().decode()


@pytest.mark.parametrize("length", [2000, 170], ids=["long", "short-template"])
def test_mate2_is_the_reverse_complement_of_the_fragment_end(length):
    rng = np.random.default_rng(11)
    template = tf._bases(rng, length)
    starts, inserts, m1, m2 = tf.sample_fragments(rng, template, 30.0)
    assert len(starts) == tf.n_fragments(length, 30.0)
    assert inserts.min() >= tf.INSERT_MIN and inserts.max() <= length
    assert (starts >= 0).all() and (starts + inserts <= length).all()
    for s, i, a, b in zip(starts, inserts, m1, m2):
        assert (a == template[s : s + tf.READ_LEN]).all()
        assert (b == _rc(template[s + i - tf.READ_LEN : s + i])).all()


def test_trimmed_and_short_mate_shares():
    n = 200_000
    lengths = tf.trim_lengths(np.random.default_rng(5), n)
    short = lengths <= tf.SHORT_LEN[1]
    cut = (lengths >= tf.TRIM_LEN[0]) & ~short
    assert _within_binomial(int(short.sum()), n, tf.SHORT_SHARE)
    # a mate cut to a length uniform on 100-150 keeps 150 one time in 51
    cut_below = int((cut & (lengths < tf.READ_LEN)).sum())
    assert _within_binomial(cut_below, n, tf.TRIM_SHARE * 50 / 51)
    assert lengths[short].min() == tf.SHORT_LEN[0] and lengths[short].max() == tf.SHORT_LEN[1]
    assert lengths[cut].min() == tf.TRIM_LEN[0] and lengths.max() == tf.READ_LEN
    assert ((lengths > tf.SHORT_LEN[1]) == (lengths >= tf.TRIM_LEN[0])).all()


def test_substitution_and_n_rates_within_binomial_limits():
    rng = np.random.default_rng(9)
    n = 40_000
    clean = tf._BASE[rng.integers(0, 4, size=(n, tf.READ_LEN))]
    lengths = tf.trim_lengths(rng, n)
    reads = clean.copy()
    subs, ns = tf.add_read_errors(np.random.default_rng(10), reads, lengths, block_rows=7_000)
    inside = np.arange(tf.READ_LEN)[None, :] < lengths[:, None]
    changed = reads != clean
    is_n = reads == ord("N")
    assert not (changed & ~inside).any()  # nothing past a mate's end
    assert int((changed & ~is_n).sum()) == subs and int(is_n.sum()) == ns
    assert set(np.unique(reads[changed & ~is_n]).tolist()) <= set(b"ACGT")
    # each cycle against its own rate, over the mates that reach it
    per_cycle = (changed & ~is_n).sum(axis=0)
    reach = inside.sum(axis=0)
    rate = tf.substitution_rate()
    assert rate[0] == pytest.approx(0.001) and rate[-1] == pytest.approx(0.01)
    assert rate.mean() == pytest.approx(0.0055)
    for c in range(tf.READ_LEN):
        assert _within_binomial(int(per_cycle[c]), int(reach[c]), rate[c]), c
    assert _within_binomial(ns, int(inside.sum()), tf.N_RATE)
    # the substitutions rise: the last 50 cycles carry more than twice the first 50
    assert per_cycle[100:].sum() > 2 * per_cycle[:50].sum()


def test_one_seed_one_byte_stream_plain_and_gzipped(tmp_path):
    a = tf.write_input(str(tmp_path / "a"), **TINY)
    b = tf.write_input(str(tmp_path / "b"), **TINY)
    c = tf.write_input(str(tmp_path / "c"), **dict(TINY, seed=4))
    g = tf.write_input(str(tmp_path / "g"), gz=True, **TINY)
    assert a["sha1"] == b["sha1"] == g["sha1"] != c["sha1"]
    for x, y, z in zip(a["files"], b["files"], g["files"]):
        data = open(x, "rb").read()
        assert open(y, "rb").read() == data
        with gzip.open(z, "rb") as fh:
            assert fh.read() == data
    assert a["n_pairs"] == sum(tf.n_fragments(len(a_["sequence"]) + 2 * tf.FLANK, 10.0)
                               for a_ in a["arrays"]) + tf.n_fragments(5000, 2.0)
    assert a["n_reads"] == 2 * a["n_pairs"]


def test_ragged_files_parse_back_to_the_mates(tmp_path):
    """The two mate files against the generator's matrices: the native
    parser (plain and gzipped) and the numpy chunk encoder of the
    process group's byte-range parse read the same codes and lengths."""
    got = tf.make_fragments(**TINY)
    for gz in (False, True):
        ext = ".fq.gz" if gz else ".fq"
        for i, (m, ln) in enumerate(zip(got["mates"], got["lengths"])):
            path = str(tmp_path / f"m{i}{ext}")
            write_fastq_matrix(path, m, gz=gz, lengths=ln)
            batch = read_encoded_batch(path)
            assert (batch.lengths == ln).all() and batch.max_len == tf.READ_LEN
            # N codes as T, as every other non-ACGT byte
            want = np.where(m == ord("N"), 3, tf._CODE[np.where(m == ord("N"), 65, m)])
            inside = np.arange(tf.READ_LEN)[None, :] < ln[:, None]
            assert (np.where(inside, batch.codes, 0) == np.where(inside, want, 0)).all()
            if not gz:
                chunk = encode_fastx_chunk(open(path, "rb").read())
                assert (chunk.lengths == ln).all()
                assert (chunk.codes == batch.codes).all()
    lengths = np.concatenate(got["lengths"])
    assert lengths.min() < tf.K + 1  # some mates have no (k+1)-window
    assert got["n_bases"] > 0 and got["substitutions"] > 0


@pytest.mark.parametrize("name", sorted(tf.INPUTS))
def test_arrays_lie_inside_the_default_windows(name):
    spec = dict(tf.INPUTS[name], background_len=0)  # the arrays come first
    _rng, arrays, _t = tf.templates(**spec)
    assert len(arrays) == spec["n_arrays"]
    lo, hi = tf.spacer_lengths(arrays)
    assert 23 <= lo and hi <= 50  # the spacer window
    for a in arrays:
        unit = [len(a["repeat"]) + len(s) for s in a["spacers"]]
        assert 27 <= min(unit) and max(unit) <= tf.MAX_UNIT <= 77  # the cycle window
        assert tf.REPEAT_LEN[0] <= len(a["repeat"]) <= tf.REPEAT_LEN[1]
        assert len(a["spacers"]) in spec["spacer_counts"]
        assert a["sequence"] == "".join(a["repeat"] + s for s in a["spacers"]) + a["repeat"]
    # lengths vary within and between arrays
    assert len({len(a["repeat"]) for a in arrays}) > 1
    assert any(len({len(s) for s in a["spacers"]}) > 1 for a in arrays)


def test_every_array_of_the_fixture_has_a_system():
    """The JAX-written report of mixed-pe150-small against its planted
    truth: 8 systems for 8 arrays. Its 23-base repeat comes back a base
    off at each end (the reference drops a repeat's last base), so it
    shares no 23-mer with the report and the rule asks it for 21."""
    _rng, arrays, _t = tf.templates(**dict(tf.INPUTS[tf.FIXTURE_INPUT], background_len=0))
    report = tf.fixture_report().decode()
    assert arrays_found(arrays, report, errors=True) == len(arrays) == 8
    short = [a for a in arrays if len(a["repeat"]) == 23]
    assert len(short) == 1
    assert not any(short[0]["repeat"] in r or _rc_str(short[0]["repeat"]) in r
                   for r in reported_repeats(report))
    found, planted = spacer_recovery(arrays, report)
    assert tf.JAX_TRUTH[tf.FIXTURE_INPUT] == (8, found, planted) == (8, 207, 209)
    assert tf.truth_floor(tf.FIXTURE_INPUT) == (8, found / planted - 0.02)


def test_pe150_small_report_equals_the_jax_fixture(tmp_path):
    """mixed-pe150-small (10,390 pairs): the input's SHA-1 first, then the
    port's report on the CPU against the JAX-written one, byte for byte;
    both report routes ran (systems of more than 24 spacers and fewer)."""
    got = tf.make_named(tf.FIXTURE_INPUT, str(tmp_path / "in"))
    assert got["sha1"] == tf.fixture_sha1(), "the input generator drifted"
    with probe_pipeline() as probe:
        result = tpipeline.run_pipeline(
            Settings(input_files=" ".join(got["files"]), output_file=str(tmp_path / "t.txt")),
            verbose=False, device="cpu",
        )
    assert (tmp_path / "t.txt").read_bytes() == tf.fixture_report()
    assert probe["rc_reads"] == got["n_pairs"]
    counts = [int(line.split(": ")[1]) for line in result.report_text.splitlines()
              if line.startswith("Number of Spacers: ")][:-1]
    assert min(counts) <= 24 < max(counts)
