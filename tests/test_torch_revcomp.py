"""``io/fastq.py::reverse_complement_batch`` (mate 2's reverse complement
on the host) against the plain loop of one reversed slice a row, byte for
byte, zeros in the padding included: ragged rows, one length for every
row, rows of length 0, codes past 3, no rows; and mate 2 of the pe150
fixture through the read mapper's route."""

import numpy as np
import pytest

from mcaat_tpu_torch.io.fastq import ReadBatch, reverse_complement_batch


def _loop(codes, lengths):
    out = np.zeros_like(codes)
    comp = (3 - codes.astype(np.int16)).astype(np.uint8)
    for i in range(codes.shape[0]):
        L = int(lengths[i])
        out[i, :L] = comp[i, :L][::-1]
    return out


def _batch(lengths, width, seed, top=4):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = rng.integers(0, top, (len(lengths), width), dtype=np.uint8)
    codes[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return ReadBatch(codes=codes, lengths=lengths)


CASES = {
    "ragged": _batch(np.random.default_rng(1).integers(0, 41, 300), 40, 2),
    "one-length": _batch([150] * 64, 151, 3),
    "one-length-short": _batch([37] * 20, 50, 4),
    "full-width-and-empty": _batch([0, 12, 12, 0, 5, 12], 12, 5),
    "codes-past-3": _batch([9, 4, 9, 1], 9, 6, top=256),
    "no-rows": _batch([], 10, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_equals_the_loop_of_a_slice_a_row(case):
    batch = CASES[case]
    codes, lengths = batch.codes.copy(), batch.lengths.copy()
    got = reverse_complement_batch(batch)
    assert got.codes.dtype == np.uint8 and got.codes.shape == codes.shape
    np.testing.assert_array_equal(got.codes, _loop(codes, lengths))
    np.testing.assert_array_equal(got.lengths, lengths)
    assert got.lengths is not batch.lengths
    np.testing.assert_array_equal(batch.codes, codes)  # the input is left as it was
    np.testing.assert_array_equal(reverse_complement_batch(got).codes, codes)


def test_mate_2_of_the_pe150_fixture(tmp_path):
    import torch_fragments as tf

    from mcaat_tpu_torch.io.fastq import read_encoded_batch

    made = tf.make_named(tf.FIXTURE_INPUT, str(tmp_path))
    b2 = read_encoded_batch(made["files"][1])
    assert len(np.unique(b2.lengths)) > 1  # trimmed mates: several lengths
    got = reverse_complement_batch(b2)
    np.testing.assert_array_equal(got.codes, _loop(b2.codes, b2.lengths))
