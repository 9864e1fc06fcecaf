"""The frozen generator against the one in ``tests/`` that wrote the
measured mixed-pe150 inputs, and the fixed shapes of ``shape_seed``."""

import os
import sys

import numpy as np

from benchmark import fragments

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "tests")


def test_frozen_copy_writes_the_bytes_of_the_original(tmp_path):
    sys.path.insert(0, TESTS)
    try:
        import torch_fragments
    finally:
        sys.path.remove(TESTS)
    want = torch_fragments.make_named("mixed-pe150-small", str(tmp_path / "orig"))
    spec = torch_fragments.INPUTS["mixed-pe150-small"]
    got = fragments.write_input(str(tmp_path / "copy"), **spec)
    assert got["sha1"] == want["sha1"] == torch_fragments.fixture_sha1()
    for a, b in zip(got["files"], want["files"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert got["arrays"] == want["arrays"]


def _shapes(arrays):
    return sorted((len(a["repeat"]), tuple(len(s) for s in a["spacers"])) for a in arrays)


def test_shape_seed_gives_every_seed_one_set_of_arrays():
    spec = dict(n_arrays=12, spacer_counts=(4, 8, 16, 30), coverage=35.0, background_len=20_000,
                background_coverage=8.0, shape_seed=7)
    a = fragments.make_fragments(seed=1, **spec)
    b = fragments.make_fragments(seed=2**31 + 5, **spec)
    assert _shapes(a["arrays"]) == _shapes(b["arrays"])
    assert [x["repeat"] for x in a["arrays"]] != [x["repeat"] for x in b["arrays"]]
    assert a["n_pairs"] == b["n_pairs"]
    # the shapes are those the original draws at seed = shape_seed
    orig = fragments.make_fragments(seed=7, **{k: v for k, v in spec.items() if k != "shape_seed"})
    assert _shapes(orig["arrays"]) == _shapes(a["arrays"])


def test_same_seed_same_bytes(tmp_path):
    spec = dict(n_arrays=3, spacer_counts=(4, 8), coverage=20.0, background_len=5_000,
                background_coverage=4.0, shape_seed=7)
    one = fragments.write_input(str(tmp_path / "a"), seed=2**33 + 1, **spec)
    two = fragments.write_input(str(tmp_path / "b"), seed=2**33 + 1, **spec)
    assert one["sha1"] == two["sha1"]
    assert all(np.array_equal(x, y) for x, y in zip(one["mates"], two["mates"]))
