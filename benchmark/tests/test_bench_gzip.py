"""The gzipped cell: its configuration loads with ``gz``, the generator's
gzipped pair inflates to the plain pair's bytes at the same seed, and the
readers of the gzip route's span (``graph_build.gzip_parse_s``,
``graph_build.gzip_mib_s``) on made-up records, None on a program
without the span."""

import gzip
import hashlib

import pytest

from benchmark import fragments, harness, spans
from test_bench_metrics import BENCH
from test_bench_spans import _rec, _run

CELL = "pe150-56mbp-gz.short-arrays-40"
TWIN = "pe150-56mbp.short-arrays-40"
SPAN = "graph_build/parse/gzip_parse"


def read(name, run):
    return harness.load_metric(name, BENCH).read(run)


def test_the_cell_is_its_plain_twin_gzipped():
    spec = harness.load_spec()
    cell, twin = harness.load_cell(spec, CELL), harness.load_cell(spec, TWIN)
    assert cell.chips == 1 and cell.params()["gz"] is True
    assert {k: v for k, v in cell.params().items() if k != "gz"} == twin.params()
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in twin.end_to_end]
    # every per-layer metric of the twin, but the three whose cell lists
    # test_bench_parts.py pins to the first four cells, and the gzip route's two
    pinned = {"graph_build.count_parts_s", "graph_build.adjacency_s",
              "graph_build.adjacency_chunks"}
    mine = {m["name"] for m in cell.per_layer}
    assert mine == {m["name"] for m in twin.per_layer} - pinned | {"graph_build.gzip_parse_s",
                                                                   "graph_build.gzip_mib_s"}


def test_the_gzipped_pair_inflates_to_the_plain_pairs_bytes(tmp_path):
    spec = dict(n_arrays=3, spacer_counts=(4, 8), coverage=20.0, background_len=5_000,
                background_coverage=4.0, shape_seed=7)
    plain = fragments.write_input(str(tmp_path / "plain"), seed=2**33 + 3, **spec)
    gz = fragments.write_input(str(tmp_path / "gz"), seed=2**33 + 3, gz=True, **spec)
    assert [f.rsplit("/", 1)[1] for f in gz["files"]] == ["reads_1.fq.gz", "reads_2.fq.gz"]
    assert gz["sha1"] == plain["sha1"]
    for g, p in zip(gz["files"], plain["files"]):
        with open(g, "rb") as fg, open(p, "rb") as fp:
            assert fg.read(2) == b"\x1f\x8b"
            fg.seek(0)
            assert (hashlib.sha1(gzip.decompress(fg.read())).hexdigest()
                    == hashlib.sha1(fp.read()).hexdigest())


def test_readers_of_the_gzip_span():
    run = _run(1, 2)
    assert read("graph_build.gzip_parse_s", run) is None  # a program without the span
    assert read("graph_build.gzip_mib_s", run) is None
    mib = 2**20
    for recs, scale in zip(run.probes["spans"], (1, 2)):
        for f in range(2):  # one span a file, inside graph_build/parse (0 to 4 * scale)
            recs.append(_rec(SPAN, f * scale, (f + 1.5) * scale,
                             {"gzip_files": 1, "gzip_bytes": 6 * mib}))
    # seconds: 1.5 + 1.5 in the first sample, 3 + 3 in the second, over 2 samples
    assert read("graph_build.gzip_parse_s", run) == pytest.approx((3.0 + 6.0) / 2)
    # MiB: 4 files of 6 over those 9 seconds
    assert read("graph_build.gzip_mib_s", run) == pytest.approx(24 / 9)
    for name in ("graph_build.gzip_parse_s", "graph_build.gzip_mib_s"):
        assert harness.load_metric(name, BENCH).hook is spans.hook
    # a span of that name without the counter is not the gzip route's
    bare = _run(1)
    bare.probes["spans"][0].append(_rec(SPAN, 0, 1))
    assert read("graph_build.gzip_parse_s", bare) is None
    assert read("graph_build.gzip_mib_s", bare) is None
