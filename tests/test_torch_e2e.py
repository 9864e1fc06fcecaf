"""End-to-end cases of ``tests/test_e2e.py`` through both packages on the
CPU: an input with no array, and an input file listed twice. Reports are
compared byte for byte, tables exactly."""

import numpy as np

import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.settings import Settings
from tests.synthetic import make_metagenome, random_seq, sample_reads, write_fastq
from tests.test_torch_graph import assert_same_graph


def test_no_array_in_pure_background(tmp_path):
    rng = np.random.default_rng(5)
    reads = sample_reads(rng, random_seq(rng, 3000), read_len=100, coverage=10.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    want = jpipeline.run_pipeline(
        JSettings(input_files=fq, output_file=str(tmp_path / "j.txt")), verbose=False
    )
    got = tpipeline.run_pipeline(
        Settings(input_files=fq, output_file=str(tmp_path / "t.txt")), verbose=False, device="cpu"
    )
    assert got.found_systems == [] and want.found_systems == []
    assert "Number of Systems: 0" in got.report_text
    assert got.report_text == want.report_text
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert [s.name for s in got.profile.stages] == [s.name for s in want.profile.stages]
    # (the port's graph_build also counts its nodes: its tables have exact sizes)
    assert [s.counters for s in got.profile.stages[1:]] == [s.counters for s in want.profile.stages[1:]]


def test_duplicate_input_file_doubles_multiplicity(tmp_path):
    """A path listed twice contributes its reads twice (the reference
    loops over listed files, src/tmp_utils.cpp:8-24), in both packages."""
    meta = make_metagenome(seed=31, n_arrays=1, n_spacers=4, coverage=12.0)
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, meta["reads"])
    g1 = tpipeline.build_graph_from_settings(
        Settings(input_files=fq, output_file=str(tmp_path / "a.txt")), device="cpu"
    )
    g2 = tpipeline.build_graph_from_settings(
        Settings(input_files=f"{fq} {fq}", output_file=str(tmp_path / "b.txt")), device="cpu"
    )
    assert g2.size == g1.size
    np.testing.assert_array_equal(g2.kmers.numpy(), g1.kmers.numpy())
    np.testing.assert_array_equal(g2.mult.numpy(), 2 * g1.mult.numpy())
    np.testing.assert_array_equal(g2.out.numpy(), g1.out.numpy())
    j2 = jpipeline.build_graph_from_settings(
        JSettings(input_files=f"{fq} {fq}", output_file=str(tmp_path / "c.txt"))
    )
    assert_same_graph(g2, j2)
