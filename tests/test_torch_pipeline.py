"""End-to-end parity of the port: reports, CLI, device rule, imports.

``mcaat_tpu_torch`` must write the same ``CRISPR_Arrays.txt`` as
``mcaat_tpu`` — the committed golden fixtures, and a planted metagenome
run by both packages with the big-graph thresholds lowered (so the lazy
clip, neighbourhood extraction and region-first mapping branches run)
and with arrays of more than 24 spacers (so the report takes the batched
LCS path). It must take the sharded path for more than one card, never
fall back to the CPU unasked, and never import jax.
"""

import os
import subprocess
import sys

import pytest
import torch

import mcaat_tpu.cycles.finder as jfinder
import mcaat_tpu.pipeline as jpipeline
import mcaat_tpu_torch.cycles.finder as tfinder
import mcaat_tpu_torch.pipeline as tpipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch import resolve_device
from mcaat_tpu_torch.settings import Settings
from tests.synthetic import make_metagenome, write_fastq

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = {
    "golden": "golden_reads.fq",
    "golden_rc": "golden_rc_reads.fq",
    "golden_mut": "golden_mut_reads.fq",
    "golden_pe": "golden_pe_1.fq golden_pe_2.fq",
}


def _require_native_umap():
    from mcaat_tpu_torch.native import umap_order

    if umap_order(["A", "B"]) is None:
        pytest.skip(
            "the golden fixtures pin the native (libstdc++ unordered_map) "
            "repeat-candidate order; build native/ to run this"
        )


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_golden_report_byte_identical(name, tmp_path):
    _require_native_umap()
    files = " ".join(os.path.join(DATA, f) for f in FIXTURES[name].split())
    s = Settings(input_files=files, output_file=str(tmp_path / "CRISPR_Arrays.txt"))
    result = tpipeline.run_pipeline(s, verbose=False, device="cpu")
    expected = open(os.path.join(DATA, f"{name}_CRISPR_Arrays.txt")).read()
    assert result.report_text == expected
    assert (tmp_path / "CRISPR_Arrays.txt").read_text() == expected


def test_forced_threshold_metagenome_report_matches_jax(tmp_path, monkeypatch):
    from mcaat_tpu_torch.report import lcs_cuda
    import mcaat_tpu_torch.report.analyzer as tanalyzer

    meta = make_metagenome(
        seed=29, n_arrays=2, n_spacers=26, background_len=4000,
        background_coverage=6.0, coverage=40.0,
    )
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    for mod in (jfinder, tfinder):
        monkeypatch.setattr(mod, "NEIGHBORHOOD_MIN_NODES", 0)
        monkeypatch.setattr(mod, "LAZY_CLIP_MIN_NODES", 0)
    monkeypatch.setattr(jpipeline, "REGION_CONDENSE_MIN_NODES", 0)
    monkeypatch.setattr(tpipeline, "REGION_CONDENSE_MIN_NODES", 0)
    batched = []
    orig = tanalyzer.CRISPRAnalyzer.validate_spacer_diversity

    def spy(self, seqs):
        batched.append(len(seqs) > self.BATCH_THRESHOLD)
        return orig(self, seqs)

    monkeypatch.setattr(tanalyzer.CRISPRAnalyzer, "validate_spacer_diversity", spy)
    want = jpipeline.run_pipeline(
        JSettings(input_files=fq, output_file=str(tmp_path / "j.txt")), verbose=False
    )
    launches = lcs_cuda.LAUNCHES
    got = tpipeline.run_pipeline(
        Settings(input_files=fq, output_file=str(tmp_path / "t.txt")), verbose=False,
        device="cpu",
    )
    assert got.report_text == want.report_text
    assert "Number of Systems: 2" in got.report_text
    assert batched and all(batched)  # the batched LCS path ran ...
    assert lcs_cuda.LAUNCHES == launches  # ... on its plain CPU version


@pytest.mark.parametrize("mesh,count,refused", [("auto", 2, True), ("off", 2, False), ("auto", 1, False)])
def test_mesh_auto_takes_the_sharded_path_and_nothing_is_refused(mesh, count, refused, monkeypatch):
    """More than one visible card with --mesh auto used to be refused;
    it is now the one case that takes the sharded path (``refused`` names
    the cases that were), and nothing in the package refuses it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.delenv("MCAAT_TORCH_SHARDS", raising=False)
    assert tpipeline._sharded_mode(Settings(mesh=mesh), torch.device("cuda")) is refused
    assert not hasattr(tpipeline, "_check_single_device")
    pkg = os.path.dirname(tpipeline.__file__)
    for dirpath, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    assert "NotImplementedError" not in fh.read(), name


def test_device_is_explicit(monkeypatch):
    monkeypatch.delenv("MCAAT_TORCH_DEVICE", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.delenv("MCAAT_TORCH_DEVICE")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="MCAAT_TORCH_DEVICE=cpu"):
            resolve_device()


def test_python_m_entry_point_writes_golden_report(tmp_path):
    _require_native_umap()
    env = dict(os.environ, MCAAT_TORCH_DEVICE="cpu", PYTHONPATH=ROOT)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "mcaat_tpu_torch", "--input-files",
         os.path.join(DATA, "golden_reads.fq"), "--output-folder", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    expected = open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")).read()
    assert (out / "CRISPR_Arrays.txt").read_text() == expected
    assert not (out / "graph").exists()


def test_importing_the_port_leaves_jax_out():
    code = (
        "import pkgutil, sys, importlib, mcaat_tpu_torch\n"
        "for m in pkgutil.walk_packages(mcaat_tpu_torch.__path__, 'mcaat_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'mcaat_tpu' or n.startswith('mcaat_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
