"""The two command lines against each other: the same ``argv`` and the
same settings file go through ``mcaat_tpu.cli.parse_arguments`` and
``mcaat_tpu_torch.cli.parse_arguments`` and the resulting ``Settings``
are compared field by field (or the errors, by type and message).

The port's settings file knows two keys more than the JAX package's:
``resume=`` and ``debug_pipeline=`` (the JAX package has the fields and
the flags, but its file parser skips the keys); the last case names
them. Cases mirror ``tests/test_cli.py``.
"""

import dataclasses
import os

import pytest

from mcaat_tpu.cli import parse_arguments as jax_parse
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu.settings import parse_ram_to_gb as jax_ram
from mcaat_tpu_torch.cli import parse_arguments as port_parse
from mcaat_tpu_torch.settings import Settings as TSettings
from mcaat_tpu_torch.settings import parse_ram_to_gb as port_ram

SETTINGS_FILE = (
    "input_files={a}\n"
    "threshold_multiplicity=7\n"
    "cycle_max_length=60  # comment\n"
    "// full-line comment\n"
    "threads=3\n"
)

# name -> (argv with {a}, {b}, {out}, {cfg} filled in per run, settings file text or None)
CASES = {
    "basic": (["--input-files", "{a}", "--output-folder", "{out}"], None),
    "short input flag": (["-i", "{a}", "--output_folder", "{out}"], None),
    "two files": (["--input-files", "{a}", "{b}", "--output-folder", "{out}"], None),
    "cycle flags": (
        ["--input-files", "{a}", "--output-folder", "{out}", "--cycle-max-length", "88",
         "--cycle-min-length", "30", "--threshold-multiplicity", "15", "--low-abundance", "false"],
        None,
    ),
    "low abundance on": (["--input-files", "{a}", "--output-folder", "{out}", "--low-abundance", "Yes"], None),
    "threads and ram": (["--input-files", "{a}", "--output-folder", "{out}", "--threads", "5", "--ram", "2G"], None),
    "ram in megabytes": (["--input-files", "{a}", "--output-folder", "{out}", "--ram", "1536M"], None),
    "benchmark": (["--input-files", "{a}", "--output-folder", "{out}", "--benchmark", "{b}"], None),
    "resume, debug and mesh flags": (
        ["--input-files", "{a}", "--output-folder", "{out}", "--resume", "--debug-pipeline", "--mesh", "off"],
        None,
    ),
    "settings file under CLI overrides": (
        ["--settings", "{cfg}", "--output-folder", "{out}", "--threshold-multiplicity", "9"],
        SETTINGS_FILE,
    ),
    "settings file alone": (["--settings", "{cfg}", "--output-folder", "{out}"], SETTINGS_FILE),
    "settings file with folders": (
        ["--settings", "{cfg}"],
        "input_files={a} {b}\noutput_folder={out}\nlow_abundance=true\nram=3G\nmesh=off\n",
    ),
    "CLI input over the file's": (
        ["--settings", "{cfg}", "--input-files", "{b}", "--output-folder", "{out}"], SETTINGS_FILE,
    ),
}

ERRORS = {
    "no input": (["--output-folder", "{out}"], "No input files"),
    "missing input file": (["--input-files", "{out}/nope.fq", "--output-folder", "{out}"], "does not exist"),
    "three files": (["--input-files", "{a}", "{b}", "{a}", "--output-folder", "{out}"], "one or two"),
    "ram too low": (["--input-files", "{a}", "--output-folder", "{out}", "--ram", "100M"], "too low"),
    "ram without value": (["--input-files", "{a}", "--output-folder", "{out}", "--ram"], "Missing value"),
    "bad mesh": (["--input-files", "{a}", "--output-folder", "{out}", "--mesh", "on"], "--mesh"),
    "settings file missing": (["--settings", "{out}/none.txt", "--input-files", "{a}"], "could not load"),
}


def _fill(argv, tmp_path, side, cfg_text):
    a, b = tmp_path / "a.fq", tmp_path / "b.fq"
    for p in (a, b):
        p.write_text("@r\nACGT\n+\nIIII\n")
    fmt = {"a": str(a), "b": str(b), "out": str(tmp_path / f"out_{side}"), "cfg": str(tmp_path / "settings.txt")}
    if cfg_text is not None:
        (tmp_path / "settings.txt").write_text(cfg_text.format(**fmt))
    return [x.format(**fmt) for x in argv], fmt["out"]


def _fields(s, out: str) -> dict:
    """Every field of a Settings, nested dataclasses included, with the
    run's own output folder taken out of the paths."""
    d = dataclasses.asdict(s)
    return {k: (v.replace(out, "<out>") if isinstance(v, str) else v) for k, v in d.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_argv_gives_the_same_settings(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv, cfg = CASES[case]
    j_argv, j_out = _fill(argv, tmp_path, "jax", cfg)
    js = jax_parse(j_argv)
    t_argv, t_out = _fill(argv, tmp_path, "port", cfg)
    ts = port_parse(t_argv)
    jf, tf = _fields(js, j_out), _fields(ts, t_out)
    assert set(jf) == set(tf)  # the same fields, the port's two extra keys are file keys only
    for key in jf:
        assert tf[key] == jf[key], key
    assert ts.fastq_files()[0] == js.fastq_files()[0]
    assert ts.input_file_list() == js.input_file_list()
    for s in (js, ts):
        assert os.path.isdir(s.graph_folder) and s.output_file.endswith("CRISPR_Arrays.txt")
        assert s.threads > 0 and s.ram > 0


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_same_argv_gives_the_same_error(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv, message = ERRORS[case]
    raised = []
    for side, parse in (("jax", jax_parse), ("port", port_parse)):
        filled, _out = _fill(argv, tmp_path, "shared", None)
        with pytest.raises(RuntimeError, match=message) as e:
            parse(filled)
        raised.append(str(e.value))
    assert raised[0] == raised[1]


def test_default_output_folder_is_stamped_alike(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv, _out = _fill(["--input-files", "{a}"], tmp_path, "x", None)
    js, ts = jax_parse(argv), port_parse(argv)
    for s in (js, ts):
        assert s.output_folder.startswith("mcaat_run_") and s.graph_folder == s.output_folder + "/graph"
    assert len(js.output_folder) == len(ts.output_folder)


@pytest.mark.parametrize("text", ["4G", "512M", "2048K", "3.5", "4X", "", "G"])
def test_ram_parsing_alike(text):
    try:
        want = jax_ram(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_ram(text)
        assert str(got.value) == str(e)
        return
    assert port_ram(text) == want


def test_the_two_keys_only_the_ports_settings_file_knows(tmp_path):
    """``resume=`` and ``debug_pipeline=`` are keys of the port's settings
    file; the JAX package's file parser skips them (its ``--resume`` and
    ``--debug-pipeline`` flags set the same fields). Every other key loads
    alike."""
    cfg = tmp_path / "s.txt"
    cfg.write_text("resume=true\ndebug_pipeline=1\nthreads=4\nthreshold_multiplicity=11\n")
    js, ts = JSettings(), TSettings()
    assert js.load_from_file(str(cfg)) and ts.load_from_file(str(cfg))
    assert (ts.resume, ts.debug_pipeline) == (True, True)
    assert (js.resume, js.debug_pipeline) == (False, False)
    jf, tf = dataclasses.asdict(js), dataclasses.asdict(ts)
    assert {k for k in jf if jf[k] != tf[k]} == {"resume", "debug_pipeline"}
