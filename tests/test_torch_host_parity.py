"""The host-side cases of the JAX package's own test files, run on the
port: one parametrised test per case.

``tests/test_report.py``, ``tests/test_quirks.py``, ``tests/test_ordering.py``
and ``tests/test_ordering_fast.py`` pin the report writer, the reference's
quirks and the ordering stage on small literal and seeded inputs, with
exact expected values. The host modules of the port are near copies of
the JAX package's, so each case is taken as it stands: the file's source
is loaded with the package name ``mcaat_tpu`` replaced by
``mcaat_tpu_torch`` and each test function is run against the port. The
original of every case runs in its own file in the same suite, so the
same inputs go through both packages and both must meet the same exact
assertions. Cases that build a device graph from JAX arrays are named in
``LEFT_OUT`` with the port's test that covers them.
"""

import ast
import inspect
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ["test_report.py", "test_quirks.py", "test_ordering.py", "test_ordering_fast.py"]

# (file, test) -> why it is not mirrored here
LEFT_OUT = {
    ("test_ordering.py", "test_keep_crispr_regions_growth_paths_match"):
        "constructs mcaat_tpu's DBG from jax arrays; the port's growth paths are "
        "compared in tests/test_torch_reads_ordering.py",
    ("test_ordering.py", "test_host_region_growth_matches_device"):
        "builds the graph with the JAX build on the default device; the port's host and "
        "device growth are compared in tests/test_torch_reads_ordering.py",
}


def _cases() -> list:
    """(file, function) for every test function of ``FILES``, read from
    the sources alone so that every worker collects the same list."""
    out = []
    for fname in FILES:
        with open(os.path.join(HERE, fname)) as fh:
            tree = ast.parse(fh.read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                if (fname, node.name) not in LEFT_OUT:
                    out.append((fname, node.name))
    return out


_modules: dict = {}


def _port_module(fname: str) -> dict:
    """The namespace of ``fname`` executed with every ``mcaat_tpu`` name
    pointing at the port."""
    if fname not in _modules:
        with open(os.path.join(HERE, fname)) as fh:
            src = fh.read()
        src, n = re.subn(r"\bmcaat_tpu\b", "mcaat_tpu_torch", src)
        assert n > 0
        ns = {"__name__": f"port_{fname[:-3]}", "__file__": os.path.join(HERE, fname)}
        exec(compile(src, f"{fname} (on mcaat_tpu_torch)", "exec"), ns)
        _modules[fname] = ns
    return _modules[fname]


def _param_sets(fn) -> list:
    """The argument sets of a function's ``parametrize`` marks (their
    product), or one empty set."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")] if isinstance(mark.args[0], str) else list(mark.args[0])
        new = []
        for base in sets:
            for values in mark.args[1]:
                values = values if len(names) > 1 else (values,)
                new.append({**base, **dict(zip(names, values))})
        sets = new
    return sets


@pytest.mark.parametrize("fname,test", _cases(), ids=lambda v: v[:-3] if v.endswith(".py") else v)
def test_jax_host_case_on_the_port(fname, test, request, monkeypatch):
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")  # the port's device is explicit
    ns = _port_module(fname)
    fn = ns[test]
    ran = 0
    for params in _param_sets(fn):
        kwargs = dict(params)
        for name in inspect.signature(fn).parameters:
            if name not in kwargs:
                kwargs[name] = request.getfixturevalue(name)
        fn(**kwargs)
        ran += 1
    assert ran >= 1
    # the case really ran on the port's modules
    used = {getattr(v, "__module__", "") or "" for v in ns.values()}
    assert any(m.startswith("mcaat_tpu_torch") for m in used)
    assert not any(m == "mcaat_tpu" or m.startswith("mcaat_tpu.") for m in used)


def test_left_out_cases_exist():
    """The names in ``LEFT_OUT`` are real tests of those files (so the
    list cannot rot), and everything else is mirrored."""
    for fname in FILES:
        with open(os.path.join(HERE, fname)) as fh:
            names = {n.name for n in ast.parse(fh.read()).body if isinstance(n, ast.FunctionDef)}
        for (f, t) in LEFT_OUT:
            if f == fname:
                assert t in names
    assert len(_cases()) >= 30
