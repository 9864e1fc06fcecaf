"""The profiling tools of the port against mcaat_tpu's on the CPU:
stage registry, ``to_json``, host RSS, ``device_memory_stats`` and
``device_trace`` (a ``torch.profiler`` trace; on the CPU it records the
host activity alone). Names, counters and key sets compare exactly;
seconds and megabytes are only required to be sane."""

import json
import os

import pytest
import torch

from mcaat_tpu.utils import profiling as jprof
from mcaat_tpu_torch.utils import profiling as tprof

JAX_KEYS = {"name", "seconds", "counters", "rss_mb"}


@pytest.mark.parametrize("mod", [tprof, jprof], ids=["port", "jax"])
def test_profiler_stages(mod):
    prof = mod.Profiler()
    with prof.stage("build", nodes=100):
        pass
    prof.count("build", edges=50)
    assert prof.stages[0].counters == {"nodes": 100, "edges": 50}
    assert "build" in prof.report()
    assert "build" in prof.to_json()


def test_to_json_has_the_jax_keys_plus_device_peak():
    profs = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        prof = mod.Profiler()
        with prof.stage("graph_build", nodes=7):
            pass
        with prof.stage("report") as st:
            st.counters["systems"] = 2
        prof.count("late", x=1)  # a stage that was never timed
        profs[name] = json.loads(prof.to_json())
    jax_stages, port_stages = profs["jax"], profs["port"]
    assert [s["name"] for s in port_stages] == [s["name"] for s in jax_stages]
    assert [s["counters"] for s in port_stages] == [s["counters"] for s in jax_stages]
    for js, ps in zip(jax_stages, port_stages):
        assert set(js) == JAX_KEYS
        assert set(ps) == JAX_KEYS | {"device_peak_mb"}
        assert ps["device_peak_mb"] is None  # no card was timed
        assert ps["seconds"] >= 0
    # RSS is sampled at the end of a timed stage, as the JAX Profiler does
    assert port_stages[0]["rss_mb"] > 1 and port_stages[2]["rss_mb"] == 0.0
    assert abs(port_stages[0]["rss_mb"] - jax_stages[0]["rss_mb"]) < 512


def test_host_rss_mb():
    a, b = tprof.host_rss_mb(), jprof.host_rss_mb()
    assert a > 1 and abs(a - b) < 256
    block = bytearray(64 << 20)
    assert tprof.host_rss_mb() >= a + 32
    del block


def test_device_memory_stats_off_card():
    """``{}`` for the CPU, as the JAX function gives off-chip."""
    assert tprof.device_memory_stats("cpu") == {}
    assert tprof.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}
    assert set(jprof.device_memory_stats()) <= {"bytes_in_use", "bytes_limit", "peak_bytes_in_use"}


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from tests.test_torch_pipeline import DATA, _require_native_umap

    import mcaat_tpu_torch.pipeline as tpipeline
    from mcaat_tpu_torch.settings import Settings

    _require_native_umap()
    log_dir = tmp_path / "trace"
    s = Settings(
        input_files=os.path.join(DATA, "golden_reads.fq"),
        output_file=str(tmp_path / "CRISPR_Arrays.txt"),
    )
    with tprof.device_trace(str(log_dir)) as prof:
        result = tpipeline.run_pipeline(s, verbose=False, device="cpu")
    with open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")) as fh:
        assert result.report_text == fh.read()
    files = sorted(os.listdir(log_dir))
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::sort" in names
    assert any(k.key == "aten::sort" for k in prof.key_averages())
    # a second block in the same folder writes a second file
    with tprof.device_trace(str(log_dir)):
        torch.arange(8).sum()
    assert len(os.listdir(log_dir)) == 2


def test_device_trace_writes_the_trace_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with tprof.device_trace(str(tmp_path / "t")):
            torch.arange(8).sum()
            raise KeyError("x")
    assert len(os.listdir(tmp_path / "t")) == 1


@pytest.mark.cuda
def test_device_memory_stats_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the allocator's figures exist only there")
    x = torch.zeros(1 << 20, device="cuda")
    st = tprof.device_memory_stats("cuda")
    assert set(st) == {"bytes_in_use", "bytes_limit", "peak_bytes_in_use", "bytes_reserved"}
    assert st["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    assert st["peak_bytes_in_use"] >= st["bytes_in_use"] >= x.numel() * 4
    assert st["bytes_reserved"] >= st["bytes_in_use"]
