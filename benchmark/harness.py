"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

- a configuration in the file its entry names (``configs/<name>.json``):
  the generator's parameters under ``params``, the source, what was
  ``reduced`` and ``assumed``;
- a traffic mix in ``traffic/<name>.json``: more of the generator's
  parameters under ``params``;
- a metric's reader in ``metrics/<name>.py``: ``read(run)`` gives its
  value or None (nothing to read: the metric is left out of the line); an
  optional ``hook(run)`` gives a context manager that is open around the
  window (hooks that are the same function are entered once);
- a cell's limits in ``checks/<workload>.json`` (see ``compare.py``).

The program is ``mcaat_tpu_torch``; the run drives its CLI entry,
``cli.run_cli``, on one generated FASTQ pair, a sample at a time.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# caches of the program's builds at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, "build", "bench_cache")
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE_DIR, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CACHE_DIR, "triton"),
    "CUDA_CACHE_PATH": os.path.join(CACHE_DIR, "cuda"),
}
# builds the kernel library and the native host library into
# build/mcaat_tpu_torch/ when they are not there, without touching a card
BUILD_SNIPPET = ("from mcaat_tpu_torch.report import lcs_cuda; lcs_cuda.build(); "
                 "from mcaat_tpu_torch import native; native._load()")
BANNED = ("jax", "jaxlib", "flax", "mcaat_tpu")


class CellError(ValueError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def params(self) -> dict:
        return {**self.config["params"], **self.traffic["params"]}


@dataclass
class Run:
    """What a metric's reader reads."""
    setup_s: float = 0.0
    cold_sample_s: float = 0.0
    samples: list = field(default_factory=list)  # {"wall_s", "stages": [...]}
    window_s: float = 0.0
    reserved_peak_bytes: int | None = None
    trace: dict | None = None
    probes: dict = field(default_factory=dict)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(spec: dict, workload: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as fh:
        traffic = json.load(fh)
    return Cell(workload, int(w["chips"]), config, traffic,
                _for_cell(spec["end_to_end"], workload), _for_cell(spec["per_layer"], workload))


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise CellError(f"metrics/{name}.py has no read(run)")
    return mod


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def quiet(path: str):
    """File descriptor 1 into ``path`` for the block: the program's
    console stays out of the result's standard output."""
    sys.stdout.flush()
    saved = os.dup(1)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
        os.close(fd)


def start_build(log_path: str) -> subprocess.Popen:
    """Start building the program's kernel and host libraries into its
    build directory, in a process that touches no card (it runs while the
    input is written)."""
    with open(log_path, "w") as fh:
        return subprocess.Popen([sys.executable, "-c", BUILD_SNIPPET], cwd=ROOT,
                                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                                stdout=fh, stderr=subprocess.STDOUT)


def finish_build(proc: subprocess.Popen, log_path: str) -> None:
    if proc.wait() != 0:
        with open(log_path) as fh:
            raise RuntimeError(f"the library build failed ({proc.returncode}):\n"
                               f"{fh.read()[-6000:]}")


def build_libraries() -> None:
    """The libraries, built and waited for."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "build.log")
        finish_build(start_build(path), path)


def sample(files: list, out: str, console: str, cuda: bool) -> dict:
    """One sample through ``run_cli``: wall seconds (the import of the CLI
    module included), the profiler's stages and the report's bytes."""
    t0, c0 = time.perf_counter(), os.times()
    with quiet(console):
        from mcaat_tpu_torch.cli import run_cli

        result = run_cli(["--input-files", *files, "--output-folder", out])
        if cuda:
            import torch

            torch.cuda.synchronize()
    wall, c1 = time.perf_counter() - t0, os.times()
    if result is None:
        raise RuntimeError("the CLI refused its arguments")
    stages = [{"name": s.name, "seconds": s.seconds, "device_peak_mb": s.device_peak_mb,
               "device_reserved_mb": s.device_reserved_mb} for s in result.profile.stages]
    del result
    with open(os.path.join(out, "CRISPR_Arrays.txt"), "rb") as fh:
        report = fh.read()
    shutil.rmtree(out, ignore_errors=True)
    cpu = {"user": c1.user - c0.user, "system": c1.system - c0.system,
           "children": c1.children_user + c1.children_system
           - c0.children_user - c0.children_system}
    return {"wall_s": wall, "stages": stages, "cpu_s": cpu, "report": report}


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def execute(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
            device: str = "cuda", bench_dir: str = BENCH_DIR,
            build: subprocess.Popen | None = None, build_log: str | None = None) -> dict:
    """Set-up, window and check of one run. Returns the result's line as
    a dict, ``checks`` last. ``build`` is the library build the caller
    started (:func:`start_build`, logging to ``build_log``); on a card one
    is started here when it is not given."""
    import torch

    from benchmark import compare, fragments, probes

    cuda = device == "cuda"
    metrics = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: load_metric(m["name"], bench_dir) for m in metrics}
    limits = compare.load_limits(bench_dir, cell.name)
    run = Run()
    tmp = tempfile.mkdtemp(prefix="mcaat-bench-")
    try:
        log(f"bench: {time.perf_counter() - t_start:.2f}s from the start to the set-up")
        t0 = time.perf_counter()
        if build is None and cuda:
            build_log = os.path.join(tmp, "build.log")
            build = start_build(build_log)
        made = fragments.write_input(os.path.join(tmp, "input"),
                                     seed=seed % (1 << 64), **cell.params())
        for path in made["files"]:  # on disk now, not written back while samples run
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        log(f"bench: {made['n_pairs']} pairs written in {time.perf_counter() - t0:.2f}s")
        if build is not None:
            finish_build(build, build_log)
            log(f"bench: libraries ready {time.perf_counter() - t0:.2f}s into the set-up")
        console = os.path.join(tmp, "console.log")
        cold = sample(made["files"], os.path.join(tmp, "cold"), console, cuda)
        run.cold_sample_s = cold["wall_s"]
        log(f"bench: cold sample {cold['wall_s']:.3f}s, cpu "
            + json.dumps({k: round(v, 2) for k, v in cold["cpu_s"].items()}))

        digests, peak = [], {}
        scores = run.probes["batched"] = []
        hooks = list(dict.fromkeys(r.hook for r in readers.values() if hasattr(r, "hook")))
        reports, failed, prof = [], 0, None
        with contextlib.ExitStack() as stack:
            stack.enter_context(probes.graph_digests(digests))
            stack.enter_context(probes.batched_scores(scores))
            if cuda:
                stack.enter_context(probes.reserved_peak(peak))
            if traced:
                stack.enter_context(probes.stage_spans())
            for hook in hooks:
                stack.enter_context(hook(run))
            if traced:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                prof = profile(activities=acts)
                prof.start()
            run.setup_s = time.perf_counter() - t_start
            w0 = time.perf_counter()
            with torch.profiler.record_function("bench.window"):
                while time.perf_counter() - w0 < seconds:
                    try:
                        got = sample(made["files"], os.path.join(tmp, f"s{len(reports)}"),
                                     console, cuda)
                    except Exception as e:  # a sample that fails ends the window
                        failed += 1
                        log(f"bench: sample {len(reports)} failed: {type(e).__name__}: {e}")
                        break
                    reports.append(got.pop("report"))
                    run.samples.append(got)
            run.window_s = time.perf_counter() - w0
            if prof is not None:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
        log(f"bench: window {run.window_s:.3f}s, {len(run.samples)} samples")
        for i, smp in enumerate(run.samples):
            log(f"bench: sample {i}: {smp['wall_s']:.3f}s, cpu " + json.dumps(
                {k: round(v, 2) for k, v in smp["cpu_s"].items()}) + ", stages " + json.dumps(
                {s["name"]: round(s["seconds"], 3) for s in smp["stages"]}))
        if prof is not None:
            from benchmark import devtrace

            t0 = time.perf_counter()
            dev, host, kinds = devtrace.events(prof)
            del prof
            run.trace = devtrace.reduce(dev, host)
            log(f"bench: device events by kind {kinds}")
            log(f"bench: trace read in {time.perf_counter() - t0:.2f}s: busy "
                f"{run.trace['busy_s']:.4f}s of {run.trace['window_s']:.4f}s; idle by stage "
                + json.dumps({k: round(v, 4) for k, v in run.trace["idle_by_stage"].items()}))
        if cuda:
            run.reserved_peak_bytes = int(peak["bytes"])
        values = {}
        for name, reader in readers.items():
            v = reader.read(run)
            if v is not None:
                unit = next(m["unit"] for m in metrics if m["name"] == name)
                values[name] = {"value": float(v), "unit": unit}
        bad = banned_modules()
        if bad:
            raise RuntimeError(f"modules loaded that the benchmark may not load: {bad}")

        # the check, once the window is closed and the peak read
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        from benchmark import reference

        codes, lengths = reference.encode_reads(made["mates"], made["lengths"])
        ref = compare.reference_for(codes, lengths, cold["report"], device)
        del codes, lengths
        gap = reference.score_gap(scores, device)
        del scores, run.probes["batched"]
        got = compare.readings(ref, digests, len(run.samples), reports, cold["report"],
                               made["arrays"], gap)
        correct, checks = compare.judge(got, limits)
        correct = correct and failed == 0 and bool(run.samples)
        log(f"bench: reference and check in {time.perf_counter() - t0:.2f}s")
    finally:
        if build is not None and build.poll() is None:
            build.kill()
            build.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    import multiprocessing

    for child in multiprocessing.active_children():
        child.join(timeout=60)
    line = {
        "correct": correct,
        "attempted": len(run.samples) + failed,
        "failed": failed,
        "metrics": values,
        "device": device_info(cuda, cell.chips, run),
    }
    if run.trace is not None:
        line["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def device_info(cuda: bool, chips: int, run: Run) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": run.reserved_peak_bytes}
