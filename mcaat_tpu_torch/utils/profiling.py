"""Stage timers and device-memory readings for the torch pipeline.

Port of ``mcaat_tpu/utils/profiling.py``. CUDA work is asynchronous, so
every stage boundary calls ``torch.cuda.synchronize()`` before it reads
the clock: a stage's seconds then include the device work it queued.
Peak device memory comes from ``torch.cuda.max_memory_allocated()``;
:func:`device_memory_stats` reads the allocator's figures and the card's
total, and :func:`device_trace` records a ``torch.profiler`` trace of a
pipeline section. The JAX package's XLA compile counter has no
counterpart here (torch runs eagerly and compiles nothing at run time)
and is left out.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


def host_rss_mb() -> float:
    """Current host RSS in MB (VmRSS on Linux; ru_maxrss fallback).
    Cheap enough to sample at every stage end."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def sync(device: torch.device | str | None) -> None:
    """Wait for the queued work of ``device`` (no-op for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageStats:
    name: str
    seconds: float = 0.0
    counters: dict[str, float] = field(default_factory=dict)
    rss_mb: float = 0.0  # host RSS at stage END (attribution, not peak)
    device_peak_mb: float | None = None  # peak device memory inside the stage


class Profiler:
    """Stage timer of one device or, for a mesh of shards, of several
    (``device`` may be a list): every boundary waits for all of them, and
    a stage's peak is the largest of theirs."""

    def __init__(self, device=None):
        if device is None:
            devices = []
        elif isinstance(device, (list, tuple, set)):
            devices = sorted({torch.device(d) for d in device}, key=str)
        else:
            devices = [torch.device(device)]
        self.devices = devices
        self.device = devices[0] if devices else None
        self.stages: list[StageStats] = []

    @property
    def _cuda(self) -> list:
        return [d for d in self.devices if d.type == "cuda"]

    @contextlib.contextmanager
    def stage(self, name: str, **counters):
        for d in self._cuda:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        stats = StageStats(name=name, counters=dict(counters))
        try:
            yield stats
        finally:
            for d in self._cuda:
                torch.cuda.synchronize(d)
            stats.seconds = time.perf_counter() - t0
            stats.rss_mb = round(host_rss_mb(), 1)
            if self._cuda:
                stats.device_peak_mb = max(
                    torch.cuda.max_memory_allocated(d) for d in self._cuda
                ) / 2**20
            self.stages.append(stats)

    def count(self, stage_name: str, **counters) -> None:
        for s in reversed(self.stages):
            if s.name == stage_name:
                s.counters.update(counters)
                return
        self.stages.append(StageStats(name=stage_name, counters=dict(counters)))

    def peak_device_mb(self) -> float | None:
        peaks = [s.device_peak_mb for s in self.stages if s.device_peak_mb is not None]
        return max(peaks) if peaks else None

    def report(self) -> str:
        lines = []
        total = sum(s.seconds for s in self.stages)
        for s in self.stages:
            extras = " ".join(f"{k}={v}" for k, v in s.counters.items())
            if s.device_peak_mb is not None:
                extras = f"device_peak={s.device_peak_mb:.1f}MiB {extras}"
            lines.append(f"  {s.name:<28} {s.seconds:8.2f}s  {extras}")
        lines.append(f"  {'TOTAL':<28} {total:8.2f}s")
        return "\n".join(lines)

    def to_json(self) -> str:
        """The stages in order as a JSON list: the JAX package's keys
        (``name``, ``seconds``, ``counters``, ``rss_mb``) plus
        ``device_peak_mb`` (null where no card was timed)."""
        return json.dumps(
            [
                {
                    "name": s.name,
                    "seconds": s.seconds,
                    "counters": s.counters,
                    "rss_mb": s.rss_mb,
                    "device_peak_mb": s.device_peak_mb,
                }
                for s in self.stages
            ]
        )


def tick_printer(prefix: str, enabled: bool, device: torch.device | str | None = None):
    """Substage wall-clock printer: ``tick("label")`` prints the seconds
    since the previous tick as ``    [prefix] label: X.XXs`` when enabled,
    after waiting for ``device``'s queued work."""
    state = {"t": time.perf_counter()}

    def tick(label: str) -> None:
        if enabled:
            sync(device)
        t1 = time.perf_counter()
        if enabled:
            print(f"    [{prefix}] {label}: {t1 - state['t']:.2f}s", flush=True)
        state["t"] = t1

    return tick


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of a pipeline section and write
    it as a Chrome trace (``trace_<pid>_<n>.json``) under ``log_dir`` when
    the block ends. Yields the profiler, whose ``key_averages()`` give the
    sums by operation after the block.

    The CPU activity is always recorded; the CUDA activity is recorded
    whenever a card is present, and a failure to set it up is raised, not
    bypassed with a trace of the host alone."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        # as jax.profiler.stop_trace in the JAX package: the trace is
        # written however the block ends
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def device_memory_stats(device: torch.device | str | None = None) -> dict:
    """Device memory in bytes: ``bytes_in_use``, ``bytes_limit`` (the
    card's total) and ``peak_bytes_in_use`` (the JAX package's keys) plus
    ``bytes_reserved`` (what the caching allocator holds, used or not).
    ``{}`` for the CPU, as the JAX function gives off-chip; ``device``
    defaults to the current card when there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
    }
