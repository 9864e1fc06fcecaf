"""Stage timers and device-memory readings for the torch pipeline.

Port of ``mcaat_tpu/utils/profiling.py``. CUDA work is asynchronous, so
every stage boundary calls ``torch.cuda.synchronize()`` before it reads
the clock: a stage's seconds then include the device work it queued.
Peak device memory comes from ``torch.cuda.max_memory_allocated()``. The
JAX package's XLA compile counter has no counterpart here (torch runs
eagerly and compiles nothing at run time) and is left out.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def sync(device: torch.device | str | None) -> None:
    """Wait for the queued work of ``device`` (no-op for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageStats:
    name: str
    seconds: float = 0.0
    counters: dict[str, float] = field(default_factory=dict)
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
