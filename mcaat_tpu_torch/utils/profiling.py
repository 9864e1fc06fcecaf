"""Stage timers, spans and device-memory readings for the torch pipeline.

Port of ``mcaat_tpu/utils/profiling.py``. CUDA work is asynchronous, so
every stage boundary calls ``torch.cuda.synchronize()`` before it reads
the clock: a stage's seconds then include the device work it queued.
Peak device memory comes from ``torch.cuda.max_memory_allocated()``;
:func:`device_memory_stats` reads the allocator's figures and the card's
total, and :func:`device_trace` records a ``torch.profiler`` trace of a
pipeline section. The JAX package's XLA compile counter has no
counterpart here (torch runs eagerly and compiles nothing at run time)
and is left out.

Inside a stage the program opens spans (:func:`span`), accumulating
timers (:func:`timer`) and counters (:func:`count`) where the work
happens, without a profiler in its signatures: each attaches to the
innermost open span or stage of the active :class:`Profiler`, and does
nothing when none is open. Spans live in ``Profiler.spans``, apart from
``Profiler.stages``: a stage's record there is the root of its spans.
Their start and end are Unix-epoch nanoseconds, the clock of
``torch.profiler``'s trace, and while open each is a ``record_function``
range named ``mcaat/<stage>[/<span>...]`` whose args are the sample id.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
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
    # what the caching allocator holds at the stage's end, on the card of the peak
    device_reserved_mb: float | None = None


@dataclass
class Span:
    """One interval of a sample: a stage (``parent`` None) or a span
    inside one. ``name`` is the path from the stage down
    (``read_mapping/region_table/region_mask``); ``timers`` maps a timer's
    name to ``[seconds, calls]``."""

    name: str
    parent: str | None
    sample: str
    start_ns: int
    end_ns: int = 0
    counters: dict[str, float] = field(default_factory=dict)
    timers: dict[str, list] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def to_dict(self) -> dict:
        return {
            "name": self.name, "parent": self.parent, "sample": self.sample,
            "start_ns": self.start_ns, "end_ns": self.end_ns,
            "counters": dict(self.counters),
            "timers": {k: {"seconds": v[0], "calls": v[1]} for k, v in self.timers.items()},
        }


# (profiler, innermost open span) of this thread's context
_OPEN: contextvars.ContextVar = contextvars.ContextVar("mcaat_open_span", default=None)
_SAMPLE_IDS = itertools.count(1)


class Profiler:
    """Stage timer of one device or, for a mesh of shards, of several
    (``device`` may be a list): every boundary waits for all of them, and
    a stage's peak is the largest of theirs. With ``verbose`` each span
    waits for its device's queued work as it closes and prints a line."""

    def __init__(self, device=None, verbose: bool = False):
        if device is None:
            devices = []
        elif isinstance(device, (list, tuple, set)):
            devices = sorted({torch.device(d) for d in device}, key=str)
        else:
            devices = [torch.device(device)]
        self.devices = devices
        self.device = devices[0] if devices else None
        self.verbose = verbose
        self.sample = f"{os.getpid()}-{next(_SAMPLE_IDS)}"
        self.stages: list[StageStats] = []
        self.spans: list[Span] = []
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since the profiler was made."""
        return time.perf_counter() - self._t0

    @property
    def _cuda(self) -> list:
        return [d for d in self.devices if d.type == "cuda"]

    @contextlib.contextmanager
    def _open(self, name: str, parent: Span | None):
        """Record ``name`` under ``parent`` (a stage when None) for the
        block, as the innermost open span and a ``record_function``
        range. The caller waits for the device before the block ends."""
        path = name if parent is None else f"{parent.name}/{name}"
        with torch.profiler.record_function(f"mcaat/{path}", self.sample):
            rec = Span(path, parent.name if parent else None, self.sample, time.time_ns())
            self.spans.append(rec)
            token = _OPEN.set((self, rec))
            try:
                yield rec
            finally:
                _OPEN.reset(token)
                rec.end_ns = time.time_ns()

    @contextlib.contextmanager
    def stage(self, name: str, **counters):
        for d in self._cuda:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        stats = StageStats(name=name, counters=dict(counters))
        try:
            with self._open(name, None):
                try:
                    yield stats
                finally:
                    for d in self._cuda:
                        torch.cuda.synchronize(d)
                    stats.seconds = time.perf_counter() - t0
        finally:
            stats.rss_mb = round(host_rss_mb(), 1)
            if self._cuda:
                peak, reserved = max(
                    (torch.cuda.max_memory_allocated(d), torch.cuda.memory_reserved(d))
                    for d in self._cuda
                )
                stats.device_peak_mb = peak / 2**20
                stats.device_reserved_mb = reserved / 2**20
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
        """A line a stage, and indented under its first line its spans,
        timers and counters (summed by path), then the total."""
        lines = []
        total = sum(s.seconds for s in self.stages)
        under: dict[str, dict[str, list]] = {}
        for sp in self.spans:
            stage, _, rest = sp.name.partition("/")
            rows = under.setdefault(stage, {})
            entries = [(rest, sp.seconds, sp.counters)] if rest else []
            if not rest and sp.counters:
                entries.append(("[counters]", 0.0, sp.counters))
            entries += [(f"{rest}/{k} [timer]".lstrip("/"), v[0], {"calls": v[1]})
                        for k, v in sp.timers.items()]
            for key, seconds, ctr in entries:
                acc = rows.setdefault(key, [0.0, {}])
                acc[0] += seconds
                for k, v in ctr.items():
                    acc[1][k] = acc[1].get(k, 0) + v
        shown = set()
        for s in self.stages:
            extras = " ".join(f"{k}={v}" for k, v in s.counters.items())
            if s.device_peak_mb is not None:
                extras = f"device_peak={s.device_peak_mb:.1f}MiB {extras}"
            lines.append(f"  {s.name:<28} {s.seconds:8.2f}s  {extras}")
            if s.name in shown:
                continue
            shown.add(s.name)
            for rest, (seconds, ctr) in under.get(s.name, {}).items():
                label = "  " * rest.count("/") + rest.rsplit("/", 1)[-1]
                extras = " ".join(f"{k}={v}" for k, v in ctr.items())
                lines.append(f"    {label:<26} {seconds:8.2f}s  {extras}")
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

    def span_records(self) -> list[dict]:
        """Every stage and span of this sample, in the order they opened."""
        return [sp.to_dict() for sp in self.spans]


def _line(rec: Span) -> str:
    extras = [f"{k}={v}" for k, v in rec.counters.items()]
    extras += [f"{k}={v[0]:.2f}s/{v[1]}" for k, v in rec.timers.items()]
    return f"    [{rec.name}] {rec.seconds:.2f}s" + "".join(" " + e for e in extras)


@contextlib.contextmanager
def span(name: str, device: torch.device | str | None = None):
    """Time the block as the span ``name`` under the innermost open span
    or stage. When the profiler is verbose the span waits for
    ``device``'s queued work before it ends (None: host work, no wait)
    and prints its line. Without an open stage it does nothing."""
    top = _OPEN.get()
    if top is None:
        yield
        return
    prof, parent = top
    with prof._open(name, parent) as rec:
        yield
        if prof.verbose:
            sync(device)
    if prof.verbose:
        print(_line(rec), flush=True)


@contextlib.contextmanager
def timer(name: str):
    """Add the block's seconds and one call to the timer ``name`` of the
    innermost open span or stage: for work that interleaves with other
    work, timed where it runs, with no span a call."""
    top = _OPEN.get()
    if top is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        acc = top[1].timers.setdefault(name, [0.0, 0])
        acc[0] += (time.time_ns() - t0) / 1e9
        acc[1] += 1


def count(**counters) -> None:
    """Add ``counters`` to those of the innermost open span or stage (a
    no-op with none open)."""
    top = _OPEN.get()
    if top is not None:
        got = top[1].counters
        for k, v in counters.items():
            got[k] = got.get(k, 0) + v


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
