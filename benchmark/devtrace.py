"""The reduction of a traced window to the numbers the benchmark reports.

The trace is ``torch.profiler``'s, kept in memory (nothing is written to
disk). From it: the device's busy seconds as the union of the intervals
in which a kernel, a copy or a memset ran (a sum would count overlapping
work twice), the window's length from the ``bench.window`` range that the
harness opens around it, the device seconds of each operation by name,
and the idle gaps between device intervals, each named after the
``stage.<name>`` range (see ``probes.stage_spans``) that holds most of it,
with the idle seconds of each stage.
"""

from __future__ import annotations

WINDOW = "bench.window"
STAGE = "stage."


def _get(ev, name: str):
    v = getattr(ev, name)
    return v() if callable(v) else v


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def events(prof) -> tuple[list, list, dict]:
    """``(device, host ranges, kinds)``: ``[(name, start_ns, end_ns)]`` of every
    kernel, copy and memset on a CUDA device (:func:`device_work`), and of
    every host range whose name is ``bench.window`` or starts with
    ``stage.``. ``kinds`` counts the device's events by activity type."""
    from torch.autograd import DeviceType

    dev, host, host_names, kinds = [], [], set(), {}
    for ev in prof.profiler.kineto_results.events():
        name = _get(ev, "name")
        start, dur = _get(ev, "start_ns"), _get(ev, "duration_ns")
        kind = _get(ev, "activity_type") if hasattr(ev, "activity_type") else None
        if _get(ev, "device_type") == DeviceType.CUDA:
            kinds[kind] = kinds.get(kind, 0) + 1
            dev.append((name, start, start + dur, kind))
        else:
            host_names.add(name)
            if _ours(name):
                host.append((name, start, start + dur))
    return device_work(dev, host_names), host, kinds


def device_work(dev: list, host_names: set) -> list:
    """``[(name, start_ns, end_ns)]`` of the device events ``[(name, start,
    end, kind)]`` that are device work. The device's copies of the host's
    ranges (``record_function``, the benchmark's or the program's) are not:
    left out by their kind, or, where the trace gives none, by their name,
    which is that of a host event (a kernel, a copy or a memset never bears
    the name of a host event: those are operators, runtime calls and
    ranges)."""
    return [(n, s, e) for n, s, e, k in dev
            if k in DEVICE_WORK or (k is None and n not in host_names)]


def _ours(name: str) -> bool:
    return name == WINDOW or name.startswith(STAGE)


def union(intervals: list) -> list:
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(dev: list, host: list, top: int = 10) -> dict:
    """``window_s``, ``busy_s``, ``device_s`` (seconds by operation name),
    ``device_ops`` and ``idle_gaps`` (the ``top`` largest, as
    ``[name, seconds]``) and ``idle_by_stage`` (idle seconds by stage)."""
    windows = [(s, e) for n, s, e in host if n == WINDOW]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW} range")
    w0, w1 = windows[0]
    stages = sorted((s, e, n[len(STAGE):]) for n, s, e in host if n.startswith(STAGE))
    merged = union([(max(s, w0), min(e, w1)) for _n, s, e in dev if e > w0 and s < w1])
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    for n, s, e in dev:
        if e > w0 and s < w1:
            by_name[n] = by_name.get(n, 0) + (min(e, w1) - max(s, w0))
    gaps, idle_by_stage, edges = [], {}, [w0] + [x for iv in merged for x in iv] + [w1]
    first = 0  # stages run one after another: the first that may overlap the next gap
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        # the gap's idle time goes to the stages it overlaps, the rest to no stage;
        # the gap is named after the stage that holds most of it
        parts = {"outside stages": b - a}
        while first < len(stages) and stages[first][1] <= a:
            first += 1
        for s, e, n in stages[first:]:
            if s >= b:
                break
            cut = min(b, e) - max(a, s)
            if cut > 0:
                parts[n] = parts.get(n, 0) + cut
                parts["outside stages"] -= cut
        for n, v in parts.items():
            if v > 0:
                idle_by_stage[n] = idle_by_stage.get(n, 0.0) + v / 1e9
        gaps.append((max(parts, key=parts.get), (b - a) / 1e9))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s": {n: v / 1e9 for n, v in by_name.items()},
        "device_ops": [[n[:160], v / 1e9] for n, v in ops[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps, key=lambda g: -g[1])[:top]],
        "idle_by_stage": idle_by_stage,
    }


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds of every operation whose name holds ``<kernel>_kernel``."""
    key = f"{kernel}_kernel"
    return sum(v for n, v in trace["device_s"].items() if key in n)
