"""Wire-volume accounting for the sharded path.

Host-side counters fed by the exchange wrappers
(``parallel/exchange.py``, ``parallel/sharded_graph.py``) with the bytes
each call really moved between shards: the exact bucket lengths, not a
capacity. The per-stage table shows that the downstream's traffic scales
with frontiers and one-time tagging passes, not with the graph
replicated over the shards. The counters are process-local (in a process
group every process issues the same replicated collectives, so one
process's view is the per-process wire budget).
"""

from __future__ import annotations

_counters: dict[str, int] = {}
_calls: dict[str, int] = {}


def add(stage: str, n_bytes: int) -> None:
    _counters[stage] = _counters.get(stage, 0) + int(n_bytes)
    _calls[stage] = _calls.get(stage, 0) + 1


def snapshot() -> dict[str, dict[str, int]]:
    return {
        s: {"bytes": _counters[s], "calls": _calls.get(s, 0)}
        for s in sorted(_counters)
    }


def reset() -> None:
    _counters.clear()
    _calls.clear()
