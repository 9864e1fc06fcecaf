"""Stage-boundary checkpoints and resume.

Port of ``mcaat_tpu/checkpoint.py`` (the single-device artifacts). The
graph goes to one ``.npz`` with the same keys (``k``, ``kmers``,
``mult``, ``out``, ``in_``, ``valid``), cycles, reads and systems to JSON
with the same layout, so each package resumes from the other's files. A
graph written by the JAX package may carry bucket padding (SENTINEL
k-mers with ``valid=False``); :meth:`DBG.from_numpy` takes it as it is.

Every artifact is written to ``<name>.tmp`` and renamed into place, so
a run killed while writing leaves no truncated file under the final name.

The sharded checkpoints of the JAX package's multi-device path are not
ported with it (ROADMAP.md queue 1: the parallel/ path).
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from mcaat_tpu_torch.graph.dbg import DBG


@contextlib.contextmanager
def _replacing(path: str):
    """Yield ``<path>.tmp`` to write; rename it over ``path`` once the
    block completes, remove it if the block raises."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _dump_json(path: str, obj) -> None:
    with _replacing(path) as tmp, open(tmp, "w") as fh:
        json.dump(obj, fh)


def _savez_fast(path: str, **arrays) -> None:
    """``np.savez_compressed`` written at zlib level 1 instead of its
    default 6: the same ``.npz`` (a zip of deflated ``.npy`` members that
    ``np.load`` reads), several times faster to write for the adjacency
    arrays of a large graph (PERF.md)."""
    import zipfile

    if not path.endswith(".npz"):
        path += ".npz"
    with _replacing(path) as tmp, zipfile.ZipFile(
        tmp, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=1
    ) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(arr), allow_pickle=False)


def save_graph(path: str, graph: DBG) -> None:
    """Persist the graph tensors (the analog of graph.sdbg.*)."""
    _savez_fast(
        path,
        k=np.int32(graph.k),
        kmers=graph.kmers.cpu().numpy(),
        mult=graph.mult.cpu().numpy(),
        out=graph.out.cpu().numpy(),
        in_=graph.in_.cpu().numpy(),
        valid=graph.valid.cpu().numpy(),
    )


def load_graph(path: str, device: str | torch.device = "cuda") -> DBG:
    """≙ SDBG::LoadFromFile, onto ``device``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return DBG.from_numpy(
            data["k"], data["kmers"], data["mult"], data["out"], data["in_"],
            data["valid"], device,
        )


def save_cycles(path: str, cycles_map: dict[int, list[list[int]]]) -> None:
    _dump_json(path, {str(k): v for k, v in cycles_map.items()})


def load_cycles(path: str) -> dict[int, list[list[int]]]:
    with open(path) as fh:
        j = json.load(fh)
    return {int(k): [[int(x) for x in c] for c in v] for k, v in j.items()}


def save_reads(path: str, reads) -> None:
    """``reads`` is a ``Chains`` (or a list of lists); the JSON artifact is
    a list of lists."""
    from mcaat_tpu_torch.reads.chains import Chains

    if isinstance(reads, Chains):
        reads = reads.tolists()
    _dump_json(path, reads)


def load_reads(path: str):
    from mcaat_tpu_torch.reads.chains import Chains

    with open(path) as fh:
        return Chains.from_lists([[int(x) for x in r] for r in json.load(fh)])


def save_systems(path: str, found_systems) -> None:
    _dump_json(
        path,
        [
            {
                "full_sequence": fs.full_sequence,
                "repeat": fs.repeat,
                "spacers": fs.spacers,
                "confidence_cycle_resolution": fs.confidence_cycle_resolution,
                "confidence_topological_sort": fs.confidence_topological_sort,
            }
            for fs in found_systems
        ],
    )


def load_systems(path: str):
    from mcaat_tpu_torch.pipeline import FoundSystem

    with open(path) as fh:
        data = json.load(fh)
    return [
        FoundSystem(
            d["full_sequence"],
            d["repeat"],
            d["spacers"],
            d["confidence_cycle_resolution"],
            d["confidence_topological_sort"],
        )
        for d in data
    ]
