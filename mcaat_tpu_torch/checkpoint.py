"""Stage-boundary checkpoints and resume.

Port of ``mcaat_tpu/checkpoint.py`` (the single-device artifacts). The
graph goes to one ``.npz`` with the same keys (``k``, ``kmers``,
``mult``, ``out``, ``in_``, ``valid``), cycles, reads and systems to JSON
with the same layout, so each package resumes from the other's files. A
graph written by the JAX package may carry bucket padding (SENTINEL
k-mers with ``valid=False``); :meth:`DBG.from_numpy` takes it as it is.

Every artifact is written to ``<name>.tmp`` and renamed into place, so
a run killed while writing leaves no truncated file under the final name.

The sharded graph (``parallel/sharded_graph.py``) is saved per shard, in
the JAX package's layout: one ``shard_XXXX.npz`` per kp shard and a
``meta.json``; each process writes and reads only the shards it drives.
The port's shards have their exact size in memory; on disk every shard
is padded to the ``T`` of ``meta.json`` (SENTINEL k-mers, multiplicity 0,
adjacency -1, ``valid=False``), which is the shape the JAX package
reads. A directory written by the JAX package loads here with its ``T``
adopted (global ids stay as they are) and the padding rows cut off.
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


# ---------------------------------------------------------------------------
# Sharded-graph checkpoints (per-shard files; nothing replicated on a host)
# ---------------------------------------------------------------------------


def _shard_path(dir_path: str, s: int) -> str:
    return os.path.join(dir_path, f"shard_{s:04d}.npz")


def _pad_row(t: torch.Tensor, n: int, fill) -> np.ndarray:
    """``[1, n]`` host array of a shard's tensor padded with ``fill``:
    the block shape the JAX package's per-shard files have."""
    a = t.cpu().numpy()
    out = np.full((1, n), fill, dtype=a.dtype)
    out[0, : a.shape[0]] = a
    return out


def _write_sharded_meta(dir_path: str, mesh, meta: dict) -> None:
    """``meta.json`` goes last, from process 0, once every process has
    renamed its shard files into place: a directory with a meta file is
    complete. Shard files past ``kp`` (an older, wider layout) go."""
    from mcaat_tpu_torch.parallel.exchange import barrier

    barrier(mesh)
    if mesh.proc == 0:
        for name in os.listdir(dir_path):
            if name.startswith("shard_") and name.endswith(".npz"):
                if int(name[6:10]) >= mesh.kp:
                    os.remove(os.path.join(dir_path, name))
        _dump_json(os.path.join(dir_path, "meta.json"), meta)
    barrier(mesh)


def save_sharded_graph(dir_path: str, sg) -> None:
    """Persist a ShardedDBG: one ``shard_XXXX.npz`` per kp shard plus a
    ``meta.json``. Each PROCESS writes only the shards it drives, so a
    graph over several processes checkpoints without being gathered."""
    os.makedirs(dir_path, exist_ok=True)
    mesh, T = sg.mesh, sg.T
    meta_path = os.path.join(dir_path, "meta.json")
    if mesh.proc == 0 and os.path.exists(meta_path):
        os.remove(meta_path)  # the directory is incomplete while it is rewritten
    for i in mesh.primary:
        _savez_fast(
            _shard_path(dir_path, mesh.local_kp[i]),
            kmers=_pad_row(sg.kmers[i], T, np.iinfo(np.int64).max),
            mult=_pad_row(sg.mult[i], T, 0),
            out=_pad_row(sg.out[i], 4 * T, -1),
            in_=_pad_row(sg.in_[i], 4 * T, -1),
            valid=_pad_row(sg.valid[i], T, False),
        )
    _write_sharded_meta(dir_path, mesh, {
        "k": int(sg.k),
        "kp": int(mesh.kp),
        "T": int(T),
        "route_cap": int(sg.route_cap),
        "n_live": [int(x) for x in sg.n_live],
    })


def _check_kp(meta: dict, mesh) -> None:
    if mesh.kp != meta["kp"]:
        raise ValueError(f"checkpoint has kp={meta['kp']}, mesh has kp={mesh.kp}")


def load_sharded_graph(dir_path: str, mesh):
    """Rebuild a ShardedDBG on ``mesh`` from :func:`save_sharded_graph`
    files (or the JAX package's); each process reads only the shards its
    slots own. The mesh's kp must match the checkpoint's (the k-mer-space
    partition is baked into the shard files): a ``ValueError`` otherwise."""
    from mcaat_tpu_torch.parallel.sharded_graph import ShardedDBG, _check_gid_range

    with open(os.path.join(dir_path, "meta.json")) as fh:
        meta = json.load(fh)
    _check_kp(meta, mesh)
    kp, T = int(meta["kp"]), int(meta["T"])
    _check_gid_range(kp, T)
    fields: dict = {n: [] for n in ("kmers", "mult", "out", "in_", "valid")}
    n_mine = []
    for i, dev in enumerate(mesh.local_devices):
        with np.load(_shard_path(dir_path, mesh.local_kp[i])) as data:
            kmers = data["kmers"].reshape(-1)
            # live rows are a prefix: SENTINEL sorts last
            n = int(np.searchsorted(kmers, np.iinfo(np.int64).max))
            n_mine.append(n)
            fields["kmers"].append(torch.as_tensor(kmers[:n].copy(), device=dev))
            fields["mult"].append(
                torch.as_tensor(data["mult"].reshape(-1)[:n].astype(np.int32), device=dev)
            )
            for name in ("out", "in_"):
                fields[name].append(
                    torch.as_tensor(data[name].reshape(-1)[: 4 * n].astype(np.int32), device=dev)
                )
            fields["valid"].append(
                torch.as_tensor(data["valid"].reshape(-1)[:n].astype(bool), device=dev)
            )
    if meta.get("n_live"):
        n_live = np.asarray(meta["n_live"], dtype=np.int64)
    else:
        from mcaat_tpu_torch.parallel.sharded_graph import _kp_ints

        n_live = _kp_ints(mesh, n_mine)
    return ShardedDBG(
        k=int(meta["k"]), mesh=mesh, T=T, n_live=n_live,
        route_cap=int(meta.get("route_cap", 0)), **fields,
    )


def save_sharded_valid(dir_path: str, mesh, valid: list, T: int) -> None:
    """Per-shard post-prune validity mask (the cycle stage's second
    output next to cycles.json), padded to ``T`` like the graph's."""
    os.makedirs(dir_path, exist_ok=True)
    meta_path = os.path.join(dir_path, "meta.json")
    if mesh.proc == 0 and os.path.exists(meta_path):
        os.remove(meta_path)
    for i in mesh.primary:
        _savez_fast(_shard_path(dir_path, mesh.local_kp[i]), valid=_pad_row(valid[i], T, False))
    _write_sharded_meta(dir_path, mesh, {"kp": int(mesh.kp), "T": int(T)})


def load_sharded_valid(dir_path: str, mesh, n_live) -> list:
    """The mask of :func:`save_sharded_valid`, per local slot, cut to the
    shard's ``n_live`` rows."""
    with open(os.path.join(dir_path, "meta.json")) as fh:
        meta = json.load(fh)
    _check_kp(meta, mesh)
    out = []
    for i, dev in enumerate(mesh.local_devices):
        s = mesh.local_kp[i]
        with np.load(_shard_path(dir_path, s)) as data:
            v = data["valid"].reshape(-1)[: int(n_live[s])].astype(bool)
        out.append(torch.as_tensor(v, device=dev))
    return out


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
