"""The mesh of shards and the collectives between them.

The JAX package runs one program over a ``("dp", "kp")`` device mesh and
XLA moves the data (``all_to_all`` over ``kp``, ``all_gather`` over
``dp``, ``psum``, ``process_allgather``). Here a *shard* is a slot of
that mesh, driven by one process and living on one device; a process may
drive several slots and several slots may share a device. Work on the
shards is a Python loop that queues ops on each slot's device, and every
movement of data between slots goes through the functions below:

* :func:`all_to_all` — the routed exchange over ``kp``. Buckets have
  their exact length, so nothing can overflow and nothing is padded.
* :func:`all_gather_dp` — the concatenation over ``dp``.
* :func:`all_gather_host`, :func:`host_shards`, :func:`psum`,
  :func:`barrier` — small host-side values shared between processes.

Inside one process an exchange is a transpose of the bucket lists with
``.to(device, non_blocking=True)`` copies (card to card where the devices
differ, no copy where they are the same). Across processes it is
``torch.distributed.all_to_all_single`` with the split sizes exchanged
first: NCCL for CUDA tensors, gloo for CPU tensors. A mesh that spans
processes needs an initialised process group; without one every function
here raises.

Every process must enter every collective in the same order: the size
exchange happens even when a process has nothing to send.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mcaat_tpu_torch.utils import wire


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``[dp, kp]`` grid of shard slots (row-major: slot ``d*kp + s``).

    ``slot_proc[g]`` is the process that drives global slot ``g``;
    ``local_devices[i]`` the device of this process's ``i``-th slot (its
    slots in ascending global order). The same device may back several
    slots.
    """

    dp: int
    kp: int
    slot_proc: tuple
    local_devices: tuple
    proc: int = 0
    n_proc: int = 1
    # True for a mesh made over an initialised process group: every
    # collective then goes through torch.distributed, even in a group of
    # one process (which is how one card checks the NCCL calls)
    distributed: bool = False
    local_slots: tuple = field(init=False)

    def __post_init__(self):
        if len(self.slot_proc) != self.dp * self.kp:
            raise ValueError("mesh: slot_proc must name dp*kp slots")
        if self.kp & (self.kp - 1):
            raise ValueError(f"mesh: kp={self.kp} is not a power of two")
        mine = tuple(g for g, p in enumerate(self.slot_proc) if p == self.proc)
        if len(mine) != len(self.local_devices):
            raise ValueError("mesh: one device per local slot is required")
        if self.n_proc > 1 and not self.distributed:
            raise ValueError("mesh: more than one process needs a process group")
        object.__setattr__(self, "local_slots", mine)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "kp": self.kp}

    @property
    def n_local(self) -> int:
        return len(self.local_slots)

    @property
    def local_kp(self) -> list[int]:
        """The kp column (k-mer-space shard) of each local slot."""
        return [g % self.kp for g in self.local_slots]

    @property
    def primary(self) -> list[int]:
        """Local slot indices in dp row 0: one replica of each kp shard
        over the whole mesh, the one host gathers and checkpoints read."""
        return [i for i, g in enumerate(self.local_slots) if g < self.kp]

    @property
    def comm_device(self) -> torch.device:
        """Where tensors are staged for a process-group call: the first
        local device (NCCL wants CUDA tensors, gloo CPU tensors)."""
        return self.local_devices[0]

    def pos(self, g: int, axis: str) -> int:
        """Position of global slot ``g`` in its group along ``axis``."""
        return g % self.kp if axis == "kp" else g // self.kp

    def peers(self, g: int, axis: str) -> list[int]:
        """Global slots of ``g``'s group along ``axis``, in group order."""
        d, s = divmod(g, self.kp)
        if axis == "kp":
            return [d * self.kp + m for m in range(self.kp)]
        return [m * self.kp + s for m in range(self.dp)]


def _group(mesh: Mesh):
    """The process group of a distributed mesh, or an error: nothing
    here runs such a mesh without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh spans {mesh.n_proc} processes but torch.distributed is not "
            "initialised; call parallel.multihost.initialize_distributed first"
        )
    if dist.get_world_size() != mesh.n_proc or dist.get_rank() != mesh.proc:
        raise RuntimeError(
            f"mesh built for process {mesh.proc}/{mesh.n_proc}, process group is "
            f"{dist.get_rank()}/{dist.get_world_size()}"
        )
    return dist


def _wire_dtype(t: torch.Tensor) -> torch.Tensor:
    # NCCL has no bool: validity masks cross as uint8
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _exchange(mesh: Mesh, axis: str, data: list, stage: str | None):
    """``data[i][m]`` goes from local slot ``i`` to the ``m``-th slot of
    its group along ``axis``; returns ``recv[j][m]``, what the ``m``-th
    slot of ``j``'s group sent to local slot ``j``, on ``j``'s device.
    All tensors share one dtype and one trailing shape."""
    n_local = mesh.n_local
    if len(data) != n_local:
        raise ValueError(f"exchange: {len(data)} bucket lists for {n_local} local slots")
    width = mesh.kp if axis == "kp" else mesh.dp
    local_of = {g: i for i, g in enumerate(mesh.local_slots)}
    moved = 0
    for i, g in enumerate(mesh.local_slots):
        if len(data[i]) != width:
            raise ValueError(f"exchange: slot {g} has {len(data[i])} buckets, axis has {width}")
        for m, b in enumerate(mesh.peers(g, axis)):
            if b != g:
                moved += data[i][m].numel() * data[i][m].element_size()
    if stage is not None:
        wire.add(stage, moved)

    recv: list = [[None] * width for _ in range(n_local)]
    if not mesh.distributed:
        for i, g in enumerate(mesh.local_slots):
            for m, b in enumerate(mesh.peers(g, axis)):
                j = local_of[b]
                recv[j][mesh.pos(g, axis)] = data[i][m].to(
                    mesh.local_devices[j], non_blocking=True
                )
        return recv

    dist = _group(mesh)
    sample = data[0][0]
    tail = tuple(sample.shape[1:])
    tail_n = int(np.prod(tail)) if tail else 1
    is_bool = sample.dtype == torch.bool
    stage_dev = mesh.comm_device
    # the (src slot, group position) pairs between each pair of processes,
    # ascending; both ends derive the same list from the mesh alone
    send_pairs: list = [[] for _ in range(mesh.n_proc)]
    recv_pairs: list = [[] for _ in range(mesh.n_proc)]
    for a, pa in enumerate(mesh.slot_proc):
        for m, b in enumerate(mesh.peers(a, axis)):
            pb = mesh.slot_proc[b]
            if pa == mesh.proc:
                send_pairs[pb].append((a, m, b))
            if pb == mesh.proc:
                recv_pairs[pa].append((a, m, b))

    send_counts = torch.tensor(
        [data[local_of[a]][m].shape[0] for q in range(mesh.n_proc) for a, m, _b in send_pairs[q]],
        dtype=torch.int64,
    )
    recv_counts = torch.empty(
        sum(len(p) for p in recv_pairs), dtype=torch.int64, device=stage_dev
    )
    dist.all_to_all_single(
        recv_counts, send_counts.to(stage_dev),
        output_split_sizes=[len(p) for p in recv_pairs],
        input_split_sizes=[len(p) for p in send_pairs],
    )
    recv_counts_l = recv_counts.tolist()
    send_counts_l = send_counts.tolist()

    pieces = [
        _wire_dtype(data[local_of[a]][m]).reshape(-1).to(stage_dev, non_blocking=True)
        for q in range(mesh.n_proc) for a, m, _b in send_pairs[q]
    ]
    wire_dtype = torch.uint8 if is_bool else sample.dtype
    send_buf = (
        torch.cat(pieces) if pieces else torch.empty(0, dtype=wire_dtype, device=stage_dev)
    ).contiguous()
    in_splits, off = [], 0
    for q in range(mesh.n_proc):
        n = len(send_pairs[q])
        in_splits.append(sum(send_counts_l[off : off + n]) * tail_n)
        off += n
    out_splits, off = [], 0
    for p in range(mesh.n_proc):
        n = len(recv_pairs[p])
        out_splits.append(sum(recv_counts_l[off : off + n]) * tail_n)
        off += n
    recv_buf = torch.empty(sum(out_splits), dtype=wire_dtype, device=stage_dev)
    dist.all_to_all_single(
        recv_buf, send_buf, output_split_sizes=out_splits, input_split_sizes=in_splits
    )
    pos = 0
    idx = 0
    for p in range(mesh.n_proc):
        for a, m, b in recv_pairs[p]:
            n = recv_counts_l[idx] * tail_n
            idx += 1
            piece = recv_buf[pos : pos + n].reshape((-1,) + tail)
            pos += n
            if is_bool:
                piece = piece.to(torch.bool)
            j = local_of[b]
            recv[j][mesh.pos(a, axis)] = piece.to(
                mesh.local_devices[j], non_blocking=True
            )
    return recv


def all_to_all(mesh: Mesh, buckets: list, stage: str | None = None) -> list:
    """The routed exchange over ``kp``: ``buckets[i][d]`` is what local
    slot ``i`` sends to kp column ``d`` of its dp row, at its exact
    length. Returns ``recv[j][s]``: what kp column ``s`` sent to local
    slot ``j``, on ``j``'s device. With ``stage`` the bytes that changed
    slot are added to :mod:`mcaat_tpu_torch.utils.wire`."""
    return _exchange(mesh, "kp", buckets, stage)


def all_gather_dp(mesh: Mesh, xs: list, stage: str | None = None) -> list:
    """Concatenate each kp column's tensors over ``dp`` (row order), for
    every local slot: the merge of the data-parallel rows."""
    if mesh.dp == 1:
        return list(xs)
    got = _exchange(mesh, "dp", [[x] * mesh.dp for x in xs], stage)
    return [torch.cat(row) for row in got]


def all_gather_host(mesh: Mesh, arr: np.ndarray) -> list[np.ndarray]:
    """One host array from every process, in process order (lengths may
    differ; dtype and trailing shape must not). One process: ``[arr]``."""
    arr = np.ascontiguousarray(arr)
    if not mesh.distributed:
        return [arr]
    dist = _group(mesh)
    dev = mesh.comm_device
    tail = arr.shape[1:]
    as_bool = arr.dtype == np.bool_
    flat = torch.from_numpy(arr.astype(np.uint8) if as_bool else arr).reshape(-1).to(dev)
    n_mine = torch.tensor([flat.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(n_mine) for _ in range(mesh.n_proc)]
    dist.all_gather(sizes, n_mine)
    sizes_l = [int(s.item()) for s in sizes]
    m = max(max(sizes_l), 1)
    pad = torch.zeros(m, dtype=flat.dtype, device=dev)
    pad[: flat.shape[0]] = flat
    bufs = [torch.empty_like(pad) for _ in range(mesh.n_proc)]
    dist.all_gather(bufs, pad)
    out = []
    for p in range(mesh.n_proc):
        a = bufs[p][: sizes_l[p]].cpu().numpy().reshape((-1,) + tuple(tail))
        out.append(a.astype(np.bool_) if as_bool else a)
    return out


def np_dtype(t: torch.Tensor):
    """The numpy dtype a tensor's host copy has."""
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def host_shards(mesh: Mesh, xs: list) -> list[np.ndarray]:
    """Host numpy copy of a per-slot list of tensors, one array per kp
    shard, identical on every process (each kp shard is read from its dp
    row 0 replica). For node-proportional masks and ids, never for
    adjacency-sized tensors."""
    mine = {mesh.local_kp[i]: xs[i].cpu().numpy() for i in mesh.primary}
    if not mesh.distributed:
        return [mine[s] for s in range(mesh.kp)]
    sizes = np.zeros(mesh.kp, dtype=np.int64)
    for s, a in mine.items():
        sizes[s] = a.shape[0]
    data = (
        np.concatenate([mine[s] for s in sorted(mine)])
        if mine else np.zeros((0,) + tuple(xs[0].shape[1:]), dtype=np_dtype(xs[0]))
    )
    all_sizes = all_gather_host(mesh, sizes)
    all_data = all_gather_host(mesh, data)
    out, offs = [], [0] * mesh.n_proc
    for s in range(mesh.kp):
        p = mesh.slot_proc[s]  # the process that drives shard s of dp row 0
        n = int(all_sizes[p][s])
        out.append(all_data[p][offs[p] : offs[p] + n])
        offs[p] += n
    return out


def host_replicated(mesh: Mesh, xs: list) -> np.ndarray:
    """The kp shards of :func:`host_shards` concatenated in shard order."""
    return np.concatenate(host_shards(mesh, xs))


def psum(mesh: Mesh, value):
    """Sum of one host value (int, float or numpy array) per process."""
    if not mesh.distributed:
        return value
    parts = all_gather_host(mesh, np.atleast_1d(np.asarray(value)))
    total = sum(parts[1:], parts[0])
    return total if np.ndim(value) else total[0].item()


def barrier(mesh: Mesh) -> None:
    """Wait until every process of the mesh has arrived."""
    if mesh.distributed:
        psum(mesh, 0)
