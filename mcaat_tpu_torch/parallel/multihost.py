"""Several processes: process-group setup, the mesh over all of them,
per-process input ranges and the pipeline entry.

Port of ``mcaat_tpu/parallel/multihost.py``. The reference is one
process with no distributed backend (SURVEY §2.3); its ceiling is one
node's RAM. Here one process runs per host (or per card):

* :func:`initialize_distributed` brings up ``torch.distributed`` from
  ``MCAAT_COORDINATOR`` / ``MCAAT_NUM_PROCESSES`` / ``MCAAT_PROCESS_ID``
  (``nccl`` when the run's device is CUDA, ``gloo`` on the CPU).
* :func:`make_global_mesh` builds the ("dp", "kp") mesh over ALL
  processes' shards with ``kp`` as large as possible, so the k-mer space
  radix-partitions over every shard of every process;
  :func:`make_host_mesh` stacks the processes along ``dp`` instead.
* :func:`read_host_shard` gives each process its share of the input
  records: contiguous byte ranges for plain files (a record-boundary
  scan, no process reads more than its slice), modulo-record assignment
  for gzip streams (not seekable).
* :func:`run_pipeline_multihost` runs the whole pipeline with the graph
  sharded over every process; process 0 writes the report.

A process takes the cards it can see. With NCCL the supported layout is
one card a process (several shards on it with ``MCAAT_TORCH_SHARDS``).

Tested by ``scripts/torch_multihost_dryrun.py`` (2 processes of 4 CPU
shards each over gloo) via ``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mcaat_tpu_torch import resolve_device
from mcaat_tpu_torch.parallel.exchange import Mesh, all_gather_host, barrier
from mcaat_tpu_torch.parallel.sharded import default_devices, mesh_dims


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Initialise ``torch.distributed`` if a run over several processes
    is configured.

    ``coordinator`` (or ``MCAAT_COORDINATOR``) is ``host:port`` or a
    ``file://`` path every process can reach; the backend is ``nccl``
    when the run's device is CUDA and ``gloo`` on the CPU; a missing
    backend raises. ``timeout_s`` (or ``MCAAT_DIST_TIMEOUT_S``) bounds
    every collective, so a process that never arrives fails the others
    instead of hanging them. Returns True when more than one process
    runs, False for a one-process run (nothing is initialised when
    neither a coordinator nor a process count is given). Safe to call
    twice.
    """
    import datetime

    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MCAAT_COORDINATOR")
    if num_processes is None and "MCAAT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MCAAT_NUM_PROCESSES"])
    if process_id is None and "MCAAT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MCAAT_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "a run over several processes needs MCAAT_COORDINATOR, "
            "MCAAT_NUM_PROCESSES and MCAAT_PROCESS_ID"
        )
    dev = resolve_device(device)
    if timeout_s is None and "MCAAT_DIST_TIMEOUT_S" in os.environ:
        timeout_s = float(os.environ["MCAAT_DIST_TIMEOUT_S"])
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        kwargs["device_id"] = torch.device("cuda", dev.index or 0)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=coordinator if "://" in coordinator else f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )
    return num_processes > 1


def _process_layout(device=None):
    """``(proc, n_proc, local devices, shard count of every process)`` of
    the initialised process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call initialize_distributed (MCAAT_COORDINATOR, "
            "MCAAT_NUM_PROCESSES, MCAAT_PROCESS_ID) first"
        )
    proc, n_proc = dist.get_rank(), dist.get_world_size()
    devices = default_devices(device)
    # a bootstrap mesh of one slot per process, only to share the counts
    boot = Mesh(
        dp=n_proc, kp=1, slot_proc=tuple(range(n_proc)), local_devices=(devices[0],),
        proc=proc, n_proc=n_proc, distributed=True,
    )
    counts = [int(c[0]) for c in all_gather_host(boot, np.asarray([len(devices)], np.int64))]
    return proc, n_proc, devices, counts


def make_host_mesh(device=None) -> Mesh:
    """("dp", "kp") mesh over all processes: the processes stack along dp
    and each one's local shards form the kp axis (cut to a power of two,
    the same for all, by dropping trailing local shards if needed)."""
    proc, n_proc, devices, counts = _process_layout(device)
    n_local = min(counts)
    kp = 1 << (n_local.bit_length() - 1)  # pow2 floor
    slot_proc = tuple(p for p in range(n_proc) for _ in range(kp))
    return Mesh(
        dp=n_proc, kp=kp, slot_proc=slot_proc, local_devices=tuple(devices[:kp]),
        proc=proc, n_proc=n_proc, distributed=True,
    )


def make_global_mesh(device=None) -> Mesh:
    """("dp", "kp") mesh over ALL processes' shards with kp as large a
    power of two as possible: with a power-of-two shard count dp=1 and
    the k-mer space radix-partitions over every shard of every process,
    so per-process graph memory is O(N / total shards). Slots are ordered
    by process, so each process's shards are contiguous along kp."""
    proc, n_proc, devices, counts = _process_layout(device)
    dp, kp = mesh_dims(sum(counts))
    slot_proc = tuple(p for p, c in enumerate(counts) for _ in range(c))
    return Mesh(
        dp=dp, kp=kp, slot_proc=slot_proc, local_devices=tuple(devices),
        proc=proc, n_proc=n_proc, distributed=True,
    )


# ---------------------------------------------------------------------------
# Per-process input ranges
# ---------------------------------------------------------------------------


def _find_fastq_boundary(buf: bytes, is_fasta: bool) -> int:
    """Offset of the first record start at/after position 0 in ``buf``.

    FASTA: next line starting with '>'. FASTQ: a line starting with '@'
    whose line+2 starts with '+' ('@' alone is ambiguous — it can open a
    quality line)."""
    if is_fasta:
        if buf.startswith(b">"):
            return 0
        i = buf.find(b"\n>")
        return i + 1 if i >= 0 else len(buf)
    pos = 0
    n = len(buf)
    while pos < n:
        if (pos == 0 or buf[pos - 1 : pos] == b"\n") and buf[pos : pos + 1] == b"@":
            # verify: line after next starts with '+'
            e1 = buf.find(b"\n", pos)
            e2 = buf.find(b"\n", e1 + 1) if e1 >= 0 else -1
            if e2 >= 0 and buf[e2 + 1 : e2 + 2] == b"+":
                return pos
            if e1 < 0:
                break
        nxt = buf.find(b"\n", pos)
        if nxt < 0:
            break
        pos = nxt + 1
    return n


def host_byte_range(path: str, process_id: int, num_processes: int):
    """(start, end) byte range of this process's slice of a PLAIN text
    file, aligned to record boundaries (start included, end exclusive;
    the record containing ``end`` belongs to the next process)."""
    size = os.path.getsize(path)
    lo = size * process_id // num_processes
    hi = size * (process_id + 1) // num_processes
    with open(path, "rb") as fh:
        is_fasta = fh.read(1) == b">"

        def align(off):
            if off == 0:
                return 0
            # scan windows until a record start is found: one 1 MB window
            # is not enough for e.g. FASTA contigs over 1 MB. Windows
            # overlap by 64 KB so FASTQ's 2-line lookahead (and a '\n>'
            # split across windows) cannot straddle a window edge.
            pos = off
            while pos < size:
                fh.seek(pos)
                window = fh.read(1 << 20)
                i = _find_fastq_boundary(window, is_fasta)
                if i < len(window):
                    return pos + i
                step = len(window) - (1 << 16)
                if step <= 0:
                    break
                pos += step
            return size

        return align(lo), align(hi)


def read_host_shard(path: str, process_id: int, num_processes: int):
    """This process's share of the file's records as a ReadBatch.

    Plain files: a contiguous byte range (each process reads only its
    slice). Gzip: stream-parse everything, keep records
    ``process_id::num_processes`` (gzip streams are not seekable; IO is
    replicated but memory is not).
    """
    from mcaat_tpu_torch.io.fastq import (
        ReadBatch,
        encode_sequences,
        parse_fastx_chunk,
        read_encoded_batch,
    )

    if num_processes <= 1:
        return read_encoded_batch(path)
    if path.endswith(".gz"):
        b = read_encoded_batch(path)
        sel = np.arange(process_id, b.num_reads, num_processes)
        return ReadBatch(codes=b.codes[sel], lengths=b.lengths[sel])
    lo, hi = host_byte_range(path, process_id, num_processes)
    with open(path, "rb") as fh:
        fh.seek(lo)
        chunk = fh.read(hi - lo)
    # byte ranges are record-aligned, so a chunk is just a smaller file
    return encode_sequences(parse_fastx_chunk(chunk))


def host_local_rows_to_global(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray):
    """Deal this process's read rows over its local slots, padded to a
    row count and read length common to all processes (the maximum,
    rounded up to a multiple of the local slot count; zero-length pad
    rows contribute no window). Returns ``[(codes, lengths)]`` device
    tensors per local slot."""
    from mcaat_tpu_torch.parallel.sharded import split_rows

    R, L = codes.shape
    maxes = np.stack(all_gather_host(mesh, np.asarray([R, L], dtype=np.int64)))
    R_max, L_max = int(maxes[:, 0].max()), int(maxes[:, 1].max())
    rows = (R_max + mesh.n_local - 1) // mesh.n_local * mesh.n_local
    codes_p = np.zeros((rows, L_max), dtype=np.uint8)
    codes_p[:R, :L] = codes
    lengths_p = np.zeros((rows,), dtype=np.int32)
    lengths_p[:R] = lengths
    return split_rows(mesh, codes_p, lengths_p)


# ---------------------------------------------------------------------------
# The pipeline over a process group
# ---------------------------------------------------------------------------


def run_pipeline_multihost(settings, verbose: bool = True,
                           stats_out: dict | None = None, device=None):
    """Full pipeline across the processes of the group, the graph SHARDED
    over every process's shards end to end (no replication, no
    full-graph compaction).

    The build distributes over the global ("dp","kp") mesh: each process
    reads only its own record range of the input files, and k-mers route
    to their owner shards over kp, which spans the processes. The
    downstream then runs through ``run_sharded_downstream``: every
    process replays the same host orchestration over the same
    collectives, so per-process memory stays O(N / total shards) on the
    device plus the two CRISPR-content-sized compactions (candidate
    neighbourhood, cycle region) on the host. Process 0 writes the
    report; every process computes the same result. Returns a
    PipelineResult on process 0, None on the others.

    ``stats_out`` (a dict) is filled with the build's seconds, the rows
    per shard, the stages in order (``Profiler.to_json``'s list: name,
    seconds, counters, host RSS, device peak), the exchanged bytes per stage
    (``wire``) and a SHA-1 of the node table; the hash gathers the k-mer
    column on every host, so it is for checks at test size only.
    """
    import time

    from mcaat_tpu_torch.io.fastq import reverse_complement_batch
    from mcaat_tpu_torch.parallel.sharded_graph import build_sharded_dbg
    from mcaat_tpu_torch.parallel.sharded_pipeline import (
        _FILE_KEY,
        MapSource,
        run_sharded_downstream,
    )
    from mcaat_tpu_torch.pipeline import _concat_batches
    from mcaat_tpu_torch.utils import wire
    from mcaat_tpu_torch.utils.profiling import Profiler

    mesh = make_global_mesh(device)
    pid, n_proc = mesh.proc, mesh.n_proc
    prof = Profiler(mesh.local_devices)
    wire.reset()

    # per-process record ranges of every input file, kept for the mapper:
    # each process later maps ONLY its own record range, with no re-parse
    with prof.stage("parse_input"):
        batches = [
            (path, read_host_shard(path, pid, n_proc)) for path in settings.input_file_list()
        ]
        if any(b.num_reads for _p, b in batches):
            codes, lengths = _concat_batches(batches)
        else:
            codes, lengths = np.zeros((0, 0), np.uint8), np.zeros(0, np.int32)

    t_build = time.perf_counter()
    with prof.stage("graph_build"):
        sg = build_sharded_dbg(
            mesh, codes, lengths, k=23, add_rc=settings.add_reverse_complement,
        )
    # the mapper reuses the per-file batches, never this concatenated copy
    del codes, lengths
    if stats_out is not None:
        import hashlib

        from mcaat_tpu_torch.parallel.exchange import host_replicated

        stats_out["build_wall_s"] = round(time.perf_counter() - t_build, 2)
        stats_out["mesh"] = dict(mesh.shape)
        stats_out["n_processes"] = n_proc
        stats_out["live_rows_per_shard"] = sg.n_live.tolist()
        stats_out["shard_capacity"] = sg.shard_capacity
        stats_out["n_parts"] = sg.n_parts
        live_km = host_replicated(mesh, sg.kmers)
        stats_out["node_table_sha1"] = hashlib.sha1(live_km.tobytes()).hexdigest()[:16]
        stats_out["n_nodes"] = int(live_km.size)
    if verbose and pid == 0:
        print(
            f"Graph built over {dict(mesh.shape)} ({n_proc} process(es), "
            f"sharded, no replication): {sg.n_nodes} nodes"
        )

    # Order keys are the global record indices: contiguous byte ranges
    # stack by process for plain files, gz streams assign records
    # pid::n_proc (read_host_shard).
    batch_by_path: dict = {}
    for path, b in batches:
        batch_by_path.setdefault(path, b)
    f1, f2 = settings.fastq_files()

    def _global_indices(path, b):
        R = b.num_reads
        if path.endswith(".gz") and n_proc > 1:
            return pid + np.arange(R, dtype=np.int64) * n_proc
        counts = np.concatenate(all_gather_host(mesh, np.asarray([R], dtype=np.int64)))
        return int(counts[:pid].sum()) + np.arange(R, dtype=np.int64)

    sources = [MapSource(batch_by_path[f1], _global_indices(f1, batch_by_path[f1]), sg.k)]
    if f2:
        sources.append(
            MapSource(
                reverse_complement_batch(batch_by_path[f2]),
                _FILE_KEY + _global_indices(f2, batch_by_path[f2]),
                sg.k,
            )
        )
    # the MapSources hold the only references the mapper needs
    del batches, batch_by_path

    result = run_sharded_downstream(
        sg, settings, verbose=verbose and pid == 0, write_report=pid == 0,
        map_sources=sources, profiler=prof,
    )
    if stats_out is not None:
        import json

        stats_out["stages"] = json.loads(prof.to_json())
        stats_out["wire"] = wire.snapshot()
    barrier(mesh)
    return result if pid == 0 else None
