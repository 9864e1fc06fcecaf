"""Multi-process dry run of the torch port on one machine: by default 2
processes of 4 CPU shards each over gloo; with ``--cuda`` one card a
process over NCCL.

Parent mode (no ``MCAAT_PROCESS_ID``): writes a deterministic synthetic
FASTQ (or takes ``--fastq``), spawns the children wired through the
``MCAAT_*`` variables with a ``file://`` rendezvous in the work directory
(no TCP port is taken), and checks that all report OK and that the report
process 0 wrote equals the single-device report of the same input, byte
for byte.

Child mode: initialises the process group, builds the GLOBAL ("dp","kp")
mesh (kp spans all processes), reads its own record range, runs the
distributed count → build with the kp ``all_to_all`` CROSSING the process
boundary, checks the node table against a one-process reference build,
runs one cross-process frontier expansion, then the FULL pipeline whose
downstream (prune, candidate scan, neighbourhood extraction, routed read
mapping, region condensation) replays the same host loop on every
process.

Every collective has a timeout (``MCAAT_DIST_TIMEOUT_S``, 60 s here), so
a process that misses a collective fails the run within a minute.

Usage:  python scripts/torch_multihost_dryrun.py [workdir] [--procs N]
            [--shards M] [--cuda] [--fastq reads.fq] [--k K]

``--cuda`` gives child ``p`` the card ``p`` alone (``CUDA_VISIBLE_DEVICES``)
and needs as many cards as processes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

TIMEOUT_S = 60


def parse_args(argv: list[str]):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards", type=int, default=4, help="local shards of each process")
    ap.add_argument("--cuda", action="store_true", help="one card a process, NCCL")
    ap.add_argument("--fastq", help="an input to use instead of the synthetic one")
    ap.add_argument("--k", type=int, default=13, help="k of the build check")
    return ap.parse_args(argv)


def parent(args) -> int:
    from synthetic import make_metagenome, write_fastq

    tmpdir = args.workdir or tempfile.mkdtemp(prefix="mcaat_torch_mh_")
    os.makedirs(tmpdir, exist_ok=True)
    fq = args.fastq
    if fq is None:
        meta = make_metagenome(
            seed=41,
            n_arrays=int(os.environ.get("MCAAT_MH_ARRAYS", "1")),
            n_spacers=4,
            coverage=25.0,
            background_len=int(os.environ.get("MCAAT_MH_BACKGROUND", "2000")),
        )
        fq = os.path.join(tmpdir, "reads.fq")
        write_fastq(fq, meta["reads"])
    store = os.path.join(tmpdir, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    device = "cuda" if args.cuda else "cpu"

    procs = []
    for pid in range(args.procs):
        env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
        env["MCAAT_TORCH_DEVICE"] = device
        env["MCAAT_TORCH_SHARDS"] = str(args.shards)
        env["MCAAT_COORDINATOR"] = f"file://{store}"
        env["MCAAT_NUM_PROCESSES"] = str(args.procs)
        env["MCAAT_PROCESS_ID"] = str(pid)
        env["MCAAT_DIST_TIMEOUT_S"] = str(TIMEOUT_S)
        env["MCAAT_MH_FASTQ"] = fq
        env["MCAAT_MH_OUT"] = tmpdir
        env["MCAAT_MH_K"] = str(args.k)
        if args.cuda:
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
        else:
            env["OMP_NUM_THREADS"] = "2"
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    ok = True
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=10 * TIMEOUT_S)
            if (
                p.returncode != 0
                or f"MULTIHOST OK pid={pid}" not in out
                or f"MULTIHOST PIPELINE OK pid={pid}" not in out
            ):
                ok = False
                print(f"--- child {pid} (rc={p.returncode}) ---")
                print(out[-4000:])
            elif pid == 0:
                print("\n".join(x for x in out.splitlines() if x.startswith(("mesh ", "wire:"))))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if not ok:
        return 1

    # the report of the process group must equal the single-device report
    from mcaat_tpu_torch.pipeline import run_pipeline
    from mcaat_tpu_torch.settings import Settings

    s = Settings()
    s.input_files = fq
    s.output_file = os.path.join(tmpdir, "sp_CRISPR_Arrays.txt")
    s.mesh = "off"
    ref = run_pipeline(s, verbose=False, device=device)
    with open(os.path.join(tmpdir, "mh_CRISPR_Arrays.txt")) as fh:
        mh_text = fh.read()
    if mh_text != ref.report_text or not mh_text:
        print("MISMATCH: multi-process report != single-device report")
        return 1
    print("MULTIHOST DRYRUN PASSED (pipeline report identical to single-device)")
    return 0


def child() -> int:
    import numpy as np
    import torch

    torch.set_num_threads(2)
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads
    from mcaat_tpu_torch.io.fastq import read_encoded_batch
    from mcaat_tpu_torch.parallel.exchange import host_replicated
    from mcaat_tpu_torch.parallel.multihost import (
        host_local_rows_to_global,
        initialize_distributed,
        make_global_mesh,
        make_host_mesh,
        read_host_shard,
        run_pipeline_multihost,
    )
    from mcaat_tpu_torch.parallel.sharded_graph import (
        build_sharded_dbg,
        frontier_step,
        tag_adjacency,
    )
    from mcaat_tpu_torch.settings import Settings

    N_PROC = int(os.environ["MCAAT_NUM_PROCESSES"])
    LOCAL_SHARDS = int(os.environ["MCAAT_TORCH_SHARDS"])
    K = int(os.environ["MCAAT_MH_K"])
    assert initialize_distributed(), "distributed init failed"
    hmesh = make_host_mesh()
    assert hmesh.shape["dp"] == N_PROC and hmesh.shape["kp"] <= LOCAL_SHARDS, hmesh.shape
    # the production mesh: kp spans ALL processes' shards
    mesh = make_global_mesh()
    pid, n_proc = mesh.proc, mesh.n_proc
    assert n_proc == N_PROC, (n_proc, N_PROC)
    assert mesh.dp * mesh.kp == N_PROC * LOCAL_SHARDS, mesh.shape
    assert mesh.n_local == LOCAL_SHARDS
    dev = mesh.local_devices[0]

    fq = os.environ["MCAAT_MH_FASTQ"]
    batch = read_host_shard(fq, pid, n_proc)
    assert batch.num_reads > 0, "empty process shard"
    rows = host_local_rows_to_global(mesh, batch.codes, batch.lengths)
    assert len(rows) == LOCAL_SHARDS

    sg = build_sharded_dbg(mesh, batch.codes, batch.lengths, k=K)
    # the table is truly sharded: this process holds its own kp shards only
    assert len(sg.kmers) == LOCAL_SHARDS
    assert sg.T == int(sg.n_live.max())
    if mesh.dp == 1:
        assert sum(int(u.shape[0]) for u in sg.kmers) < sg.n_nodes

    kmers_h = host_replicated(mesh, sg.kmers)
    mult_h = host_replicated(mesh, sg.mult)
    full = read_encoded_batch(fq)
    ref = build_dbg_from_reads(
        full.codes, full.lengths, k=K, add_reverse_complement=False, device=dev
    )
    assert np.array_equal(kmers_h, ref.kmers.cpu().numpy()), "node table mismatch"
    assert np.array_equal(mult_h, ref.mult.cpu().numpy()), "multiplicity mismatch"
    del ref

    # one cross-process frontier expansion on replicated seed ids
    gids = np.concatenate(
        [s * sg.T + np.arange(min(int(n), 4)) for s, n in enumerate(sg.n_live)]
    )
    outv = tag_adjacency(mesh, sg.out, sg.valid, sg.T)
    nbrs = frontier_step(mesh, outv, gids, sg.T)
    n_exp = int((nbrs >= 0).sum())
    assert n_exp > 0, "frontier expanded nothing"
    print(
        f"MULTIHOST OK pid={pid}: {len(kmers_h)} nodes, process shard "
        f"{batch.num_reads} reads, frontier expanded {n_exp}",
        flush=True,
    )

    s = Settings()
    s.input_files = fq
    s.output_file = os.path.join(os.environ["MCAAT_MH_OUT"], "mh_CRISPR_Arrays.txt")
    stats: dict = {}
    result = run_pipeline_multihost(s, verbose=False, stats_out=stats)
    if pid == 0:
        assert result is not None and result.report_text
        print(f"MULTIHOST PIPELINE OK pid=0: {len(result.found_systems)} systems")
        print(f"mesh {stats['mesh']}, rows per shard {stats['live_rows_per_shard']}, "
              f"stages {[(st['name'], round(st['seconds'], 3), st['counters']) for st in stats['stages']]}, "
              f"device {dev}")
        print(f"wire: {stats['wire']}")
    else:
        assert result is None
        print(f"MULTIHOST PIPELINE OK pid={pid}")
    return 0


if __name__ == "__main__":
    if "MCAAT_PROCESS_ID" in os.environ:
        sys.exit(child())
    sys.exit(parent(parse_args(sys.argv[1:])))
