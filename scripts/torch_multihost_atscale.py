"""The whole multi-process pipeline of the torch port at scale: the
counterpart of ``scripts/multihost_atscale.py``.

Two processes of four shards each (``MCAAT_TORCH_SHARDS=4``), one card a
process over NCCL, so the mesh is ``dp=1, kp=8`` and the k-mer space of
every exchange spans both processes. The input is the JAX script's:
``make_metagenome(seed=97, n_arrays=20, n_spacers=6, coverage=30.0,
background_coverage=4.0)`` with the background length of
``MCAAT_AS_BACKGROUND`` (default 35,152,500 bp, which gives the 1,412,200
reads of the JAX package's record and a graph of 67.2M nodes).

Each process runs ``run_pipeline_multihost`` and prints the live rows
per shard, its stages (``stats_out["stages"]``), its exchanged bytes per
stage and the peak of its card. The parent then runs the single-process
single-card build and pipeline on the same reads and requires the node
table (k-mers and multiplicities, SHA-1 over the gathered columns) and
``CRISPR_Arrays.txt`` to be equal byte for byte.

Usage:  python3 scripts/torch_multihost_atscale.py [--json PATH] [--cpu]

It needs two cards and stops with an error when it sees fewer.
``--cpu`` rehearses the same run over gloo with CPU shards (set
``MCAAT_AS_BACKGROUND`` small: it is for finding faults, not for
figures).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

N_PROC = 2
LOCAL_SHARDS = 4
BACKGROUND = 35_152_500
TIMEOUT_S = 600  # seconds a collective may wait before the run fails


def node_table_sha(kmers, mult) -> dict:
    """SHA-1 (16 hex digits) of the k-mer and multiplicity columns as
    int64 and int32 bytes, and the row count."""
    import numpy as np

    km = np.ascontiguousarray(kmers, dtype=np.int64)
    mu = np.ascontiguousarray(mult, dtype=np.int32)
    return {
        "n_nodes": int(km.size),
        "kmers_sha1": hashlib.sha1(km.tobytes()).hexdigest()[:16],
        "mult_sha1": hashlib.sha1(mu.tobytes()).hexdigest()[:16],
    }


def card_line() -> list[str]:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def parent(args, tmpdir: str) -> int:
    import torch

    device = "cpu" if args.cpu else "cuda"
    if not args.cpu:
        if not torch.cuda.is_available() or torch.cuda.device_count() < N_PROC:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"torch_multihost_atscale: needs {N_PROC} CUDA cards, sees {n}", file=sys.stderr)
            return 1
        cards = card_line()
    else:
        cards = ["cpu (no device figures)"]
    print(f"cards: {cards}", flush=True)

    from synthetic import make_metagenome, write_fastq

    background = int(os.environ.get("MCAAT_AS_BACKGROUND", str(BACKGROUND)))
    t0 = time.perf_counter()
    meta = make_metagenome(
        seed=97, n_arrays=20, n_spacers=6, coverage=30.0,
        background_len=background, background_coverage=4.0,
    )
    fq = os.path.join(tmpdir, "reads.fq")
    write_fastq(fq, meta["reads"])
    n_reads = len(meta["reads"])
    del meta
    print(f"generated {n_reads} reads (background {background / 1e6:.1f} Mbp) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    t_mh = time.perf_counter()
    for pid in range(N_PROC):
        env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
        env.update(
            MCAAT_TORCH_DEVICE=device, MCAAT_TORCH_SHARDS=str(LOCAL_SHARDS),
            MCAAT_COORDINATOR=f"localhost:{port}", MCAAT_NUM_PROCESSES=str(N_PROC),
            MCAAT_PROCESS_ID=str(pid), MCAAT_DIST_TIMEOUT_S=str(TIMEOUT_S),
            MCAAT_AS_FASTQ=fq,
        )
        if args.cpu:
            env["OMP_NUM_THREADS"] = "2"
        else:
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
        # the children move in lockstep through collectives: their output
        # goes to files, since pipes read one after the other could fill
        log = open(os.path.join(tmpdir, f"child{pid}.log"), "w+")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT, text=True), log))
    stats = [None] * N_PROC
    ok = True
    try:
        for pid, (p, log) in enumerate(procs):
            p.wait(timeout=10 * TIMEOUT_S)
            log.seek(0)
            text = log.read()
            for line in text.splitlines():
                if line.startswith("ATSCALE_STATS "):
                    stats[pid] = json.loads(line[len("ATSCALE_STATS "):])
            if p.returncode != 0 or stats[pid] is None:
                ok = False
                print(f"--- child {pid} (rc={p.returncode}) ---\n{text[-6000:]}", flush=True)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    mh_wall = time.perf_counter() - t_mh
    if not ok:
        return 1
    print(f"the process group finished in {mh_wall:.1f}s", flush=True)
    for pid, st in enumerate(stats):
        print(f"process {pid}: mesh {st['mesh']}, live rows per shard {st['live_rows_per_shard']}, "
              f"build {st['build_wall_s']}s, pipeline {st['pipeline_wall_s']:.2f}s, "
              f"device peak {st['device_peak_gib']} GiB, host RSS peak {st['peak_rss_gb']} GB", flush=True)
        for s in st["stages"]:
            peak = s["device_peak_mb"]
            print(f"   {s['name']:<16} {s['seconds']:8.3f}s  peak "
                  f"{'-' if peak is None else f'{peak / 1024:.2f} GiB'}  {s['counters']}", flush=True)
        print("   exchanged: " + ", ".join(
            f"{k} {v['bytes'] / 1e6:.1f} MB in {v['calls']}" for k, v in st["wire"].items()),
            flush=True)

    # the single-process, single-card reference on the same reads
    from mcaat_tpu_torch.graph.dbg import build_dbg_from_reads
    from mcaat_tpu_torch.io.fastq import read_encoded_batch
    from mcaat_tpu_torch.pipeline import run_pipeline
    from mcaat_tpu_torch.settings import Settings

    dev = torch.device(device if args.cpu else "cuda:0")
    t_sp = time.perf_counter()
    batch = read_encoded_batch(fq)
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23, device=dev)
    ref_table = node_table_sha(g.kmers.cpu().numpy(), g.mult.cpu().numpy())
    del g, batch
    ref = run_pipeline(
        Settings(input_files=fq, output_file=os.path.join(tmpdir, "sp_CRISPR_Arrays.txt"), mesh="off"),
        verbose=False, device=dev,
    )
    sp_wall = time.perf_counter() - t_sp
    with open(os.path.join(tmpdir, "mh_CRISPR_Arrays.txt")) as fh:
        mh_text = fh.read()
    report_parity = mh_text == ref.report_text and bool(mh_text)
    table_parity = all(st["node_table"] == ref_table for st in stats)
    out = {
        "cards": cards, "n_reads": n_reads, "background_len": background,
        "n_processes": N_PROC, "local_shards": LOCAL_SHARDS, "group_wall_s": mh_wall,
        "singleprocess_wall_s": sp_wall, "singleprocess_node_table": ref_table,
        "singleprocess_stages": json.loads(ref.profile.to_json()),
        "n_systems": len(ref.found_systems), "children": stats,
        "node_table_parity": table_parity, "report_parity": report_parity,
    }
    print(f"single process, one card: {ref_table}, {len(ref.found_systems)} systems, "
          f"{sp_wall:.1f}s with its build", flush=True)
    print(json.dumps({k: v for k, v in out.items() if k not in ("children", "singleprocess_stages")}),
          flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    if not (report_parity and table_parity):
        print(f"PARITY FAILURE: node table {table_parity}, report {report_parity}", flush=True)
        return 1
    print("MULTIHOST ATSCALE PASSED", flush=True)
    return 0


def child() -> int:
    import resource

    import torch

    from mcaat_tpu_torch.parallel import sharded_graph
    from mcaat_tpu_torch.parallel.exchange import host_replicated
    from mcaat_tpu_torch.parallel.multihost import initialize_distributed, run_pipeline_multihost
    from mcaat_tpu_torch.settings import Settings

    if os.environ["MCAAT_TORCH_DEVICE"] == "cpu":
        torch.set_num_threads(2)
    assert initialize_distributed(), "the process group did not come up"
    import torch.distributed as dist

    pid = dist.get_rank()
    fq = os.environ["MCAAT_AS_FASTQ"]
    s = Settings(input_files=fq, output_file=os.path.join(os.path.dirname(fq), "mh_CRISPR_Arrays.txt"))
    # keep the sharded graph the pipeline builds, for the node table below
    built: dict = {}
    build = sharded_graph.build_sharded_dbg

    def keep(mesh, *a, **kw):
        built["mesh"], built["sg"] = mesh, build(mesh, *a, **kw)
        return built["sg"]

    sharded_graph.build_sharded_dbg = keep
    stats: dict = {}
    t0 = time.perf_counter()
    try:
        result = run_pipeline_multihost(s, verbose=False, stats_out=stats)
    finally:
        sharded_graph.build_sharded_dbg = build
    stats["pipeline_wall_s"] = time.perf_counter() - t0
    peaks = [st["device_peak_mb"] for st in stats["stages"] if st["device_peak_mb"] is not None]
    stats["device_peak_gib"] = round(max(peaks) / 1024, 3) if peaks else None
    mesh, sg = built["mesh"], built["sg"]
    # every process enters both gathers
    stats["node_table"] = node_table_sha(host_replicated(mesh, sg.kmers), host_replicated(mesh, sg.mult))
    stats["peak_rss_gb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2)
    if pid == 0:
        assert result is not None and result.report_text
        stats["n_systems"] = len(result.found_systems)
    print("ATSCALE_STATS " + json.dumps(stats), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the figures to this file")
    ap.add_argument("--cpu", action="store_true", help="gloo and CPU shards, for a rehearsal")
    return ap.parse_args(argv)


def main() -> int:
    if "MCAAT_PROCESS_ID" in os.environ:
        return child()
    args = parse_args(sys.argv[1:])
    tmpdir = tempfile.mkdtemp(prefix="mcaat_torch_atscale_")
    try:
        return parent(args, tmpdir)
    finally:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
