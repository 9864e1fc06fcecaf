"""Several processes: per-process input ranges against the JAX package's,
and the real 2-process dry run.

The three range cases mirror ``tests/test_multihost.py`` and hold the
port's ``host_byte_range`` / ``read_host_shard`` (pure host code, its own
copy) against the JAX package's on the same files: equal byte ranges and
equal code matrices. The JAX package's 2-process dry run is marked
``slow``; the port's runs here for real (2 gloo processes of 4 CPU shards,
rendezvous through a file under ``tmp_path``, a one-minute timeout on
every collective) and must write the single-device report.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcaat_tpu.parallel.multihost as jmh
import mcaat_tpu_torch.parallel.multihost as tmh
from tests.synthetic import make_metagenome, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_shards(path, n_proc):
    """Every process's shard equals the JAX package's, and together they
    cover every record once."""
    from mcaat_tpu_torch.io.fastq import read_encoded_batch

    full = read_encoded_batch(path)
    rows = []
    for pid in range(n_proc):
        want = jmh.read_host_shard(path, pid, n_proc)
        got = tmh.read_host_shard(path, pid, n_proc)
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        rows.extend(tuple(got.codes[i, : got.lengths[i]]) for i in range(got.num_reads))
    assert sorted(rows) == sorted(
        tuple(full.codes[i, : full.lengths[i]]) for i in range(full.num_reads)
    )


def test_host_ranges_partition_fastq(tmp_path):
    meta = make_metagenome(seed=31, n_arrays=1, n_spacers=3, coverage=10.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    for n_proc in (2, 3, 4):
        _same_shards(fq, n_proc)
        bounds = [tmh.host_byte_range(fq, p, n_proc) for p in range(n_proc)]
        assert bounds == [jmh.host_byte_range(fq, p, n_proc) for p in range(n_proc)]
        # byte ranges are disjoint and cover the file
        assert bounds[0][0] == 0 and bounds[-1][1] == os.path.getsize(fq)
        for (_a, b), (c, _d) in zip(bounds, bounds[1:]):
            assert b == c


def test_host_ranges_partition_fasta(tmp_path):
    fa = str(tmp_path / "r.fa")
    rng = np.random.default_rng(5)
    with open(fa, "w") as fh:
        for i in range(57):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=80))
            fh.write(f">read{i}\n{seq[:40]}\n{seq[40:]}\n")
    _same_shards(fa, 2)
    _same_shards(fa, 3)


def test_host_ranges_gzip_modulo(tmp_path):
    meta = make_metagenome(seed=32, n_arrays=1, n_spacers=3, coverage=5.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    gz = fq + ".gz"
    with open(fq, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    _same_shards(gz, 2)


@pytest.mark.parametrize(
    "scale,extra_env,extra_args,stage",
    [
        # the small input: full distributed prune, windows routed to the shards
        ("small", {}, [], "chain_collapse"),
        # over a million nodes: lazy clip and region-first mapping
        ("lazy", {"MCAAT_MH_BACKGROUND": "600000", "MCAAT_MH_ARRAYS": "2"}, ["--k", "23"],
         "region_table"),
        # three processes of two shards: dp=3 replicas of a kp=2 graph
        ("dp3", {}, ["--procs", "3", "--shards", "2"], "read_lookup"),
    ],
)
def test_two_process_dryrun(tmp_path, scale, extra_env, extra_args, stage):
    """Gloo processes of CPU shards on this machine (2 of 4 shards, or 3
    of 2): the count → build collectives and the whole sharded downstream
    across process boundaries, the report equal to the single-device
    one."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MCAAT_")}
    env.update(extra_env)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multihost_dryrun.py"),
         str(tmp_path / "work"), *extra_args],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "MULTIHOST DRYRUN PASSED" in res.stdout
    assert f"'{stage}': {{'bytes': " in res.stdout
    assert (tmp_path / "work" / "mh_CRISPR_Arrays.txt").read_text() == (
        tmp_path / "work" / "sp_CRISPR_Arrays.txt"
    ).read_text()


def test_process_group_of_one_runs_the_distributed_path(tmp_path, monkeypatch):
    """One process in a gloo group, 4 local shards: every exchange goes
    through ``torch.distributed`` (split sizes, wire types), and
    ``run_pipeline_multihost`` writes the golden report."""
    import torch.distributed as dist

    from mcaat_tpu_torch.settings import Settings
    from mcaat_tpu_torch.utils import wire
    from tests.test_torch_pipeline import DATA, _require_native_umap

    _require_native_umap()
    monkeypatch.setenv("MCAAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MCAAT_TORCH_SHARDS", "4")
    assert tmh.initialize_distributed() is False  # nothing configured, nothing started
    with pytest.raises(RuntimeError, match="no process group"):
        tmh.make_global_mesh()
    calls = []
    real = dist.all_to_all_single
    monkeypatch.setattr(
        dist, "all_to_all_single", lambda *a, **k: (calls.append(a[0].dtype), real(*a, **k))[1]
    )
    try:
        assert tmh.initialize_distributed(
            f"file://{tmp_path}/store", 1, 0, timeout_s=60
        ) is False
        mesh = tmh.make_global_mesh()
        assert mesh.shape == {"dp": 1, "kp": 4} and mesh.distributed
        s = Settings(
            input_files=os.path.join(DATA, "golden_reads.fq"),
            output_file=str(tmp_path / "CRISPR_Arrays.txt"),
        )
        stats: dict = {}
        result = tmh.run_pipeline_multihost(s, verbose=False, stats_out=stats)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")) as fh:
        assert result.report_text == fh.read()
    assert torch.int64 in calls and torch.uint8 in calls and torch.bool not in calls
    assert stats["wire"]["build_route"]["bytes"] > 0 and len(stats["live_rows_per_shard"]) == 4
    assert wire.snapshot() == stats["wire"]
