"""Inputs of the debug-pipeline parity checks and their expected outputs.

The expected files in ``tests/torch_data/debug/<name>/`` are written by
the JAX package (``mcaat_tpu.pipeline.run_debug_pipeline``) on the CPU;
``tests/test_torch_debug.py`` holds both packages to them on the CPU and
``chip_smoke.py`` holds the port to them on the card. Rewrite them with

    JAX_PLATFORMS=cpu python -m tests.torch_debug_inputs

from the repository root (the test fails when they go stale).
``synthetic`` is imported from this directory, which pytest and
``chip_smoke.py`` put on ``sys.path``.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
EXPECTED = os.path.join(HERE, "torch_data", "debug")
OUTPUTS = (
    "CRISPR_Arrays.txt",
    "node_multiplicities.txt",
    "grouped_paths_protospacers.txt",
    "QualityPaths_BeamWidth50.fasta",
)
GOLDEN = {
    "golden": "golden_reads.fq",
    "golden_rc": "golden_rc_reads.fq",
    "golden_mut": "golden_mut_reads.fq",
    "golden_pe": "golden_pe_1.fq golden_pe_2.fq",
}
NAMES = tuple(sorted(GOLDEN)) + ("planted_2x26", "planted_2x26_phage")


def _planted_reads(with_phage: bool) -> list[str]:
    """Two arrays of 26 spacers in a 4 kbp background; with a phage, a
    linear 6.4 kbp genome that carries a suffix of one spacer and a
    prefix of another (protospacers that enter and leave a spacer cycle
    mid-way, so the protospacer paths and the phage beam search have
    something to find)."""
    from synthetic import make_metagenome, random_seq, sample_reads

    meta = make_metagenome(
        seed=29, n_arrays=2, n_spacers=26, background_len=4000,
        background_coverage=6.0, coverage=40.0,
    )
    reads = meta["reads"]
    if with_phage:
        rng = np.random.default_rng(31)
        sp = meta["arrays"][0]["spacers"]
        phage = (
            random_seq(rng, 1500) + sp[3][6:] + random_seq(rng, 400)
            + sp[10][:20] + random_seq(rng, 4500)
        )
        reads = reads + sample_reads(rng, phage, coverage=30.0)
    return reads


def input_files(name: str, tmp_dir: str) -> str:
    """The space-separated input paths of one named input (planted inputs
    are written into ``tmp_dir``)."""
    if name in GOLDEN:
        return " ".join(os.path.join(DATA, f) for f in GOLDEN[name].split())
    from synthetic import write_fastq

    path = os.path.join(tmp_dir, f"{name}.fq")
    write_fastq(path, _planted_reads(with_phage=name.endswith("_phage")))
    return path


def read_outputs(out_dir: str) -> dict[str, bytes]:
    out = {}
    for f in OUTPUTS:
        with open(os.path.join(out_dir, f), "rb") as fh:
            out[f] = fh.read()
    return out


def settings_kwargs(name: str, tmp_dir: str) -> dict:
    """Settings fields of one debug run writing into ``tmp_dir/<name>``."""
    out = os.path.join(tmp_dir, name)
    os.makedirs(out, exist_ok=True)
    return dict(
        input_files=input_files(name, tmp_dir),
        output_folder=out,
        output_file=os.path.join(out, "CRISPR_Arrays.txt"),
    )


def _write_expected() -> None:
    import tempfile

    from mcaat_tpu.pipeline import run_debug_pipeline
    from mcaat_tpu.settings import Settings

    for name in NAMES:
        with tempfile.TemporaryDirectory() as tmp:
            kw = settings_kwargs(name, tmp)
            run_debug_pipeline(Settings(**kw), verbose=False)
            dest = os.path.join(EXPECTED, name)
            os.makedirs(dest, exist_ok=True)
            for f, data in read_outputs(kw["output_folder"]).items():
                with open(os.path.join(dest, f), "wb") as fh:
                    fh.write(data)
        print(f"wrote {os.path.relpath(dest, HERE)}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, HERE)
    from mcaat_tpu.utils.env import honor_cpu_env

    honor_cpu_env()
    _write_expected()
