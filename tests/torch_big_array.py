"""The 250-spacer array: an input whose one system is large enough for
the report's batched path to score a table of about 250 strings, and the
report the JAX package writes for it.

``make_metagenome(seed=7, n_arrays=1, n_spacers=250, coverage=35.0,
background_len=20000)`` gives 6,821 reads. The expected report in
``tests/torch_data/big_array/CRISPR_Arrays.txt`` is written by
``mcaat_tpu.pipeline.run_pipeline`` on the CPU; ``tests/test_torch_e2e.py``
holds the port's CPU report to it, and ``chip_smoke.py`` phase 17 holds
the port's report on the card to it. Rewrite it with

    JAX_PLATFORMS=cpu python -m tests.torch_big_array

from the repository root. ``synthetic`` is imported from this directory,
which pytest and ``chip_smoke.py`` put on ``sys.path``.
"""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(HERE, "torch_data", "big_array", "CRISPR_Arrays.txt")
N_SPACERS = 250


def make_input(tmp_dir: str) -> tuple[str, dict]:
    """Write the reads into ``tmp_dir/reads.fq``: ``(path, meta)``, the
    meta without its reads."""
    from synthetic import make_metagenome, write_fastq

    meta = make_metagenome(
        seed=7, n_arrays=1, n_spacers=N_SPACERS, coverage=35.0, background_len=20000
    )
    path = os.path.join(tmp_dir, "reads.fq")
    write_fastq(path, meta.pop("reads"))
    return path, meta


def expected_report() -> bytes:
    with open(EXPECTED, "rb") as fh:
        return fh.read()


def _write_expected() -> None:
    import tempfile

    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    with tempfile.TemporaryDirectory() as tmp:
        fq, _meta = make_input(tmp)
        out = os.path.join(tmp, "CRISPR_Arrays.txt")
        run_pipeline(Settings(input_files=fq, output_file=out), verbose=False)
        with open(out, "rb") as fh:
            data = fh.read()
    os.makedirs(os.path.dirname(EXPECTED), exist_ok=True)
    with open(EXPECTED, "wb") as fh:
        fh.write(data)
    print(f"wrote {os.path.relpath(EXPECTED, HERE)} ({len(data)} bytes)")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, HERE)
    from mcaat_tpu.utils.env import honor_cpu_env

    honor_cpu_env()
    _write_expected()
