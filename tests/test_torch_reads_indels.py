"""Reads with insertions, deletions, N bases and variable lengths: the
port's report against the JAX package's on the CPU.

``tests/torch_reads.py`` models substitutions only. Here a
``make_metagenome`` call's reads each get, base by base, a deletion
(0.1%), an insertion of a random base before it (0.1%) and an N in its
place (0.05%), and are then cut to a length drawn from 70-100; the first
half goes to mate 1, the reverse complement of the rest to mate 2. An
indel shifts every later k-mer of a read and an N ends the read's
windows, so the graph, the mapper's chains and the report see inputs no
other test gives them.
"""

import os

import numpy as np

from mcaat_tpu.pipeline import run_pipeline as jrun_pipeline
from mcaat_tpu.settings import Settings as JSettings
from mcaat_tpu_torch.pipeline import run_pipeline
from mcaat_tpu_torch.settings import Settings
from tests.synthetic import make_metagenome

_COMP = str.maketrans("ACGTN", "TGCAN")


def indel_reads(reads: list, seed: int, p_del: float = 0.001, p_ins: float = 0.001,
                p_n: float = 0.0005, min_len: int = 70, max_len: int = 100):
    """The reads with deletions, insertions and N bases, each cut to a
    length in ``[min_len, max_len]``: ``(reads, counts)``."""
    rng = np.random.default_rng(seed)
    counts = {"deletions": 0, "insertions": 0, "n_bases": 0}
    out = []
    for r in reads:
        s = []
        for b in r:
            u = rng.random()
            if u < p_del:
                counts["deletions"] += 1
                continue
            if u < p_del + p_ins:
                counts["insertions"] += 1
                s.append("ACGT"[rng.integers(4)])
            if rng.random() < p_n:
                counts["n_bases"] += 1
                b = "N"
            s.append(b)
        out.append("".join(s)[: int(rng.integers(min_len, max_len + 1))])
    return out, counts


def write_mates(folder, reads: list) -> list:
    half = len(reads) // 2
    mates = (reads[:half], [r.translate(_COMP)[::-1] for r in reads[half:]])
    paths = []
    for name, rs in zip(("r1.fq", "r2.fq"), mates):
        path = os.path.join(folder, name)
        with open(path, "w") as fh:
            for i, r in enumerate(rs):
                fh.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")
        paths.append(path)
    return paths


def test_indels_n_bases_and_variable_lengths_give_the_jax_report(tmp_path):
    meta = make_metagenome(seed=11, n_arrays=2, n_spacers=30, background_len=100_000)
    reads, counts = indel_reads(meta["reads"], seed=5)
    lengths = {len(r) for r in reads}
    assert min(counts.values()) > 300 and min(lengths) == 70 and max(lengths) == 100
    files = " ".join(write_mates(str(tmp_path), reads))
    want = jrun_pipeline(
        JSettings(input_files=files, output_file=str(tmp_path / "jax.txt")), verbose=False
    ).report_text
    got = run_pipeline(
        Settings(input_files=files, output_file=str(tmp_path / "torch.txt")), verbose=False,
        device="cpu",
    ).report_text
    assert got == want
    assert want.count("-" * 50) >= 6  # systems were found, not an empty report
