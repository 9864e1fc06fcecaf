"""Helpers shared by the sharded parity tests: both packages' sharded
graphs brought to one id space.

The JAX package's shard capacity ``T`` is a bucketed size and the port's
is exact, so global ids ``shard * T + local`` differ between the packages
while ``(shard, local rank)`` pairs do not. ``canon_*`` map every id to
its compact rank over the live rows (shard-major), in which both packages
must agree exactly.
"""

import numpy as np
import torch

CPU8 = [torch.device("cpu")] * 8


def make_reads(n=32, length=60, seed=0):
    from mcaat_tpu.io.fastq import encode_sequences

    rng = np.random.default_rng(seed)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, size=length)) for _ in range(n)]
    return encode_sequences(seqs)


def compact_ids(ids, T, n_live):
    """Global ids (any shape, negatives kept) -> compact live ranks."""
    ids = np.asarray(ids, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(np.asarray(n_live, dtype=np.int64))])
    s = np.maximum(ids, 0) // T
    return np.where(ids >= 0, ids - s * T + offs[np.minimum(s, len(offs) - 1)], ids)


def global_ids(compact, T, n_live):
    """Compact live ranks -> global ids of a layout ``(T, n_live)``."""
    compact = np.asarray(compact, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(np.asarray(n_live, dtype=np.int64))])
    s = np.searchsorted(offs, compact, side="right") - 1
    return s * T + compact - offs[s]


def decode_tags(a):
    a = np.asarray(a, dtype=np.int64)
    return np.where(a <= -2, -2 - a, a)


def compact_tagged(a, T, n_live):
    """Tagged adjacency entries -> the same tags over compact ids."""
    a = np.asarray(a, dtype=np.int64)
    c = compact_ids(decode_tags(a), T, n_live)
    return np.where(a <= -2, -2 - c, c)


def jax_layout(sg):
    kp, T = sg.kmers.shape
    return int(T), np.asarray(sg.n_live, dtype=np.int64)


def jax_live_rows(sg, field):
    """Live rows of a JAX ``[kp, T]`` (or ``[kp, 4T]``) field, shard-major."""
    T, n_live = jax_layout(sg)
    a = np.asarray(field)
    w = a.shape[1] // T
    return np.concatenate([a[s, : int(n) * w] for s, n in enumerate(n_live)])


def canon_jax(sg):
    """(kmers, mult, out [N,4], in_ [N,4], valid) over live rows, compact ids."""
    T, n_live = jax_layout(sg)
    return (
        jax_live_rows(sg, sg.kmers),
        jax_live_rows(sg, sg.mult),
        compact_ids(jax_live_rows(sg, sg.out), T, n_live).reshape(-1, 4),
        compact_ids(jax_live_rows(sg, sg.in_), T, n_live).reshape(-1, 4),
        jax_live_rows(sg, sg.valid),
    )


def torch_rows(sg, xs):
    from mcaat_tpu_torch.parallel.exchange import host_replicated

    return host_replicated(sg.mesh, xs)


def canon_torch(sg):
    return (
        torch_rows(sg, sg.kmers),
        torch_rows(sg, sg.mult),
        compact_ids(torch_rows(sg, sg.out), sg.T, sg.n_live).reshape(-1, 4),
        compact_ids(torch_rows(sg, sg.in_), sg.T, sg.n_live).reshape(-1, 4),
        torch_rows(sg, sg.valid),
    )


def assert_same_graph(sg_jax, sg_torch):
    np.testing.assert_array_equal(np.asarray(sg_jax.n_live), sg_torch.n_live)
    for name, a, b in zip(
        ("kmers", "mult", "out", "in_", "valid"), canon_jax(sg_jax), canon_torch(sg_torch)
    ):
        np.testing.assert_array_equal(a, b, err_msg=name)
