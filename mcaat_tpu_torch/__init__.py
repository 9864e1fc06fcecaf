"""mcaat_tpu_torch — the PyTorch and CUDA port of ``mcaat_tpu``.

The single-device release pipeline of ``mcaat_tpu`` (graph build, prune,
cycle search, read mapping, spacer ordering, report) rewritten on torch
tensors, with the one TPU kernel (the bit-parallel LCS behind the
report's similarity scores) hand-written in CUDA C++ for Hopper as
three kernels on one register core (``csrc/lcs.cu``,
``csrc/partial_ratio.cu``, ``csrc/ratio_matrix.cu``;
``csrc/lcs_core.cuh``). Module paths and public names follow ``mcaat_tpu``,
so ``mcaat_tpu_torch/kmer/count.py::count_unique`` is the port of
``mcaat_tpu/kmer/count.py::count_unique``.

Device selection is explicit: functions take a ``device`` argument, and
:func:`resolve_device` turns ``None`` into ``MCAAT_TORCH_DEVICE`` or,
when that is unset, ``cuda``. Asking for ``cuda`` on a machine without a
card raises; the CPU is used only when the caller names it.

This package imports torch and numpy, never jax and never ``mcaat_tpu``.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

K = 23  # k-mer size, fixed by the reference (src/sdbg_build.cpp:216 "-k","23")
SENTINEL = torch.iinfo(torch.int64).max  # dead k-mer windows; sorts last


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a run uses: ``device`` when given, else the
    ``MCAAT_TORCH_DEVICE`` environment variable, else ``cuda``. Raises
    when CUDA is asked for and is not available — nothing falls back to
    the CPU without being told to."""
    if device is None:
        device = os.environ.get("MCAAT_TORCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mcaat_tpu_torch: device 'cuda' requested but CUDA is not "
            "available; pass device='cpu' or set MCAAT_TORCH_DEVICE=cpu to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mcaat_tpu_torch: unsupported device {dev}")
    return dev
