"""Wrapper of the hand-written CUDA LCS kernel (``csrc/lcs.cu``).

The kernel replaces ``mcaat_tpu/report/pallas_dp.py::_lcs_kernel``. It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use (into ``build/mcaat_tpu_torch/``, named
by the source's hash so an edited source builds anew) and bound with
``ctypes``. A failed build or a refused launch raises.

``LAUNCHES`` counts the launches of the kernel, so that a run can show
its main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "mcaat_tpu_torch", "csrc", "lcs.cu")
BUILD_DIR = os.path.join(_ROOT, "build", "mcaat_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = 0  # kernel launches since import (or the last reset)

_lib = None
BUILD_INFO: dict = {}  # seconds, compiler output and path of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the LCS "
            "kernel is built from mcaat_tpu_torch/csrc/lcs.cu at first use"
        )
    return found


def build(verbose_ptxas: bool = False) -> str:
    """Compile the kernel library if it is not built yet; its path.
    ``verbose_ptxas`` adds ``-Xptxas -v`` (registers, spills) and forces a
    fresh build so the report is printed into ``BUILD_INFO``."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"liblcs_{digest}.so")
    if os.path.exists(path) and not verbose_ptxas:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose_ptxas else []),
           "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, output=proc.stdout + proc.stderr, path=path
    )
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.mcaat_lcs_ratio.restype = ctypes.c_int
        lib.mcaat_lcs_ratio.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"lcs_ratio_cuda: {name} must be {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"lcs_ratio_cuda: {name} must be contiguous and 16-byte aligned")


def lcs_ratio_cuda(
    a_codes: torch.Tensor,
    a_lengths: torch.Tensor,
    b_codes: torch.Tensor,
    b_lengths: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LCS length (int32 [B]) and fuzz::ratio (float32 [B]) per pair, on
    the card. ``a_codes``/``b_codes`` uint8 [B, 64] 2-bit codes,
    ``a_lengths``/``b_lengths`` int32 [B] in [0, 64]. Launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    dev = a_codes.device
    if dev.type != "cuda":
        raise ValueError(f"lcs_ratio_cuda takes CUDA tensors, got {dev}")
    B = a_codes.shape[0]
    _check("a_codes", a_codes, torch.uint8, (B, 64), dev)
    _check("b_codes", b_codes, torch.uint8, (B, 64), dev)
    _check("a_lengths", a_lengths, torch.int32, (B,), dev)
    _check("b_lengths", b_lengths, torch.int32, (B,), dev)
    lcs = torch.empty(B, dtype=torch.int32, device=dev)
    ratio = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return lcs, ratio
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcaat_lcs_ratio(
            a_codes.data_ptr(), a_lengths.data_ptr(),
            b_codes.data_ptr(), b_lengths.data_ptr(),
            lcs.data_ptr(), ratio.data_ptr(), B, stream,
        )
    if err != 0:
        raise RuntimeError(f"lcs_ratio_cuda: launch failed with CUDA error {err}")
    LAUNCHES += 1
    return lcs, ratio
