"""Wrappers of the hand-written CUDA kernels under ``csrc/``.

All three replace ``mcaat_tpu/report/pallas_dp.py::_lcs_kernel``:
:func:`lcs_ratio_cuda` (``csrc/lcs.cu``) scores one pair per thread,
:func:`partial_ratio_cuda` (``csrc/partial_ratio.cu``) scores one pair
per warp over all its alignment windows, expanded on the card from a
table of strings, and :func:`ratio_matrix_cuda`
(``csrc/ratio_matrix.cu``) scores every pair of a table of strings, one
thread per row string. They share one register core
(``csrc/lcs_core.cuh``). Every ``csrc/*.cu`` is compiled by one ``nvcc``
command for ``sm_90a`` into one shared library with a plain C interface
at first use (into ``build/mcaat_tpu_torch/``, named by the sources'
hash so an edited source or header builds anew) and bound with
``ctypes``. A failed build or a refused launch raises. The library also
holds a measuring probe that is no port of anything
(``csrc/int_rate.cu``, :func:`int_rate_probe`): the card's rate of 32-bit
integer multiply-adds, which the smoke run prints beside the integer peak
it assumes for the kernels' bounds.

``LAUNCHES``, ``PARTIAL_LAUNCHES`` and ``MATRIX_LAUNCHES`` count the
launches of the three kernels, so that a run can show its main path went
through them; :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE_DIR = os.path.join(_ROOT, "mcaat_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "mcaat_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = 0  # launches of lcs_ratio_kernel since import (or the last reset)
PARTIAL_LAUNCHES = 0  # the same for partial_ratio_kernel
MATRIX_LAUNCHES = 0  # the same for ratio_matrix_kernel

# ratio_matrix_kernel: a warp scores 32 rows against a run of columns. The
# run grows with the table so that about this many warps have work (an
# H100 holds 132 x 64 at a time, and at 1,024 strings fewer, longer runs
# measured slower), up to the kernel's own limit (kMaxRun).
MATRIX_TARGET_WARPS = 8192
MATRIX_MAX_RUN = 64

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
            "kernels are built from mcaat_tpu_torch/csrc/*.cu at first use"
        )
    return found


def launch_counts() -> dict:
    """Launches of each kernel since import or the last reset."""
    return {
        "lcs_ratio": LAUNCHES,
        "partial_ratio": PARTIAL_LAUNCHES,
        "ratio_matrix": MATRIX_LAUNCHES,
    }


def reset_launch_counts() -> None:
    global LAUNCHES, PARTIAL_LAUNCHES, MATRIX_LAUNCHES
    LAUNCHES = PARTIAL_LAUNCHES = MATRIX_LAUNCHES = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile the kernel library if it is not built yet; its path.
    ``verbose_ptxas`` adds ``-Xptxas -v`` (registers, spills) and forces a
    fresh build so the report is printed into ``BUILD_INFO``."""
    sources = sorted(glob.glob(os.path.join(SOURCE_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no kernel sources under {SOURCE_DIR}")
    sha = hashlib.sha256()
    for src in sorted(glob.glob(os.path.join(SOURCE_DIR, "*.cuh"))) + sources:
        with open(src, "rb") as fh:
            sha.update(os.path.basename(src).encode() + b"\0" + fh.read() + b"\0")
    digest = sha.hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"liblcs_{digest}.so")
    if os.path.exists(path) and not verbose_ptxas:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose_ptxas else []),
           "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {sources}:\n{proc.stderr}"
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
        lib.mcaat_partial_ratio.restype = ctypes.c_int
        lib.mcaat_partial_ratio.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.mcaat_ratio_matrix.restype = ctypes.c_int
        lib.mcaat_ratio_matrix.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.mcaat_int_rate.restype = ctypes.c_int
        lib.mcaat_int_rate.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _check(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           dev, align: int) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{fn}: {name} must be {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{fn}: {name} must be contiguous and {align}-byte aligned")


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
    _check("lcs_ratio_cuda", "a_codes", a_codes, torch.uint8, (B, 64), dev, 16)
    _check("lcs_ratio_cuda", "b_codes", b_codes, torch.uint8, (B, 64), dev, 16)
    _check("lcs_ratio_cuda", "a_lengths", a_lengths, torch.int32, (B,), dev, 16)
    _check("lcs_ratio_cuda", "b_lengths", b_lengths, torch.int32, (B,), dev, 16)
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


def partial_ratio_cuda(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    s_idx: torch.Tensor,
    l_idx: torch.Tensor,
) -> torch.Tensor:
    """fuzz::partial_ratio (float32 [P]) of P pairs of rows of a string
    table, on the card: pair ``p`` scores row ``s_idx[p]`` (the
    bit-parallel row, by convention the shorter string) against every
    alignment window of row ``l_idx[p]``. ``codes`` uint8 [n, 64] 2-bit
    codes, ``lengths`` int32 [n] in [0, 64], ``s_idx``/``l_idx`` int32
    [P] in [0, n). A pair with an index or a length out of range comes
    back as NaN. Launches on the current stream and does not
    synchronise."""
    global PARTIAL_LAUNCHES
    fn = "partial_ratio_cuda"
    dev = codes.device
    n = codes.shape[0] if codes.dim() else 0
    P = s_idx.shape[0] if s_idx.dim() else 0
    _check(fn, "codes", codes, torch.uint8, (n, 64), dev, 1)
    _check(fn, "lengths", lengths, torch.int32, (n,), dev, 4)
    _check(fn, "s_idx", s_idx, torch.int32, (P,), dev, 4)
    _check(fn, "l_idx", l_idx, torch.int32, (P,), dev, 4)
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {dev}")
    if P > 0 and n == 0:
        raise ValueError(f"{fn}: {P} pairs over an empty string table")
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcaat_partial_ratio(
            codes.data_ptr(), lengths.data_ptr(), s_idx.data_ptr(), l_idx.data_ptr(),
            out.data_ptr(), n, P, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    PARTIAL_LAUNCHES += 1
    return out


def matrix_run(n: int) -> int:
    """Columns a warp of ratio_matrix_kernel walks for a table of ``n``
    strings: 1 while the tiles on and above the diagonal (half of the
    ``n * ceil(n / 32)`` warp-columns) are fewer than
    ``MATRIX_TARGET_WARPS``, then as many as keep about that many warps."""
    warp_columns = n * -(-n // 32)
    return max(1, min(MATRIX_MAX_RUN, -(-warp_columns // (2 * MATRIX_TARGET_WARPS))))


def ratio_matrix_cuda(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """All-pairs fuzz::ratio (float32 [n, n]) of a table of strings, on
    the card: ``out[i, j]`` scores row ``i`` against row ``j``, the
    diagonal included. ``codes`` uint8 [n, 64] 2-bit codes, 16-byte
    aligned, ``lengths`` int32 [n] in [0, 64]. A string with a length out
    of range comes back as NaN in its row and its column. Launches on the
    current stream and does not synchronise."""
    global MATRIX_LAUNCHES
    fn = "ratio_matrix_cuda"
    dev = codes.device
    n = codes.shape[0] if codes.dim() else 0
    _check(fn, "codes", codes, torch.uint8, (n, 64), dev, 16)
    _check(fn, "lengths", lengths, torch.int32, (n,), dev, 4)
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {dev}")
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcaat_ratio_matrix(
            codes.data_ptr(), lengths.data_ptr(), out.data_ptr(), n, matrix_run(n), stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    MATRIX_LAUNCHES += 1
    return out


INT_RATE_THREADS = 256  # threads a block of int_rate_kernel (kThreads)
INT_RATE_CHAINS = 8  # independent multiply-add chains a thread (kChains)


def int_rate_probe(out: torch.Tensor, blocks: int, iters: int, mul: int = 1664525,
                   add: int = 1013904223) -> int:
    """Launch the integer-rate probe on ``out``'s card: every thread of
    ``blocks`` blocks runs ``INT_RATE_CHAINS`` independent chains of
    ``iters`` 32-bit multiply-adds and writes one word of ``out`` (int32
    ``[blocks * INT_RATE_THREADS]``). Returns the multiply-adds executed.
    Launches on the current stream and does not synchronise; it counts as
    no kernel launch of the port."""
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"int_rate_probe takes a CUDA tensor, got {dev}")
    _check("int_rate_probe", "out", out, torch.int32, (blocks * INT_RATE_THREADS,), dev, 4)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcaat_int_rate(out.data_ptr(), blocks, mul, add, iters, stream)
    if err != 0:
        raise RuntimeError(f"int_rate_probe: launch failed with CUDA error {err}")
    return blocks * INT_RATE_THREADS * INT_RATE_CHAINS * iters
