"""ctypes bindings for the native host runtime (native/mcaat_host.cpp).

The tracked ``native/libmcaat_host.so`` at the repository root is loaded
first and never rewritten. Where it does not load on this machine, a copy
is compiled from ``native/mcaat_host.cpp`` with ``native/Makefile``'s
flags into ``build/mcaat_tpu_torch/`` and loaded from there. Every entry
point degrades to the pure-Python implementation when neither is
available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_ROOT, "native", "libmcaat_host.so")
_SRC_PATH = os.path.join(_ROOT, "native", "mcaat_host.cpp")
_BUILD_PATH = os.path.join(_ROOT, "build", "mcaat_tpu_torch", "libmcaat_host.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_local_copy() -> Optional[str]:
    """Compile native/mcaat_host.cpp with native/Makefile's flags into the
    build directory; the path of the library, or None when that fails."""
    if not os.path.exists(_SRC_PATH):
        return None
    if os.path.exists(_BUILD_PATH):
        return _BUILD_PATH
    os.makedirs(os.path.dirname(_BUILD_PATH), exist_ok=True)
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-march=native", "-std=c++17",
        "-fPIC", "-Wall", "-fopenmp", _SRC_PATH, "-o", _BUILD_PATH,
        "-shared", "-lz", "-fopenmp",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"native build failed ({e}); using the pure-Python fallbacks")
        return None
    return _BUILD_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = None
    if os.path.exists(_LIB_PATH):
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            lib = None
    if lib is None:
        path = _build_local_copy()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
    c = ctypes
    lib.mcaat_parse_fastx.restype = c.c_int
    lib.mcaat_parse_fastx.argtypes = [
        c.c_char_p,
        c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.POINTER(c.c_int32)),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int32),
    ]
    lib.mcaat_free.restype = None
    lib.mcaat_free.argtypes = [c.c_void_p]
    lib.mcaat_enumerate_cycles.restype = c.c_void_p
    lib.mcaat_enumerate_cycles.argtypes = [
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32),
        c.c_int64,
        c.POINTER(c.c_int64),
        c.c_int64,
        c.c_int,
        c.c_int,
    ]
    for name in ("mcaat_sink_n_groups", "mcaat_sink_n_cycles", "mcaat_sink_flat_size"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.mcaat_sink_copy.restype = None
    lib.mcaat_sink_copy.argtypes = [c.c_void_p] + [c.POINTER(c.c_int64)] * 4
    lib.mcaat_sink_free.restype = None
    lib.mcaat_sink_free.argtypes = [c.c_void_p]
    if hasattr(lib, "mcaat_umap_order"):  # older .so builds lack it
        lib.mcaat_umap_order.restype = c.c_int64
        lib.mcaat_umap_order.argtypes = [
            c.c_char_p,
            c.POINTER(c.c_int64),
            c.c_int64,
            c.POINTER(c.c_int64),
        ]
    if hasattr(lib, "mcaat_poa_consensus"):  # older .so builds lack it
        lib.mcaat_poa_consensus.restype = c.c_int
        lib.mcaat_poa_consensus.argtypes = [
            c.c_char_p,
            c.POINTER(c.c_int64),
            c.c_int64,
            c.c_int,
            c.c_int,
            c.c_int,
            c.POINTER(c.c_char_p),
            c.POINTER(c.c_int64),
        ]
    if hasattr(lib, "mcaat_scc"):  # older .so builds lack it
        lib.mcaat_scc.restype = c.c_int64
        lib.mcaat_scc.argtypes = [
            c.POINTER(c.c_int64),
            c.POINTER(c.c_int64),
            c.c_int64,
            c.POINTER(c.c_uint8),
            c.POINTER(c.c_int64),
            c.POINTER(c.c_int64),
        ]
    _lib = lib
    return _lib


def scc_components(indptr, indices, valid) -> "list[list[int]] | None":
    """Tarjan SCC over a CSR adjacency — result- AND order-identical to
    ordering.find_strongly_connected_components (the caller's fallback).
    Returns the list of >1-node components in emission order, or None
    when the native lib is unbuilt/old."""
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "mcaat_scc"):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = valid_u8.shape[0]
    order = np.empty(max(n, 1), dtype=np.int64)
    sizes = np.empty(max(n, 1), dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n_comp = lib.mcaat_scc(
        indptr.ctypes.data_as(p64),
        indices.ctypes.data_as(p64),
        ctypes.c_int64(n),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        order.ctypes.data_as(p64),
        sizes.ctypes.data_as(p64),
    )
    comps: list[list[int]] = []
    pos = 0
    for ci in range(int(n_comp)):
        sz = int(sizes[ci])
        comps.append(order[pos : pos + sz].tolist())
        pos += sz
    return comps


def native_available() -> bool:
    return _load() is not None


def set_threads(n: int) -> None:
    """Bound the native library's OpenMP team (the packer's parallel-for)
    to ``n`` threads — ≙ the reference's omp_set_num_threads
    (src/main.cpp:292-294). No-op when the library is unbuilt/old."""
    lib = _load()
    if lib is None or not hasattr(lib, "mcaat_set_threads") or n <= 0:
        return
    lib.mcaat_set_threads(ctypes.c_int(int(n)))


def umap_order(keys: list[str]):
    """Indices permuting ``keys`` (first-seen order) into libstdc++
    ``unordered_map`` iteration order — the order the reference's
    common-kmer candidate lists come out in (post_processing.h:50-63),
    which its spacer trim / repeat reconstruction depend on. Returns None
    when the native library is unavailable (callers keep first-seen
    order; see report/analyzer._get_common_kmers for the divergence
    note)."""
    lib = _load()
    if lib is None or not hasattr(lib, "mcaat_umap_order") or not keys:
        return None
    c = ctypes
    buf = "".join(keys).encode("ascii")
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    order = np.zeros(len(keys), dtype=np.int64)
    n = lib.mcaat_umap_order(
        buf,
        offsets.ctypes.data_as(c.POINTER(c.c_int64)),
        len(keys),
        order.ctypes.data_as(c.POINTER(c.c_int64)),
    )
    if int(n) != len(keys):
        return None
    return order.tolist()


def parse_fastx_batch(path: str):
    """Parse FASTA/FASTQ(.gz) directly into (codes [R, Lmax] uint8, lengths).

    Returns None if the native library is unavailable or parsing failed.
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    codes_p = c.POINTER(c.c_uint8)()
    lengths_p = c.POINTER(c.c_int32)()
    n_reads = c.c_int64()
    max_len = c.c_int32()
    rc = lib.mcaat_parse_fastx(
        path.encode(), c.byref(codes_p), c.byref(lengths_p),
        c.byref(n_reads), c.byref(max_len),
    )
    if rc != 0:
        return None
    n, m = int(n_reads.value), int(max_len.value)
    try:
        codes = np.ctypeslib.as_array(codes_p, shape=(max(n * m, 1),))[: n * m]
        codes = codes.reshape(n, m).copy()
        lengths = np.ctypeslib.as_array(lengths_p, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.mcaat_free(codes_p)
        lib.mcaat_free(lengths_p)
    return codes, lengths


def parse_fastx(path: str) -> list[str]:
    """Sequence strings via the native parser (decoded from 2-bit codes).

    A non-ACGT character comes back as 'T' (the pipeline's coding).
    Raises ImportError when the library is unavailable so callers fall
    back."""
    res = parse_fastx_batch(path)
    if res is None:
        raise ImportError("native library unavailable")
    codes, lengths = res
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [
        lut[codes[i, : lengths[i]]].tobytes().decode("ascii") for i in range(codes.shape[0])
    ]


def enumerate_cycles(
    out: np.ndarray,
    in_: np.ndarray,
    valid: np.ndarray,
    mult: np.ndarray,
    start_nodes: np.ndarray,
    min_len: int,
    max_len: int,
):
    """Native bounded multicycle enumeration.

    Returns {start_node: [cycles]} or None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    out = np.ascontiguousarray(out, dtype=np.int32)
    in_ = np.ascontiguousarray(in_, dtype=np.int32)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    mult = np.ascontiguousarray(mult, dtype=np.int32)
    starts = np.ascontiguousarray(start_nodes, dtype=np.int64)
    h = lib.mcaat_enumerate_cycles(
        out.ctypes.data_as(c.POINTER(c.c_int32)),
        in_.ctypes.data_as(c.POINTER(c.c_int32)),
        valid_u8.ctypes.data_as(c.POINTER(c.c_uint8)),
        mult.ctypes.data_as(c.POINTER(c.c_int32)),
        out.shape[0],
        starts.ctypes.data_as(c.POINTER(c.c_int64)),
        len(starts),
        min_len,
        max_len,
    )
    try:
        n_groups = lib.mcaat_sink_n_groups(h)
        n_cycles = lib.mcaat_sink_n_cycles(h)
        flat_size = lib.mcaat_sink_flat_size(h)
        g_starts = np.zeros(max(n_groups, 1), dtype=np.int64)
        g_offsets = np.zeros(n_groups + 1, dtype=np.int64)
        offsets = np.zeros(n_cycles + 1, dtype=np.int64)
        flat = np.zeros(max(flat_size, 1), dtype=np.int64)
        lib.mcaat_sink_copy(
            h,
            g_starts.ctypes.data_as(c.POINTER(c.c_int64)),
            g_offsets.ctypes.data_as(c.POINTER(c.c_int64)),
            offsets.ctypes.data_as(c.POINTER(c.c_int64)),
            flat.ctypes.data_as(c.POINTER(c.c_int64)),
        )
    finally:
        lib.mcaat_sink_free(h)
    results: dict[int, list[list[int]]] = {}
    for g in range(n_groups):
        cycles = []
        for ci in range(g_offsets[g], g_offsets[g + 1]):
            cycles.append(flat[offsets[ci] : offsets[ci + 1]].tolist())
        results[int(g_starts[g])] = cycles
    return results


def poa_consensus(sequences, match: int = 3, mismatch: int = -5, gap: int = -3):
    """Native POA consensus; None when the library is unavailable.
    Result-identical to ``poa.compute_consensus_py``."""
    lib = _load()
    if lib is None or not hasattr(lib, "mcaat_poa_consensus"):
        return None
    c = ctypes
    blob = "".join(sequences).encode("ascii")
    offsets = (c.c_int64 * (len(sequences) + 1))()
    acc = 0
    for i, s in enumerate(sequences):
        offsets[i] = acc
        acc += len(s)
    offsets[len(sequences)] = acc
    out = c.c_char_p()
    out_len = c.c_int64()
    rc = lib.mcaat_poa_consensus(
        blob, offsets, len(sequences), match, mismatch, gap,
        c.byref(out), c.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        return c.string_at(out, out_len.value).decode("ascii")
    finally:
        lib.mcaat_free(out)
