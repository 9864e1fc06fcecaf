"""ctypes bindings for the native host runtime (native/mcaat_host.cpp)
and for the port's own host code beside this file: the FASTQ parser
(``fastx.cpp``, plain and gzipped), the report's host-route scores
(``fuzz.cpp``) and the spacer-ordering stage's SCC split (``split.cpp``).

The tracked ``native/libmcaat_host.so`` at the repository root is loaded
first and never rewritten. Where it does not load on this machine, a copy
is compiled from ``native/mcaat_host.cpp`` with ``native/Makefile``'s
flags into ``build/mcaat_tpu_torch/`` and loaded from there. Every entry
point degrades to the pure-Python implementation when neither is
available. ``fastx.cpp``, ``fuzz.cpp`` and ``split.cpp`` are compiled
with the same flags (less OpenMP) into ``build/mcaat_tpu_torch/`` by
:func:`_load`, each under a name keyed by its source, the flags and the
host's CPU; ``fastx.cpp`` links zlib (``-lz``, as ``native/Makefile``
links the shared library) to inflate gzipped FASTQ. When a build fails
:func:`parse_plain_fastq` and :func:`parse_gzip_fastq` return None and
callers keep the shared parser, the ``fuzz_*`` functions return None and
the report keeps its Python loops, and :func:`scc_split` returns None and
the ordering stage keeps its Python split.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_ROOT, "native", "libmcaat_host.so")
_SRC_PATH = os.path.join(_ROOT, "native", "mcaat_host.cpp")
_BUILD_PATH = os.path.join(_ROOT, "build", "mcaat_tpu_torch", "libmcaat_host.so")

_HERE = os.path.dirname(os.path.abspath(__file__))
_FASTX_SRC = os.path.join(_HERE, "fastx.cpp")
_FUZZ_SRC = os.path.join(_HERE, "fuzz.cpp")
_SPLIT_SRC = os.path.join(_HERE, "split.cpp")
# -ffp-contract=off: fuzz.cpp's scores must round as Python's do
_CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread",
              "-ffp-contract=off"]
# fastx.cpp inflates gzipped FASTQ with zlib
_FASTX_LINKS = ("-lz",)
# the widest string fuzz.cpp scores: one 64-bit word of match masks
FUZZ_MAX_LEN = 64

_lib: Optional[ctypes.CDLL] = None
_tried = False
_fastx: Optional[ctypes.CDLL] = None
_fastx_tried = False
_fuzz: Optional[ctypes.CDLL] = None
_fuzz_tried = False
_split: Optional[ctypes.CDLL] = None
_split_tried = False
# --threads as set_threads last received it; None = unset (the CPU count)
_threads: Optional[int] = None


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


def _cpu_key() -> bytes:
    """What ``-march=native`` compiles for: the first CPU's model and
    flags (empty where /proc/cpuinfo is not there)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(ln for ln in lines if ln.startswith((b"model name", b"flags")))


def _build(src_path: str, links: tuple = ()) -> Optional[str]:
    """Compile the port's source ``src_path`` with the extra flags ``links``
    into build/mcaat_tpu_torch/ unless a build of this source with these
    flags for this CPU is there; its path, or None when that fails. The
    compiler writes a private file that is then renamed into place, so
    processes that build at once do not see a partial one."""
    stem = os.path.splitext(os.path.basename(src_path))[0]
    try:
        with open(src_path, "rb") as fh:
            src = fh.read()
    except OSError:
        return None
    flags = " ".join([*_CXX_FLAGS, *links]).encode()
    key = hashlib.sha1(src + flags + _cpu_key()).hexdigest()[:16]
    path = os.path.join(_ROOT, "build", "mcaat_tpu_torch", f"libmcaat_{stem}-{key}.so")
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, src_path, "-o", tmp, *links]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"{stem} build failed ({e}); its callers keep their other route")
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return path


def _open(src_path: str, links: tuple = ()) -> Optional[ctypes.CDLL]:
    """The library of the port's source ``src_path`` built with ``links``
    (:func:`_build`), loaded; None when it did not build or load."""
    path = _build(src_path, links)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load_fastx() -> Optional[ctypes.CDLL]:
    """The port's FASTQ parser library, built on first use."""
    global _fastx, _fastx_tried
    if _fastx_tried:
        return _fastx
    _fastx_tried = True
    lib = _open(_FASTX_SRC, _FASTX_LINKS)
    if lib is None:
        return None
    c = ctypes
    lib.mcaat_fastq_index.restype = c.c_void_p
    lib.mcaat_fastq_index.argtypes = [
        c.c_char_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
    ]
    lib.mcaat_fastq_fill.restype = None
    lib.mcaat_fastq_fill.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.POINTER(c.c_int32), c.c_int,
    ]
    lib.mcaat_fastq_close.restype = None
    lib.mcaat_fastq_close.argtypes = [c.c_void_p]
    lib.mcaat_gzip_index.restype = None
    lib.mcaat_gzip_index.argtypes = [
        c.POINTER(c.c_char_p), c.c_int, c.c_int, c.POINTER(c.c_void_p),
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
    ]
    _fastx = lib
    return _fastx


def _load_fuzz() -> Optional[ctypes.CDLL]:
    """The report's host-route scoring library, built on first use."""
    global _fuzz, _fuzz_tried
    if _fuzz_tried:
        return _fuzz
    _fuzz_tried = True
    lib = _open(_FUZZ_SRC)
    if lib is None:
        return None
    c = ctypes
    u8, i32, i64, f64 = (c.POINTER(t) for t in (c.c_uint8, c.c_int32, c.c_int64, c.c_double))
    lib.mcaat_fuzz_ratio_all_pairs.restype = None
    lib.mcaat_fuzz_ratio_all_pairs.argtypes = [u8, c.c_int64, i32, c.c_int32, f64]
    lib.mcaat_fuzz_substring_keep.restype = c.c_int32
    lib.mcaat_fuzz_substring_keep.argtypes = [u8, c.c_int64, i32, c.c_int32, i32, i64]
    lib.mcaat_fuzz_pair_scores.restype = None
    lib.mcaat_fuzz_pair_scores.argtypes = [u8, i32, u8, i32, c.c_int64, c.c_int64, c.c_int32,
                                           f64]
    _fuzz = lib
    return _fuzz


def _load_split() -> Optional[ctypes.CDLL]:
    """The ordering stage's SCC split library, built on first use."""
    global _split, _split_tried
    if _split_tried:
        return _split
    _split_tried = True
    lib = _open(_SPLIT_SRC)
    if lib is None:
        return None
    c = ctypes
    i32, i64, u8 = (c.POINTER(t) for t in (c.c_int32, c.c_int64, c.c_uint8))
    lib.mcaat_split.restype = c.c_int64
    lib.mcaat_split.argtypes = [i32, u8, c.c_int64, i32, i32, i64, u8, i32, i64]
    _split = lib
    return _split


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    _load_fastx()
    _load_fuzz()
    _load_split()
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


def scc_split(out, valid):
    """The SCC split of ``split.cpp`` over the [N, 4] out table ``out``
    and the validity mask ``valid``: ``(label, order, node_off, deg,
    targets, edge_off)`` as that file defines them, label [N] and the rest
    cut to their used lengths; None when split.cpp did not build, a node
    id does not fit int32, or a slot names a node outside the table."""
    lib = _load_split()
    if lib is None:
        return None
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = valid_u8.shape[0]
    out = np.asarray(out).reshape(n, 4)
    if n >= 2**31 or (out.dtype != np.int32 and out.size
                      and (out.max() >= n or out.min() < -(2**31))):
        return None
    out = np.ascontiguousarray(out, dtype=np.int32)
    label = np.empty(n, dtype=np.int32)
    order = np.empty(max(n, 1), dtype=np.int32)
    node_off = np.empty(n // 2 + 1, dtype=np.int64)
    deg = np.empty(max(n, 1), dtype=np.uint8)
    targets = np.empty(max(4 * n, 1), dtype=np.int32)
    edge_off = np.empty(n // 2 + 1, dtype=np.int64)
    count = lib.mcaat_split(_ptr(out, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8), n,
                            _ptr(label, ctypes.c_int32), _ptr(order, ctypes.c_int32),
                            _ptr(node_off, ctypes.c_int64), _ptr(deg, ctypes.c_uint8),
                            _ptr(targets, ctypes.c_int32), _ptr(edge_off, ctypes.c_int64))
    if count < 0:
        return None
    m, e = int(node_off[count]), int(edge_off[count])
    return (label, order[:m].copy(), node_off[:count + 1].copy(), deg[:m].copy(),
            targets[:e].copy(), edge_off[:count + 1].copy())


def native_available() -> bool:
    return _load() is not None


def set_threads(n: int) -> None:
    """Bound the native library's OpenMP team (the packer's parallel-for)
    to ``n`` threads — ≙ the reference's omp_set_num_threads
    (src/main.cpp:292-294) — and the FASTQ parser's threads; ``n`` <= 0
    unsets the bound (the parser takes every CPU, the team keeps its
    last bound). The team's bound is a no-op when the library is
    unbuilt/old."""
    global _threads
    _threads = int(n) if n > 0 else None
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


def parse_threads() -> int:
    """The FASTQ parser's threads: ``--threads`` when set, else the CPUs
    this process may run on."""
    if _threads:
        return _threads
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def parse_plain_fastq(path: str, threads: Optional[int] = None, cuts=None):
    """Parse a plain FASTQ file with the port's parser (fastx.cpp) into
    (codes [R, Lmax] uint8, lengths [R] int32), equal byte for byte to
    :func:`parse_fastx_batch`'s. ``threads`` defaults to
    :func:`parse_threads`; ``cuts`` (ascending byte offsets from 0 to the
    file's size) sets the threads' byte ranges instead. None when the
    library did not build or the file cannot be mapped."""
    lib = _load_fastx()
    if lib is None:
        return None
    c = ctypes
    n_threads = int(threads or parse_threads())
    cut_arr = None
    if cuts is not None:
        cut_arr = np.ascontiguousarray(cuts, dtype=np.int64)
        if (len(cut_arr) < 2 or cut_arr[0] != 0 or cut_arr[-1] != os.path.getsize(path)
                or (np.diff(cut_arr) < 0).any()):
            raise ValueError("cuts must ascend from 0 to the file's size")
    n_reads = c.c_int64()
    max_len = c.c_int32()
    h = lib.mcaat_fastq_index(
        path.encode(), n_threads,
        None if cut_arr is None else cut_arr.ctypes.data_as(c.POINTER(c.c_int64)),
        0 if cut_arr is None else len(cut_arr),
        c.byref(n_reads), c.byref(max_len),
    )
    if not h:
        return None
    return _fill(lib, h, int(n_reads.value), int(max_len.value), n_threads)


def _fill(lib, handle, n_reads: int, max_len: int, n_threads: int):
    """The codes and lengths of fastx.cpp's index ``handle``, which this
    closes."""
    c = ctypes
    try:
        codes = np.empty((n_reads, max_len), dtype=np.uint8)
        lengths = np.empty(n_reads, dtype=np.int32)
        lib.mcaat_fastq_fill(
            handle, codes.ctypes.data_as(c.POINTER(c.c_uint8)),
            lengths.ctypes.data_as(c.POINTER(c.c_int32)), n_threads,
        )
    finally:
        lib.mcaat_fastq_close(handle)
    return codes, lengths


def parse_gzip_fastq(paths: list, threads: Optional[int] = None):
    """Parse the gzipped FASTQ files ``paths`` with the port's parser
    (fastx.cpp): every file inflated whole by zlib at once, one thread a
    file up to ``threads`` (default :func:`parse_threads`), then coded on
    ``threads`` threads one file after the other. A file's entry is
    ``(codes, lengths)``, equal byte for byte to
    :func:`parse_fastx_batch`'s; None for a file that did not inflate
    exactly (a corrupt or truncated stream, bytes after its last member)
    or whose first inflated byte is not ``@``: the shared parser decides
    what such a file gives. None in place of the list when fastx.cpp did
    not build."""
    lib = _load_fastx()
    if lib is None:
        return None
    c = ctypes
    n, n_threads = len(paths), int(threads or parse_threads())
    if n == 0:
        return []
    names = (c.c_char_p * n)(*[os.fsencode(p) for p in paths])
    handles = (c.c_void_p * n)()
    n_reads = np.zeros(n, dtype=np.int64)
    max_len = np.zeros(n, dtype=np.int32)
    lib.mcaat_gzip_index(names, n, n_threads, handles,
                         _ptr(n_reads, c.c_int64), _ptr(max_len, c.c_int32))
    return [None if not handles[f] else
            _fill(lib, handles[f], int(n_reads[f]), int(max_len[f]), n_threads)
            for f in range(n)]


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


def _fuzz_rows(strings):
    """``strings`` as fuzz.cpp takes them: a [n, FUZZ_MAX_LEN] uint8
    matrix of their bytes, zero-padded, and their int32 lengths. None
    where a string is longer than FUZZ_MAX_LEN or has a character that is
    not one byte (a code point over 255)."""
    try:
        rows = [s.encode("latin-1") for s in strings]
    except UnicodeEncodeError:
        return None
    if any(len(r) > FUZZ_MAX_LEN for r in rows):
        return None
    mat = np.frombuffer(b"".join(r.ljust(FUZZ_MAX_LEN, b"\0") for r in rows), dtype=np.uint8)
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    return mat.reshape(len(rows), FUZZ_MAX_LEN), lens


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fuzz_ratio_all_pairs(strings: list[str]):
    """``report.fuzz.ratio(strings[i], strings[j])`` for every pair i < j
    in row order, as a float64 array equal bit for bit to the Python
    scores; None when fuzz.cpp did not build or a string does not fit
    (:func:`_fuzz_rows`)."""
    lib = _load_fuzz()
    rows = None if lib is None else _fuzz_rows(strings)
    if rows is None:
        return None
    mat, lens = rows
    n = len(strings)
    out = np.empty(n * (n - 1) // 2, dtype=np.float64)
    lib.mcaat_fuzz_ratio_all_pairs(_ptr(mat, ctypes.c_uint8), FUZZ_MAX_LEN,
                                   _ptr(lens, ctypes.c_int32), n, _ptr(out, ctypes.c_double))
    return out


def fuzz_substring_keep(strings: list[str]):
    """The substring filter's greedy scan over ``strings`` in their order
    (``report.analyzer.CRISPRAnalyzer.filter_substring_spacers`` after its
    sort): ``(kept indices, partial_ratio calls)``; None when fuzz.cpp did
    not build or a string does not fit (:func:`_fuzz_rows`)."""
    lib = _load_fuzz()
    rows = None if lib is None else _fuzz_rows(strings)
    if rows is None:
        return None
    mat, lens = rows
    kept = np.empty(len(strings), dtype=np.int32)
    pairs = ctypes.c_int64()
    n_kept = lib.mcaat_fuzz_substring_keep(_ptr(mat, ctypes.c_uint8), FUZZ_MAX_LEN,
                                           _ptr(lens, ctypes.c_int32), len(strings),
                                           _ptr(kept, ctypes.c_int32), ctypes.byref(pairs))
    return kept[:n_kept].tolist(), int(pairs.value)


def fuzz_pair_scores(a: list[str], b: list[str], partial: bool):
    """``partial_ratio(a[i], b[i])`` (or ``ratio`` when not ``partial``)
    for each i, as a float64 array; None when fuzz.cpp did not build or a
    string does not fit (:func:`_fuzz_rows`)."""
    if len(a) != len(b):
        raise ValueError("a and b must pair up")
    lib = _load_fuzz()
    rows_a = None if lib is None else _fuzz_rows(a)
    rows_b = None if rows_a is None else _fuzz_rows(b)
    if rows_b is None:
        return None
    out = np.empty(len(a), dtype=np.float64)
    lib.mcaat_fuzz_pair_scores(_ptr(rows_a[0], ctypes.c_uint8), _ptr(rows_a[1], ctypes.c_int32),
                               _ptr(rows_b[0], ctypes.c_uint8), _ptr(rows_b[1], ctypes.c_int32),
                               FUZZ_MAX_LEN, len(a), int(partial), _ptr(out, ctypes.c_double))
    return out
