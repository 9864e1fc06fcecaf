"""Batched similarity scoring (rapidfuzz semantics) on the device.

Port of ``mcaat_tpu/report/batched_fuzz.py``. Strings here are spacers
and repeats of at most 64 bases, so Hyyrö's bit-parallel LCS fits one
64-bit row.

``ratio``         = 100 * 2*LCS(a,b) / (|a|+|b|)      (indel distance)
``partial_ratio`` = max ratio of the shorter string against every
                    alignment window of the longer; the device expands
                    the windows from a table of the distinct strings.

:func:`lcs_batch`, :func:`ratio_batch`, :func:`ratio_matrix` and
:func:`partial_ratio_table` dispatch on where their tensors live: CUDA
tensors go to the hand-written kernels (``report/lcs_cuda.py``;
``csrc/lcs.cu``, ``csrc/ratio_matrix.cu``, ``csrc/partial_ratio.cu``),
CPU tensors to the plain torch versions below (:func:`lcs_batch_plain`,
:func:`lcs_ratio_plain`, :func:`ratio_matrix_plain`,
:func:`partial_ratio_table_plain`), which are also what the kernels are
checked against.
"""

from __future__ import annotations

import numpy as np
import torch

MAXLEN = 64  # bits in the DP row
_M32 = 0xFFFFFFFF


def encode_batch(strings: list[str], maxlen: int = MAXLEN):
    """ASCII strings -> (codes uint8 [B, maxlen], lengths int32 [B]).

    2-bit coding with non-ACGT collapsed to T — the pipeline's base
    coding, which is also what the host fuzz sees.
    """
    lut = np.full(256, 3, dtype=np.uint8)
    for i, b in enumerate("ACGT"):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    codes = np.zeros((len(strings), maxlen), dtype=np.uint8)
    lengths = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)[:maxlen]
        codes[i, : len(raw)] = lut[raw]
        lengths[i] = len(raw)
    return codes, lengths


def _match_masks(codes: torch.Tensor, lengths: torch.Tensor):
    """Per-lane match masks ``[B, 4, 2]`` int64: (low word, high word) of
    the 64-bit mask of each base code, 32 bits per word. Bits are
    disjoint, so summing them equals OR-ing them."""
    B, L = codes.shape
    dev = codes.device
    pos = torch.arange(L, device=dev)
    live = pos[None, :] < lengths[:, None]
    bit = torch.ones(L, dtype=torch.int64, device=dev) << (pos % 32)
    lo_bit = torch.where((pos < 32)[None, :] & live, bit, 0)
    hi_bit = torch.where((pos >= 32)[None, :] & live, bit, 0)
    c = (codes & 3).to(torch.int64)
    words = []
    for base in range(4):
        m = c == base
        lo = torch.where(m, lo_bit, 0).sum(dim=1)
        hi = torch.where(m, hi_bit, 0).sum(dim=1)
        words.append(torch.stack([lo, hi], dim=1))
    return torch.stack(words, dim=1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def lcs_batch_plain(a_codes, a_lengths, b_codes, b_lengths) -> torch.Tensor:
    """LCS length per lane, int32 [B]; plain torch on any device.

    ``a`` is the bit-parallel row (|a| ≤ 64). The 64-bit row is held as
    two 32-bit words in int64 tensors, so the carries of ``S + U`` and
    the borrows of ``S - U`` are explicit and nothing overflows.
    """
    B = a_codes.shape[0]
    masks = _match_masks(a_codes, a_lengths)  # [B, 4, 2]
    la = a_lengths.to(torch.int64)
    one = torch.ones_like(la)
    full_lo = torch.where(la >= 32, _M32, (one << torch.clamp(la, 0, 31)) - 1)
    ha = torch.clamp(la - 32, min=0)
    full_hi = torch.where(ha >= 32, _M32, (one << torch.clamp(ha, max=31)) - 1)
    lb = b_lengths.to(torch.int64)
    b_c = (b_codes & 3).to(torch.int64)
    slo, shi = full_lo, full_hi
    for j in range(b_codes.shape[1]):
        m = torch.gather(masks, 1, b_c[:, j, None, None].expand(B, 1, 2))[:, 0]
        ulo, uhi = slo & m[:, 0], shi & m[:, 1]
        plo = slo + ulo
        phi = (shi + uhi + (plo >> 32)) & _M32
        qlo = slo - ulo
        qhi = (shi - uhi - (qlo < 0).to(torch.int64)) & _M32
        nlo, nhi = (plo | qlo) & _M32, phi | qhi
        live = j < lb
        slo = torch.where(live, nlo & full_lo, slo)
        shi = torch.where(live, nhi & full_hi, shi)
    ones = _popcount32(slo & full_lo) + _popcount32(shi & full_hi)
    return (la - ones).to(torch.int32)


def lcs_batch(a_codes, a_lengths, b_codes, b_lengths) -> torch.Tensor:
    """LCS length per lane, int32 [B]: the CUDA kernel's ``lcs`` output
    for tensors on the card (``lcs_ratio_kernel`` writes the length
    beside the ratio), the plain version for tensors on the CPU."""
    dev = a_codes.device
    if dev.type == "cuda":
        from mcaat_tpu_torch.report.lcs_cuda import lcs_ratio_cuda

        return lcs_ratio_cuda(a_codes, a_lengths, b_codes, b_lengths)[0]
    if dev.type == "cpu":
        return lcs_batch_plain(a_codes, a_lengths, b_codes, b_lengths)
    raise ValueError(f"lcs_batch: unsupported device {dev}")


def lcs_ratio_plain(a_codes, a_lengths, b_codes, b_lengths):
    """Plain torch ``(lcs int32 [B], ratio float32 [B])``: what the CUDA
    kernel computes, on any device. The ratio is the expression of
    pallas_dp.py:195-196, evaluated in the same order."""
    lcs = lcs_batch_plain(a_codes, a_lengths, b_codes, b_lengths)
    total = (a_lengths + b_lengths).to(torch.float32)
    ratio = torch.where(
        total > 0, 200.0 * lcs.to(torch.float32) / total, torch.full_like(total, 100.0)
    )
    return lcs, ratio


def ratio_batch(a_codes, a_lengths, b_codes, b_lengths) -> torch.Tensor:
    """fuzz::ratio per lane, float32 [B] in [0, 100]: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    dev = a_codes.device
    if dev.type == "cuda":
        from mcaat_tpu_torch.report.lcs_cuda import lcs_ratio_cuda

        return lcs_ratio_cuda(a_codes, a_lengths, b_codes, b_lengths)[1]
    if dev.type == "cpu":
        return lcs_ratio_plain(a_codes, a_lengths, b_codes, b_lengths)[1]
    raise ValueError(f"ratio_batch: unsupported device {dev}")


def ratio_matrix_plain(codes, lengths) -> torch.Tensor:
    """Plain torch all-pairs fuzz::ratio (float32 [n, n]) of a string
    table, on any device: what the all-pairs CUDA kernel computes. Every
    one of the n² pairs is laid out as a lane (row ``i`` against row
    ``j`` at ``i * n + j``) and scored by :func:`lcs_ratio_plain`."""
    n = codes.shape[0]
    dev = codes.device
    if n == 0:
        return torch.zeros((0, 0), dtype=torch.float32, device=dev)
    ii = torch.arange(n, device=dev).repeat_interleave(n)
    jj = torch.arange(n, device=dev).repeat(n)
    _lcs, r = lcs_ratio_plain(codes[ii], lengths[ii], codes[jj], lengths[jj])
    return r.view(n, n)


def ratio_matrix(codes, lengths) -> torch.Tensor:
    """All-pairs fuzz::ratio of a string table, float32 [n, n]: the
    all-pairs CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    dev = codes.device
    if dev.type == "cuda":
        from mcaat_tpu_torch.report.lcs_cuda import ratio_matrix_cuda

        return ratio_matrix_cuda(codes, lengths)
    if dev.type == "cpu":
        return ratio_matrix_plain(codes, lengths)
    raise ValueError(f"ratio_matrix: unsupported device {dev}")


def pairwise_ratio_matrix(strings: list[str], device) -> np.ndarray:
    """All-pairs fuzz::ratio for ≤64bp strings, one batched call: the
    table goes up in one buffer (the codes as int32 words, then the
    lengths, cut into views on the device), one score per pair comes
    back. A longer string is scored by its first 64 bases
    (:func:`encode_batch`), as in ``mcaat_tpu``."""
    n = len(strings)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float32)
    codes, lengths = encode_batch(strings)
    buf = torch.as_tensor(
        np.concatenate([codes.view(np.int32).reshape(-1), lengths]), device=device
    )
    words = n * MAXLEN // 4
    out = ratio_matrix(
        buf[:words].view(torch.uint8).view(n, MAXLEN), buf[words:]
    ).cpu().numpy()
    if np.isnan(out).any():
        raise RuntimeError("pairwise_ratio_matrix: the kernel refused a string's length")
    return out


def partial_ratio_table_plain(codes, lengths, s_idx, l_idx) -> torch.Tensor:
    """Plain torch fuzz::partial_ratio (float32 [P]) of P pairs of rows of
    a string table, on any device: what the fused CUDA kernel computes.

    Pair ``p`` scores row ``s_idx[p]`` (the bit-parallel row) against
    every alignment window of row ``l_idx[p]``, clipped edges included:
    window ``w`` starts at ``w - (ls - 1)``, and empty windows are
    skipped. An empty ``s`` has the one window "all of ``l``". The windows
    are laid out as lanes with tensor ops, scored by
    :func:`lcs_ratio_plain`, and reduced by a segment maximum that starts
    at 0.
    """
    dev = codes.device
    P = s_idx.shape[0]
    if P == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    si, li = s_idx.to(torch.int64), l_idx.to(torch.int64)
    ls, ll = lengths[si].to(torch.int64), lengths[li].to(torch.int64)
    empty = ls == 0
    w = torch.arange(2 * MAXLEN - 1, device=dev)[None, :]  # at most 127 windows
    start = torch.where(empty[:, None], 0, w - (ls[:, None] - 1))
    begin = torch.clamp(start, min=0)
    end = torch.where(empty[:, None], ll[:, None], torch.minimum(ll[:, None], start + ls[:, None]))
    n_win = torch.where(empty, 1, ls - 1 + torch.clamp(ll, min=1))
    live = (w < n_win[:, None]) & ((end > begin) | empty[:, None])
    owner, col = torch.nonzero(live, as_tuple=True)  # one lane per window
    b0 = begin[owner, col]
    lw = (end[owner, col] - b0).to(torch.int32)
    pos = b0[:, None] + torch.arange(MAXLEN, device=dev)[None, :]
    b_codes = torch.gather(codes[li[owner]], 1, torch.clamp(pos, max=MAXLEN - 1))
    _lcs, r = lcs_ratio_plain(codes[si[owner]], lengths[si[owner]], b_codes, lw)
    out = torch.zeros(P, dtype=torch.float32, device=dev)
    return out.scatter_reduce(0, owner, r, "amax", include_self=True)


def partial_ratio_table(codes, lengths, s_idx, l_idx) -> torch.Tensor:
    """fuzz::partial_ratio per pair of table rows, float32 [P]: the fused
    CUDA kernel for tensors on the card, the plain version for tensors on
    the CPU."""
    dev = codes.device
    if dev.type == "cuda":
        from mcaat_tpu_torch.report.lcs_cuda import partial_ratio_cuda

        return partial_ratio_cuda(codes, lengths, s_idx, l_idx)
    if dev.type == "cpu":
        return partial_ratio_table_plain(codes, lengths, s_idx, l_idx)
    raise ValueError(f"partial_ratio_table: unsupported device {dev}")


def partial_ratio_pairs(shorts: list[str], longs: list[str], device) -> np.ndarray:
    """fuzz::partial_ratio per (shorts[i], longs[i]) pair, one batched call.

    The distinct strings are encoded once into a table; the device gets
    the table and one (short, long) row index pair per pair, expands the
    alignment windows itself and returns one score per pair. Of two
    strings the shorter is windowed over the longer, and ``shorts[i]``
    when the lengths tie (equal lengths are not symmetric under
    windowing). A string of more than 64 bases raises ``ValueError`` on
    every device: the DP row has 64 bits. (``mcaat_tpu`` cuts such a
    string, and each of its windows, to 64 bases in silence; no caller
    passes one.)
    """
    assert len(shorts) == len(longs)
    if not shorts:
        return np.zeros((0,), dtype=np.float32)
    rows: dict[str, int] = {}
    a_idx = np.array([rows.setdefault(s, len(rows)) for s in shorts], dtype=np.int32)
    b_idx = np.array([rows.setdefault(s, len(rows)) for s in longs], dtype=np.int32)
    table = list(rows)
    longest = max(table, key=len)
    if len(longest) > MAXLEN:
        raise ValueError(
            f"partial_ratio_pairs: a string of {len(longest)} bases; the batched "
            f"score takes at most {MAXLEN}"
        )
    codes, lengths = encode_batch(table)
    swap = lengths[a_idx] > lengths[b_idx]
    s_idx = np.where(swap, b_idx, a_idx)
    l_idx = np.where(swap, a_idx, b_idx)
    # one upload: the table's codes (as int32 words), its lengths and both
    # index vectors in one buffer, cut into views on the device
    n, P = len(table), len(shorts)
    buf = torch.as_tensor(
        np.concatenate([codes.view(np.int32).reshape(-1), lengths, s_idx, l_idx]),
        device=device,
    )
    words = n * MAXLEN // 4
    out = partial_ratio_table(
        buf[:words].view(torch.uint8).view(n, MAXLEN),
        buf[words : words + n],
        buf[words + n : words + n + P],
        buf[words + n + P :],
    ).cpu().numpy()
    if np.isnan(out).any():
        raise RuntimeError("partial_ratio_pairs: the kernel refused a pair's index or length")
    return out
