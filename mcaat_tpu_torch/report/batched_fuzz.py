"""Batched similarity scoring (rapidfuzz semantics) on the device.

Port of ``mcaat_tpu/report/batched_fuzz.py``. Strings here are spacers
and repeats of at most 64 bases, so Hyyrö's bit-parallel LCS fits one
64-bit row.

``ratio``         = 100 * 2*LCS(a,b) / (|a|+|b|)      (indel distance)
``partial_ratio`` = max ratio of the shorter string against every
                    alignment window of the longer; the windows are
                    expanded on the host into extra batch lanes.

:func:`ratio_batch` dispatches on where its tensors live: CUDA tensors
go to the hand-written kernel (``report/lcs_cuda.py``, ``csrc/lcs.cu``),
CPU tensors to the plain torch version below (:func:`lcs_ratio_plain`),
which is also what the kernel is checked against.
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


def lcs_batch(a_codes, a_lengths, b_codes, b_lengths) -> torch.Tensor:
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


def lcs_ratio_plain(a_codes, a_lengths, b_codes, b_lengths):
    """Plain torch ``(lcs int32 [B], ratio float32 [B])``: what the CUDA
    kernel computes, on any device. The ratio is the expression of
    pallas_dp.py:195-196, evaluated in the same order."""
    lcs = lcs_batch(a_codes, a_lengths, b_codes, b_lengths)
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


def pairwise_ratio_matrix(strings: list[str], device) -> np.ndarray:
    """All-pairs fuzz::ratio for ≤64bp strings, one batched call."""
    n = len(strings)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float32)
    codes, lengths = encode_batch(strings)
    codes_t = torch.as_tensor(codes, device=device)
    lengths_t = torch.as_tensor(lengths, device=device)
    ii = torch.arange(n, device=device).repeat_interleave(n)
    jj = torch.arange(n, device=device).repeat(n)
    r = ratio_batch(codes_t[ii], lengths_t[ii], codes_t[jj], lengths_t[jj])
    return r.cpu().numpy().reshape(n, n)


def partial_ratio_pairs(shorts: list[str], longs: list[str], device) -> np.ndarray:
    """fuzz::partial_ratio per (shorts[i], longs[i]) pair, one batched call.

    Every alignment window (including clipped edges) becomes a lane; the
    per-pair max is reduced on the host.
    """
    assert len(shorts) == len(longs)
    if not shorts:
        return np.zeros((0,), dtype=np.float32)
    a_list, b_list, owner = [], [], []
    for idx, (a, b) in enumerate(zip(shorts, longs)):
        s, l = (a, b) if len(a) <= len(b) else (b, a)
        ls, ll = len(s), len(l)
        if ls == 0:
            a_list.append(s)
            b_list.append(l)
            owner.append(idx)
            continue
        for start in range(-(ls - 1), max(ll, 1)):
            win = l[max(0, start) : max(0, start + ls)]
            if not win:
                continue
            a_list.append(s)
            b_list.append(win)
            owner.append(idx)
    a_c, a_l = encode_batch(a_list)
    b_c, b_l = encode_batch(b_list)

    def dev(x):
        return torch.as_tensor(x, device=device)

    r = ratio_batch(dev(a_c), dev(a_l), dev(b_c), dev(b_l)).cpu().numpy()
    out = np.zeros(len(shorts), dtype=np.float32)
    for lane, idx in enumerate(owner):
        if len(shorts[idx]) == 0 and len(longs[idx]) == 0:
            out[idx] = 100.0
        out[idx] = max(out[idx], r[lane])
    return out
