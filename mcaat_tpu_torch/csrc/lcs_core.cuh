// The register core shared by the three LCS kernels (lcs.cu,
// partial_ratio.cu, ratio_matrix.cu): a string of at most 64 bases as two
// 64-bit bit planes, its four match masks, and Hyyro's bit-parallel LCS
// recurrence over them.
//
// A string is a row of exactly 64 bytes of 2-bit base codes. Bit p of
// plane0 / plane1 is bit 0 / bit 1 of the code at position p, so
//   M[c] = bit p set iff row[p] == c, for p < len
// is three-input logic on the planes (match_masks), and walking a string
// base by base is a shift of its planes by one (lcs_row).
//
// With a as the bit-parallel row, la = |a|, and b walked over lb bases:
//   full = la == 64 ? ~0 : (1 << la) - 1            (never shifts by 64)
//   S    = full; for j < lb: U = S & M[b[j]]; S = ((S + U) | (S - U)) & full
//   lcs  = la - popcount(S & full)
// U is a subset of S, so S - U borrows nothing and equals S ^ U.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lcs_core {

constexpr int kMaxLen = 64;
constexpr unsigned kFullWarp = 0xffffffffu;

// Bit planes of one 64-byte code row, read by a whole warp: lane p loads
// bases p and p + 32 (one coalesced 64-byte read) and four ballots give
// every lane both planes. Every lane of the warp must call it.
__device__ __forceinline__ void bit_planes(const uint8_t* __restrict__ row,
                                           int lane, uint64_t& plane0,
                                           uint64_t& plane1) {
  const uint32_t lo = row[lane];
  const uint32_t hi = row[lane + 32];
  const uint32_t p0_lo = __ballot_sync(kFullWarp, lo & 1u);
  const uint32_t p0_hi = __ballot_sync(kFullWarp, hi & 1u);
  const uint32_t p1_lo = __ballot_sync(kFullWarp, lo & 2u);
  const uint32_t p1_hi = __ballot_sync(kFullWarp, hi & 2u);
  plane0 = (static_cast<uint64_t>(p0_hi) << 32) | p0_lo;
  plane1 = (static_cast<uint64_t>(p1_hi) << 32) | p1_lo;
}

// Bit 0 of each of the four bytes of `word`, gathered into bits 0..3 by
// one multiply: byte k's bit sits at 8k and the factor's terms 2^(28-7k)
// carry it to 28 + k; every other product term lands below 28 or past 31,
// and no two terms meet, so nothing carries.
__device__ __forceinline__ uint32_t gather_bit0(uint32_t word) {
  return ((word & 0x01010101u) * 0x10204080u) >> 28;
}

// Bit planes of one 64-byte code row, read by one thread: four 16-byte
// loads, all in flight together, then one multiply per plane for every
// four bases. `row` must be 16-byte aligned.
__device__ __forceinline__ void row_planes(const uint8_t* __restrict__ row,
                                           uint64_t& plane0,
                                           uint64_t& plane1) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
  uint32_t half0[2] = {0u, 0u}, half1[2] = {0u, 0u};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(p + q);  // bases 16q .. 16q+15
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at = 16 * (q & 1) + 4 * k;
      half0[q >> 1] |= gather_bit0(words[k]) << at;
      half1[q >> 1] |= gather_bit0(words[k] >> 1) << at;
    }
  }
  plane0 = (static_cast<uint64_t>(half0[1]) << 32) | half0[0];
  plane1 = (static_cast<uint64_t>(half1[1]) << 32) | half1[0];
}

// The bit-parallel row string: its match masks and the mask of its length.
struct RowMasks {
  uint64_t m0, m1, m2, m3, full;
};

__device__ __forceinline__ RowMasks match_masks(uint64_t plane0,
                                                uint64_t plane1, int len) {
  RowMasks r;
  r.full = (len >= kMaxLen) ? ~0ull : ((1ull << len) - 1ull);
  r.m0 = ~plane1 & ~plane0 & r.full;
  r.m1 = ~plane1 & plane0 & r.full;
  r.m2 = plane1 & ~plane0 & r.full;
  r.m3 = plane1 & plane0 & r.full;
  return r;
}

// LCS length of the row string (`len` bases) and the first `lb` bases of
// the string whose planes are b0 / b1: exactly lb steps, nothing but
// registers. lb must lie in [0, 64]. The "& full" of the recurrence is
// taken once, after the loop: the masks hold no bit at or above len, a
// sum carries upwards only and the rest is bitwise, so what a step leaves
// above the row never reaches the bits below.
__device__ __forceinline__ int lcs_row(const RowMasks& a, int len,
                                       uint64_t b0, uint64_t b1, int lb) {
  uint64_t s = a.full;
  for (int j = 0; j < lb; ++j) {
    const uint64_t m = (b1 & 1ull) ? ((b0 & 1ull) ? a.m3 : a.m2)
                                   : ((b0 & 1ull) ? a.m1 : a.m0);
    b0 >>= 1;
    b1 >>= 1;
    const uint64_t u = s & m;
    s = (s + u) | (s ^ u);
  }
  return len - __popcll(s & a.full);
}

// rapidfuzz fuzz::ratio in float32: the expression of
// mcaat_tpu/report/pallas_dp.py:195-196 in its order, so results are
// bitwise equal to the JAX package's.
__device__ __forceinline__ float ratio_of(int lcs, int total) {
  return total > 0
      ? 200.0f * static_cast<float>(lcs) / static_cast<float>(total)
      : 100.0f;
}

}  // namespace lcs_core
