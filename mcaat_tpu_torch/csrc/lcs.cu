// Batched bit-parallel LCS and rapidfuzz fuzz::ratio for strings of at
// most 64 bases, one thread per pair, for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcaat_tpu/report/pallas_dp.py::_lcs_kernel
// (launched by lcs_batch_pallas, wrapped by ratio_batch_pallas). Same
// function, not the same layout: the TPU kernel split the 64-bit DP row
// into two uint32 words and laid pairs out as [G, 128] vector tiles; here
// each thread keeps the row in one native uint64 register.
//
// For each pair (a, b), with la = |a| and lb = |b| (Hyyro's algorithm):
//   M[c]  = bit p set iff a[p] == c, for p < la      (match masks, in registers)
//   full  = la == 64 ? ~0 : (1 << la) - 1            (never shifts by 64)
//   S     = full; for j < lb: U = S & M[b[j]]; S = ((S + U) | (S - U)) & full
//   lcs   = la - popcount(S & full)
//   ratio = la + lb > 0 ? 200 * lcs / (la + lb) : 100 (float32, the same
//           expression as pallas_dp.py:195-196, so results are bitwise equal)
//
// Codes are 2-bit base codes (0..3) in uint8 rows of exactly 64 bytes;
// lengths must lie in [0, 64].
//
// What bounds it on an H100: each pair reads 136 bytes (two 64-byte code
// rows and two lengths) and writes 8, and does about 10 integer
// operations per base of b. On the report's main path it serves the
// diversity check (pairwise_ratio_matrix: n^2 pairs, 900 for a 30-spacer
// array), so a launch is latency-bound. At 1M pairs it is memory-bound;
// each thread reads its rows as four 16-byte vector loads. Coalesced
// (transposed or packed) code layouts are left for later. partial_ratio
// has a kernel of its own that expands the alignment windows on the card
// (partial_ratio.cu).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLen = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ void load_row(const uint8_t* __restrict__ base,
                                         int64_t row, uint32_t words[16]) {
  const uint4* p = reinterpret_cast<const uint4*>(base + row * kMaxLen);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = p[q];
    words[4 * q + 0] = v.x;
    words[4 * q + 1] = v.y;
    words[4 * q + 2] = v.z;
    words[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
lcs_ratio_kernel(const uint8_t* __restrict__ a_codes,
                 const int32_t* __restrict__ a_lengths,
                 const uint8_t* __restrict__ b_codes,
                 const int32_t* __restrict__ b_lengths,
                 int32_t* __restrict__ lcs_out,
                 float* __restrict__ ratio_out,
                 int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int la = a_lengths[i];
  const int lb = b_lengths[i];

  uint32_t words[16];
  load_row(a_codes, i, words);
  uint64_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
#pragma unroll
  for (int p = 0; p < kMaxLen; ++p) {
    const uint32_t c = (words[p >> 2] >> (8 * (p & 3))) & 3u;
    const uint64_t bit = (p < la) ? (1ull << p) : 0ull;
    m0 |= (c == 0u) ? bit : 0ull;
    m1 |= (c == 1u) ? bit : 0ull;
    m2 |= (c == 2u) ? bit : 0ull;
    m3 |= (c == 3u) ? bit : 0ull;
  }
  const uint64_t full = (la >= kMaxLen) ? ~0ull : ((1ull << la) - 1ull);

  load_row(b_codes, i, words);
  uint64_t s = full;
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) {
    const uint32_t c = (words[j >> 2] >> (8 * (j & 3))) & 3u;
    const uint64_t m = (c == 0u) ? m0 : (c == 1u) ? m1 : (c == 2u) ? m2 : m3;
    const uint64_t u = s & m;
    const uint64_t next = ((s + u) | (s - u)) & full;
    s = (j < lb) ? next : s;
  }
  const int lcs = la - __popcll(s & full);
  lcs_out[i] = lcs;
  const int total = la + lb;
  ratio_out[i] = total > 0
      ? 200.0f * static_cast<float>(lcs) / static_cast<float>(total)
      : 100.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller.
extern "C" int mcaat_lcs_ratio(const void* a_codes, const void* a_lengths,
                               const void* b_codes, const void* b_lengths,
                               void* lcs_out, void* ratio_out, int64_t n,
                               void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    lcs_ratio_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a_codes),
        static_cast<const int32_t*>(a_lengths),
        static_cast<const uint8_t*>(b_codes),
        static_cast<const int32_t*>(b_lengths),
        static_cast<int32_t*>(lcs_out), static_cast<float*>(ratio_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
