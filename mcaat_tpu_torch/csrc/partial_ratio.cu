// Fused rapidfuzz fuzz::partial_ratio over a table of strings of at most
// 64 bases, one warp per pair, for Hopper (sm_90a).
//
// Replaces, for partial_ratio, the Pallas kernel
// mcaat_tpu/report/pallas_dp.py::_lcs_kernel together with the host code
// that fed it (mcaat_tpu/report/batched_fuzz.py::partial_ratio_pairs):
// there every alignment window of every pair was cut out on the host,
// encoded and uploaded as a batch lane of its own, and the per-pair
// maximum was taken on the host again. Here the card gets the table of
// unique strings and one (short, long) index pair per pair; the windows
// exist only in registers.
//
// For a pair (s, l) with ls = |s| and ll = |l| the result is
//   ls == 0:  ratio("", l), that is 100 if ll == 0, else 0
//   ls  > 0:  max(0, max over start in [-(ls-1), max(ll, 1)) of
//                 ratio(s, l[max(0,start) : min(ll, start+ls)]))
//             with empty windows skipped,
// where ratio(a, b) = 200 * lcs(a, b) / (|a| + |b|) in float32, the same
// expression as lcs.cu and pallas_dp.py:195-196, so results are bitwise
// equal to those of the expanded route. lcs is Hyyro's bit-parallel
// recurrence with s as the 64-bit row (see lcs_core.cuh). The float32
// maximum is exact, so the order of the reduction is free.
//
// What bounds it on an H100: nothing the card is short of. A report
// system has 25-64 unique strings (2-4 KB of codes) and n(n-1)/2 pairs
// (435 at n = 30, about 28 thousand windows of about 30 steps of about a
// dozen integer operations: some 10 M operations). Bytes and operations
// both fit in a microsecond, so a launch is latency-bound, and what
// counted on the expanded route was the host work around it. The design
// therefore reads each string of a pair once (lane p loads bases p and
// p+32; the table stays in L1/L2) and shares it through __ballot_sync:
// two bit planes of s give the four match masks once per pair, two bit
// planes of l give every lane the whole long string in two registers, so
// a window is a shift and nothing goes through shared or device memory.
// Lanes take windows lane, lane+32, ... (at most 127 a pair), each runs
// the recurrence over its window's own length only, and the warp's
// maximum is five __shfl_xor_sync steps. Plain loads suffice: at this
// size cp.async or TMA have nothing to overlap, and tensor cores have no
// part in an integer carry chain.
//
// Codes are 2-bit base codes in uint8 rows of exactly 64 bytes. A pair
// whose index lies outside [0, n) or whose string has a length outside
// [0, 64] gets NaN and reads nothing outside the table.

#include <cmath>

#include "lcs_core.cuh"

namespace {

using namespace lcs_core;

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
partial_ratio_kernel(const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ s_idx,
                     const int32_t* __restrict__ l_idx,
                     float* __restrict__ out, int n, int64_t n_pairs) {
  const int lane = threadIdx.x & 31;
  // one warp per pair: everything up to the reduction is warp-uniform
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;
  const int si = s_idx[pair];
  const int li = l_idx[pair];
  if (si < 0 || si >= n || li < 0 || li >= n) {
    if (lane == 0) out[pair] = nanf("");
    return;
  }
  const int ls = lengths[si];
  const int ll = lengths[li];
  if (ls < 0 || ls > kMaxLen || ll < 0 || ll > kMaxLen) {
    if (lane == 0) out[pair] = nanf("");
    return;
  }
  if (ls == 0) {
    if (lane == 0) out[pair] = (ll == 0) ? 100.0f : 0.0f;
    return;
  }

  uint64_t s0, s1, l0, l1;
  bit_planes(codes + static_cast<int64_t>(si) * kMaxLen, lane, s0, s1);
  bit_planes(codes + static_cast<int64_t>(li) * kMaxLen, lane, l0, l1);
  const RowMasks masks = match_masks(s0, s1, ls);

  float best = 0.0f;
  const int n_windows = ls - 1 + max(ll, 1);
  for (int w = lane; w < n_windows; w += 32) {
    const int start = w - (ls - 1);
    const int begin = max(start, 0);
    const int lw = min(ll, start + ls) - begin;
    if (lw <= 0) continue;
    // begin < ll <= 64 here, so the shifts are below 64
    const int lcs = lcs_row(masks, ls, l0 >> begin, l1 >> begin, lw);
    best = fmaxf(best, ratio_of(lcs, ls + lw));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(kFullWarp, best, d));
  }
  if (lane == 0) out[pair] = best;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller.
extern "C" int mcaat_partial_ratio(const void* codes, const void* lengths,
                                   const void* s_idx, const void* l_idx,
                                   void* out, int n, int64_t n_pairs,
                                   void* stream) {
  if (n_pairs > 0) {
    const int64_t blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    partial_ratio_kernel<<<static_cast<unsigned int>(blocks),
                           kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(s_idx),
        static_cast<const int32_t*>(l_idx), static_cast<float*>(out), n,
        n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
