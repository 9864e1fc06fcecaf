// Batched bit-parallel LCS and rapidfuzz fuzz::ratio for strings of at
// most 64 bases, one thread per pair, for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcaat_tpu/report/pallas_dp.py::_lcs_kernel
// (launched by lcs_batch_pallas, wrapped by ratio_batch_pallas). Same
// function, not the same layout: the TPU kernel split the 64-bit DP row
// into two uint32 words and laid pairs out as [G, 128] vector tiles; here
// each thread keeps the row in one native uint64 register.
//
// For each pair (a, b), with la = |a| and lb = |b| (Hyyro's algorithm, see
// lcs_core.cuh):
//   lcs   = LCS length of a and b
//   ratio = la + lb > 0 ? 200 * lcs / (la + lb) : 100 (float32, the same
//           expression as pallas_dp.py:195-196, so results are bitwise equal)
//
// Codes are 2-bit base codes (0..3) in uint8 rows of exactly 64 bytes;
// lengths must lie in [0, 64].
//
// What bounds it on an H100: each pair reads 136 bytes (two 64-byte code
// rows and two lengths) and writes 8, which at a million pairs is more
// time than its integer work needs at the card's peak. In practice it is
// the integer work, about 20 operations per base of b, that a thread has
// to get through, and close under it the loads: a million pairs of 26 to
// 40 bases take only a sixth less time than a million of 64 (PERF.md).
// The design keeps the integer work to what the data needs:
// a thread turns each of its two rows into two 64-bit bit planes with one
// multiply per four bases (row_planes), so the four match masks of a are
// three-input logic and not 64 predicated steps, and it walks b's planes
// by shifts for exactly lb steps (a warp runs as long as its longest b).
// Each row is four 16-byte loads a thread; a warp's loads touch 32
// separate rows, which a coalesced or 2-bit-packed layout would cure, but
// the rows are the public function's inputs as they are. Plain loads
// suffice: there is one pass over the data and nothing to overlap it
// with, and tensor cores have no part in an integer carry chain.
//
// No pipeline path launches it since the report's all-pairs score has a
// kernel of its own (ratio_matrix.cu), as partial_ratio has
// (partial_ratio.cu); it serves the public ratio_batch (its ratio output)
// and lcs_batch (its lcs output).

#include "lcs_core.cuh"

namespace {

using namespace lcs_core;

constexpr int kThreads = 256;

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

  uint64_t a0, a1, b0, b1;
  row_planes(a_codes + i * kMaxLen, a0, a1);
  row_planes(b_codes + i * kMaxLen, b0, b1);
  const RowMasks masks = match_masks(a0, a1, la);
  // a row holds 64 bases, whatever its length says
  const int lcs = lcs_row(masks, la, b0, b1, min(lb, kMaxLen));
  lcs_out[i] = lcs;
  ratio_out[i] = ratio_of(lcs, la + lb);
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
