// All-pairs rapidfuzz fuzz::ratio of a table of strings of at most 64
// bases, one thread per row string, for Hopper (sm_90a).
//
// Replaces, for the all-pairs score, the Pallas kernel
// mcaat_tpu/report/pallas_dp.py::_lcs_kernel together with the host code
// that fed it (mcaat_tpu/report/batched_fuzz.py::pairwise_ratio_matrix):
// there a meshgrid of the n^2 index pairs gathered four [n^2, ...] arrays
// on the host, because the TPU kernel wants its pairs as lanes of
// [G, 128] tiles. Here the card gets the table (n rows of codes, n
// lengths) and the kernel works out its pairs from blockIdx and
// threadIdx.
//
//   out[i, j] = ratio(table[i], table[j])
//             = la + lb > 0 ? 200 * lcs / (la + lb) : 100      (float32)
//
// the expression of lcs.cu and pallas_dp.py:195-196, so the matrix is
// bitwise what the per-pair kernel gives on the gathered pairs. A string
// with a length outside [0, 64] gets NaN in its row and its column and
// none of its codes is read.
//
// What bounds it on an H100: integer operations and, at report sizes,
// latency; never bytes. The table is small (2 KB at n = 30, 70 KB at
// n = 1024) and every string is used 2n times, so it stays in L1/L2, and
// the matrix is written once. The design spends its operations on the
// recurrence alone:
//   - a thread owns one row string i: its bit planes come from four
//     16-byte loads and one multiply per four bases (row_planes), and its
//     four match masks stay in registers for the thread's whole life, so
//     masks are built once a string and not once a pair;
//   - a warp owns 32 neighbouring rows and walks a run of columns j. A
//     block first turns its columns into bit planes and lengths in shared
//     memory (20 bytes a string, one thread a column); in the loop the
//     column is a broadcast read, the same for every lane, so the
//     recurrence runs exactly lb steps with no divergence and touches no
//     memory;
//   - the LCS is symmetric and the ratio depends on la + lb only, so
//     ratio(i, j) == ratio(j, i) bit for bit: the warp stores its 32
//     scores of column j at out[j, i0 .. i0+31], 128 contiguous bytes.
//     For the same reason only the tiles on and above the diagonal are
//     computed: a warp whose column lies past its own rows also stores
//     the mirror out[i, j], and a block below the diagonal has nothing to
//     do;
//   - the wrapper picks the run from n, so that a 30-string table still
//     spreads over the card (one column a warp) and a large one keeps
//     about as many warps as the card holds at a time: the recurrence is
//     one dependent chain a thread, so it is other warps that fill the
//     integer pipes. At 1,024 strings runs of 2 columns measured fastest
//     (the masks are then a twelfth of a thread's operations) and runs
//     of 8 or more, which leave a scheduler with 4 warps or fewer, slower.
// Ballots (lcs_core.cuh::bit_planes) would read a row coalesced, but 32
// rounds of them a warp cost more operations than the multiplies, and
// the table is in cache. cp.async or TMA have nothing to overlap here,
// and tensor cores have no part in an integer carry chain.

#include <cmath>

#include "lcs_core.cuh"

namespace {

using namespace lcs_core;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxRun = 64;  // columns a warp walks at most

__global__ void __launch_bounds__(kThreads)
ratio_matrix_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int n, int run) {
  __shared__ uint64_t col_plane0[kWarpsPerBlock * kMaxRun];
  __shared__ uint64_t col_plane1[kWarpsPerBlock * kMaxRun];
  __shared__ int32_t col_length[kWarpsPerBlock * kMaxRun];  // -1: refused

  const int i0 = static_cast<int>(blockIdx.y) * 32;  // the block's rows
  const int j0 = static_cast<int>(blockIdx.x) * kWarpsPerBlock * run;
  const int cols = min(kWarpsPerBlock * run, n - j0);
  // below the diagonal: the mirror writes it
  if (j0 + cols <= i0) return;

  for (int t = threadIdx.x; t < cols; t += kThreads) {
    int lb = lengths[j0 + t];
    uint64_t b0 = 0, b1 = 0;
    if (lb < 0 || lb > kMaxLen) {
      lb = -1;
    } else {
      row_planes(codes + static_cast<int64_t>(j0 + t) * kMaxLen, b0, b1);
    }
    col_plane0[t] = b0;
    col_plane1[t] = b1;
    col_length[t] = lb;
  }
  __syncthreads();

  const int i = i0 + (threadIdx.x & 31);
  if (i >= n) return;
  const int la = lengths[i];
  const bool refused = la < 0 || la > kMaxLen;
  uint64_t a0 = 0, a1 = 0;
  if (!refused) row_planes(codes + static_cast<int64_t>(i) * kMaxLen, a0, a1);
  const RowMasks masks = match_masks(a0, a1, refused ? 0 : la);

  const int first = (threadIdx.x >> 5) * run;  // the warp's run of columns
  const int last = min(first + run, cols);
  for (int t = first; t < last; ++t) {
    const int j = j0 + t;
    if (j < i0) continue;  // the same for the whole warp
    const int lb = col_length[t];
    float r = nanf("");
    if (lb >= 0 && !refused) {
      r = ratio_of(lcs_row(masks, la, col_plane0[t], col_plane1[t], lb),
                   la + lb);
    }
    out[static_cast<int64_t>(j) * n + i] = r;
    if (j >= i0 + 32) out[static_cast<int64_t>(i) * n + j] = r;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. `run` is the number of columns a warp
// walks, in [1, 64].
extern "C" int mcaat_ratio_matrix(const void* codes, const void* lengths,
                                  void* out, int n, int run, void* stream) {
  if (run < 1 || run > kMaxRun) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int block_cols = kWarpsPerBlock * run;
    const dim3 grid((n + block_cols - 1) / block_cols, (n + 31) / 32);
    ratio_matrix_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(lengths), static_cast<float*>(out), n,
        run);
  }
  return static_cast<int>(cudaGetLastError());
}
