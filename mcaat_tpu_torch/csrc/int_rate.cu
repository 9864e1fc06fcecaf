// A measuring probe, not a port of any kernel: the rate at which an H100
// executes independent 32-bit integer multiply-adds. The LCS kernels of this
// directory are bound by integer work, and the smoke run states their
// bounds against an assumed integer peak; this kernel measures what the
// card actually sustains, so that the assumption can be read beside a
// measurement.
//
// Every thread keeps kChains independent accumulators in registers and
// updates each by x = x * mul + add (one IMAD) `iters` times. Nothing is
// read from memory; one word a thread is written at the end so that the
// work cannot be removed. `mul` and `add` arrive at run time, so nothing
// is folded at compile time. With kChains chains a thread and many warps
// an SM, the dependent latency of one chain is hidden and the instruction
// rate is what is timed.
//
// Instructions executed: blocks * threads * kChains * iters.

#include <cstdint>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int_rate_kernel(uint32_t* __restrict__ out, uint32_t mul, uint32_t add, int iters) {
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  uint32_t x[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) x[j] = tid + 0x9E3779B9u * (j + 1);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) x[j] = x[j] * mul + add;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc ^= x[j];
  out[tid] = acc;
}

}  // namespace

// `out` holds blocks * 256 words. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int mcaat_int_rate(void* out, int blocks, uint32_t mul, uint32_t add,
                              int iters, void* stream) {
  if (blocks > 0) {
    int_rate_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(out), mul, add, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
