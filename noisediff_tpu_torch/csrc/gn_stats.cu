// GroupNorm statistics of the training path, bf16 (B, N, C) in, fp32 (B, C)
// out:
//   gn_stats(x)          s = sum_n x,  q = sum_n x^2
//   gn_grad_stats(g, x)  s = sum_n g,  p = sum_n g * x
//
// Replaces the TPU kernels noisediff_tpu/ops/pallas/gn_stats.py (gn_stats
// and gn_grad_stats), which carry the sums in VMEM across a sequential grid
// over row blocks.
//
// Bound on this card: memory. gn_stats reads x once (100.7 MB at the
// canonical 512^2 x 48 x 4 stage, 30 us at 3.35 TB/s), gn_grad_stats reads
// g and x (twice that); the outputs are a few KB and the arithmetic two
// fp32 operations per element read.
//
// Design: a GPU has no sequential grid, so the rows of each sample are
// split over about 4 * SMs / B blocks.
//   1. channel_partial_sums (common.cuh):
//      grid (S, B); each block streams a contiguous slab of rows with
//      16-byte loads (8 channels per thread, rows in flight across the
//      block), sums in fp32 registers, reduces its rows in shared memory and
//      writes one (2, C) partial per block.
//   2. sum_partials: grid (B); sums the S partials of each (sample, channel)
//      in a fixed order, so the result is deterministic and no atomics run.
#include "common.cuh"

namespace {

__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ s1,
                             float* __restrict__ s2, int S, int C) {
  const int b = blockIdx.x;
  const float* p = part + (size_t)b * S * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < S; ++k) acc += p[(size_t)k * 2 * C + c];
    if (c < C) {
      s1[(size_t)b * C + c] = acc;
    } else {
      s2[(size_t)b * C + c - C] = acc;
    }
  }
}

template <bool GRAD>
int run(const void* a, const void* b, void* part, void* s1, void* s2, int B, int N, int C, int S,
        int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  channel_partial_sums<GRAD><<<dim3(S, B), partial_sums_threads(C), partial_sums_smem(C), st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(part), N, C,
      S, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<B, 256, 0, st>>>(static_cast<const float*>(part), static_cast<float*>(s1),
                                  static_cast<float*>(s2), S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, N, C) bf16, C % 8 == 0; part: (B, S, 2, C) fp32 scratch; s, q: (B, C) fp32.
ND_EXPORT int nd_gn_stats(const void* x, void* part, void* s, void* q, int B, int N, int C,
                          int S, int rows_per_split, void* stream) {
  return run<false>(x, nullptr, part, s, q, B, N, C, S, rows_per_split, stream);
}

// g, x: (B, N, C) bf16, C % 8 == 0; part: (B, S, 2, C) fp32 scratch; s, p: (B, C) fp32.
ND_EXPORT int nd_gn_grad_stats(const void* g, const void* x, void* part, void* s, void* p, int B,
                               int N, int C, int S, int rows_per_split, void* stream) {
  return run<true>(g, x, part, s, p, B, N, C, S, rows_per_split, stream);
}
