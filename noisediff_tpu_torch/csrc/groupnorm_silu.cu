// GroupNorm -> affine -> optional per-sample FiLM -> SiLU, for bf16 (B, N, C).
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/groupnorm_silu.py
// (_forward / fused_groupnorm_film_silu), which keeps one sample's (N, C)
// block resident in VMEM and runs one program per sample.
//
// Bound on this card: memory. The function reads x once for the statistics
// and must write y once; at the canonical 512^2 x 48 x 4 shape that is
// 2 x 100.7 MB, about 60 us at 3.35 TB/s. The arithmetic is a handful of
// fp32 operations per element.
//
// Design: one program per sample would put 4 blocks on 132 SMs, so the
// statistics are split over many blocks instead.
//   1. channel_partial_sums (common.cuh): grid (S, B). Each block sums x and
//      x^2 in fp32 over a contiguous slab of rows, 16-byte loads (8 channels
//      per thread), and writes per-channel partials (B, S, 2, C).
//   2. gn_coeffs: grid (B), one thread per channel. Reduces the S partials,
//      pools them per group, and folds GroupNorm, its affine and the FiLM
//      into per-(sample, channel) coefficients y = x * a + bb, exactly the
//      JAX model path (blocks._gn_coeffs_primal and _film_fold): fp32 sums,
//      biased uncentered variance, eps inside the rsqrt.
//   3. gn_apply_silu: a grid-stride elementwise pass, 8 channels per thread,
//      y = silu(x * a + bb) in fp32, rounded once to bf16.
// The second read of x in pass 3 is the price of not keeping a sample
// resident on chip; the partials and coefficients are a few KB.
#include "common.cuh"

namespace {

constexpr int VEC = 8;  // bf16 values per 16-byte access

__global__ void gn_coeffs(const float* __restrict__ part, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* __restrict__ film_s,
                          const float* __restrict__ film_sh, float* __restrict__ coef,
                          int S, int C, int G, float cnt, float eps) {
  const int b = blockIdx.x;
  const int c = threadIdx.x;
  extern __shared__ float sums[];  // [2][C]
  float s = 0.0f, q = 0.0f;
  const float* p = part + (size_t)b * S * 2 * C;
  for (int k = 0; k < S; ++k) {
    s += p[(size_t)k * 2 * C + c];
    q += p[(size_t)k * 2 * C + C + c];
  }
  sums[c] = s;
  sums[C + c] = q;
  __syncthreads();

  const int cg = C / G;
  const int g0 = (c / cg) * cg;
  float gs = 0.0f, gq = 0.0f;
  for (int j = 0; j < cg; ++j) {
    gs += sums[g0 + j];
    gq += sums[C + g0 + j];
  }
  const float mean = gs / cnt;
  const float var = gq / cnt - mean * mean;
  const float inv = rsqrtf(var + eps);
  float a = inv * gamma[c];
  float bb = beta[c] - mean * a;
  if (film_s != nullptr) {
    const float s1 = film_s[(size_t)b * C + c] + 1.0f;
    a *= s1;
    bb = bb * s1 + film_sh[(size_t)b * C + c];
  }
  coef[(size_t)b * 2 * C + c] = a;
  coef[(size_t)b * 2 * C + C + c] = bb;
}

__global__ void gn_apply_silu(const bf16* __restrict__ x, const float* __restrict__ coef,
                              bf16* __restrict__ y, long long n_vec, long long NC, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    const long long e = i * VEC;
    const long long b = e / NC;
    const int c0 = (int)(e % C);
    const float* a = coef + b * 2 * C + c0;
    const float* bb = a + C;
    float f[VEC];
    unpack8(*reinterpret_cast<const uint4*>(x + e), f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = f[k] * a[k] + bb[k];
      f[k] = v / (1.0f + expf(-v));
    }
    *reinterpret_cast<uint4*>(y + e) = pack8(f);
  }
}

}  // namespace

// x, y: (B, N, C) bf16; gamma, beta: (C,) fp32; film_s, film_sh: (B, C) fp32
// or null; part: (B, S, 2, C) fp32 scratch; coef: (B, 2, C) fp32 scratch.
ND_EXPORT int nd_groupnorm_silu(const void* x, const void* gamma, const void* beta,
                                const void* film_s, const void* film_sh, void* part,
                                void* coef, void* y, int B, int N, int C, int G, int S,
                                int rows_per_split, int apply_blocks, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  channel_partial_sums<false><<<dim3(S, B), partial_sums_threads(C), partial_sums_smem(C), st>>>(
      static_cast<const bf16*>(x), nullptr, static_cast<float*>(part), N, C, S, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float cnt = (float)N * (float)(C / G);
  gn_coeffs<<<B, C, 2 * C * sizeof(float), st>>>(
      static_cast<const float*>(part), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(film_s),
      static_cast<const float*>(film_sh), static_cast<float*>(coef), S, C, G, cnt, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long NC = (long long)N * C;
  const long long n_vec = (long long)B * NC / VEC;
  gn_apply_silu<<<apply_blocks, 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(coef), static_cast<bf16*>(y),
      n_vec, NC, C);
  return (int)cudaGetLastError();
}
