// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel library is compiled on its own (one nvcc per source, see
// ops/kernels/_build.py) into a shared library with a plain C interface:
// the C entry points take raw device pointers and the caller's CUDA stream,
// launch, and return cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Round a float to the nearest bf16 and back: the points where the JAX
// reference stores an intermediate in the model dtype.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// GELU, tanh form: the bf16 model dtype uses it (jax.nn.gelu approximate=True).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

// Unpack 8 bf16 values held in one 16-byte word.
__device__ __forceinline__ void unpack8(const uint4 raw, float* out) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Pack 8 floats (rounded to nearest) into one 16-byte word of bf16.
__device__ __forceinline__ uint4 pack8(const float* in) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h2[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  }
  return raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Per-channel partial sums over a slab of rows of a (B, N, C) bf16 map,
// fp32, 16-byte loads (8 channels per thread), C % 8 == 0. Grid (S, B);
// block: partial_sums_threads(C) threads, partial_sums_smem(C) bytes of
// dynamic shared memory. Block (s, b) sums rows [s * rows_per_split,
// (s + 1) * rows_per_split) of sample b and writes part[b][s] = [sum a,
// sum a * a] (GRAD = false; b unused) or [sum a, sum a * b] (GRAD = true),
// part (B, S, 2, C). The training path's GroupNorm statistics and the
// affine's gradient statistics (gn_stats.cu).
__host__ __device__ inline int partial_sums_rows_in_flight(int C) {
  const int r = 256 / (C / 8);
  return r < 1 ? 1 : r;
}

__host__ __device__ inline int partial_sums_threads(int C) {
  return partial_sums_rows_in_flight(C) * (C / 8);
}

__host__ __device__ inline size_t partial_sums_smem(int C) {
  return (size_t)partial_sums_rows_in_flight(C) * 2 * C * sizeof(float);
}

template <bool GRAD>
__global__ void channel_partial_sums(const bf16* __restrict__ a, const bf16* __restrict__ b,
                                     float* __restrict__ part, int N, int C, int S,
                                     int rows_per_split) {
  constexpr int VEC = 8;
  const int s = blockIdx.x;
  const int bi = blockIdx.y;
  const int lanes_per_row = C / VEC;
  const int rows_in_flight = partial_sums_rows_in_flight(C);
  const int t = threadIdx.x;
  const int r = t / lanes_per_row;
  const int v = t - r * lanes_per_row;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] = 0.0f;
    s2[i] = 0.0f;
  }
  const int row0 = s * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  const size_t off = (size_t)bi * N * C + (size_t)v * VEC;
  for (int row = row0 + r; row < row1; row += rows_in_flight) {
    float fa[VEC], fb[VEC];
    unpack8(*reinterpret_cast<const uint4*>(a + off + (size_t)row * C), fa);
    if (GRAD) {
      unpack8(*reinterpret_cast<const uint4*>(b + off + (size_t)row * C), fb);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += fa[i];
      s2[i] += fa[i] * (GRAD ? fb[i] : fa[i]);
    }
  }

  extern __shared__ float red[];  // [rows_in_flight][2][C]
  float* dst = red + (size_t)r * 2 * C + v * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    dst[i] = s1[i];
    dst[C + i] = s2[i];
  }
  __syncthreads();
  float* out = part + ((size_t)bi * S + s) * 2 * C;
  for (int c = t; c < 2 * C; c += blockDim.x) {
    float acc = 0.0f;
    for (int rr = 0; rr < rows_in_flight; ++rr) acc += red[(size_t)rr * 2 * C + c];
    out[c] = acc;
  }
}

#define ND_EXPORT extern "C" __attribute__((visibility("default")))

// Each library is one translation unit, so each carries its own copy.
ND_EXPORT const char* nd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
