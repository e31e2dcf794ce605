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

#define ND_EXPORT extern "C" __attribute__((visibility("default")))

// Each library is one translation unit, so each carries its own copy.
ND_EXPORT const char* nd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
