// NoiseDiffNet's dual output head, fused:
//     out = fc2(gelu(fc1(shot_a + shot_b))) + conv1x1(x)      (fp32 out)
// where fc1 is C -> C, fc2 and the read head are C -> 4 (1x1 convs).
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/dual_head.py
// (_forward / fused_dual_head).
//
// A second entry point, nd_ddim_head, is the DDIM sampler's fused tail and
// replaces noisediff_tpu/ops/pallas/ddim_head.py (_kernel /
// fused_ddim_head_update): the same head per pixel, then, in registers,
//     x0  = clip(sqrt(a) x_t - sqrt(1 - a) v, -1, 1)
//     eps = (sqrt(1 / a) x_t - x0) / sqrt(1 / a - 1)
//     x'  = x0 sqrt(a_next) + c eps + sigma z
// with the seven step scalars passed by value (no device tensor per step)
// and the fp32 carry x' written in place of the head's output. Its bound
// adds the carry's read and write: 335 MB at the canonical shape, 0.100 ms;
// the noise read (16.8 MB more) is skipped when sigma is 0 (a null pointer:
// 0 z = 0 exactly), as with the reference default eta = 0.
//
// Bound on this card: memory. Three bf16 maps of C channels are read and a
// 4-channel fp32 map is written: at 512^2 x 48 x 4 that is 302 MB + 17 MB,
// about 95 us at 3.35 TB/s. The products have N = 4 (and C = 48 for fc1),
// too narrow to feed tensor cores usefully; their 2.8 GMAC would take a
// similar time on the fp32 cores, so the design keeps them cheap there:
//   * one thread per pixel; the pixel's C-vector lives in registers (C is
//     a template parameter so the vector is a register array);
//   * the weights (fp32, under 20 KB) sit in shared memory, stored
//     (out, in) so every thread of a warp reads the same float4 — a
//     broadcast, four FMAs per shared load;
//   * the hidden activation is consumed as soon as it is made: each of the
//     C hidden units is rounded, passed through GELU and folded into the
//     four output sums, so no hidden vector is ever stored.
// Rounding follows the TPU kernel: shot_a + shot_b and the fc1 output are
// bf16, GELU (tanh form) is evaluated on the bf16 value and rounded, the
// two 4-wide products accumulate in fp32.
#include "common.cuh"

namespace {

constexpr int CO = 4;  // output channels

// The DDIM step's scalars (ddim_head.ddim_step_scalars): sqrt(a),
// sqrt(1 - a), sqrt(1 / a), 1 / sqrt(1 / a - 1), sqrt(a_next), c, sigma.
struct DdimStep {
  float ac, one_m_ac, rac, iracm1, anext, c, sig;
};

// One output channel of the DDIM update, in the order of operations of
// reference_ddim_head_update.
__device__ __forceinline__ float ddim_update(float xt, float v, float z, const DdimStep& sc) {
  const float x0 = fminf(fmaxf(sc.ac * xt - sc.one_m_ac * v, -1.0f), 1.0f);
  const float eps = (sc.rac * xt - x0) * sc.iracm1;
  float xn = x0 * sc.anext + sc.c * eps;
  if (sc.sig != 0.0f) xn += sc.sig * z;
  return xn;
}

// DDIM = false: out = the head (fp32). DDIM = true: out = the next carry
// from the head, the carry xt and the noise nz (may be null: sigma is 0).
template <int C, bool DDIM>
__global__ void __launch_bounds__(128)
dual_head_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sa,
                 const bf16* __restrict__ sb, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ wr,
                 const float* __restrict__ br, float* __restrict__ out, long long P,
                 const float* __restrict__ xt, const float* __restrict__ nz, DdimStep sc) {
  __shared__ __align__(16) float s_w1[C * C];   // (out, in)
  __shared__ __align__(16) float s_w2[CO * C];  // (out, in)
  __shared__ __align__(16) float s_wr[CO * C];  // (out, in)
  __shared__ float s_b1[C];
  __shared__ float s_b2[CO];
  __shared__ float s_br[CO];
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < CO * C; i += blockDim.x) {
    s_w2[i] = w2[i];
    s_wr[i] = wr[i];
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_b1[i] = b1[i];
  if (threadIdx.x < CO) {
    s_b2[threadIdx.x] = b2[threadIdx.x];
    s_br[threadIdx.x] = br[threadIdx.x];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride) {
    float v[C];
    // read head: conv1x1(x)
    const uint4* xr = reinterpret_cast<const uint4*>(x + p * C);
#pragma unroll
    for (int k = 0; k < C / 8; ++k) unpack8(xr[k], v + 8 * k);
    float rn[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < C; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(s_wr + o * C + k);
        acc += v[k] * w.x + v[k + 1] * w.y + v[k + 2] * w.z + v[k + 3] * w.w;
      }
      rn[o] = acc;
    }

    // shot head: fc2(gelu(fc1(shot_a + shot_b)))
    const uint4* ar = reinterpret_cast<const uint4*>(sa + p * C);
    const uint4* brow = reinterpret_cast<const uint4*>(sb + p * C);
#pragma unroll
    for (int k = 0; k < C / 8; ++k) {
      float fa[8], fb[8];
      unpack8(ar[k], fa);
      unpack8(brow[k], fb);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[8 * k + i] = round_bf16(fa[i] + fb[i]);
    }
    float sn[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) sn[o] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < C; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < C; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(s_w1 + j * C + k);
        acc += v[k] * w.x + v[k + 1] * w.y + v[k + 2] * w.z + v[k + 3] * w.w;
      }
      const float h = round_bf16(gelu_tanh(round_bf16(acc + s_b1[j])));
#pragma unroll
      for (int o = 0; o < CO; ++o) sn[o] += h * s_w2[o * C + j];
    }
    float4 res;
    res.x = (sn[0] + s_b2[0]) + rn[0] + s_br[0];
    res.y = (sn[1] + s_b2[1]) + rn[1] + s_br[1];
    res.z = (sn[2] + s_b2[2]) + rn[2] + s_br[2];
    res.w = (sn[3] + s_b2[3]) + rn[3] + s_br[3];
    if (DDIM) {
      const float4 xv = *reinterpret_cast<const float4*>(xt + p * CO);
      float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nz != nullptr) z = *reinterpret_cast<const float4*>(nz + p * CO);
      res.x = ddim_update(xv.x, res.x, z.x, sc);
      res.y = ddim_update(xv.y, res.y, z.y, sc);
      res.z = ddim_update(xv.z, res.z, z.z, sc);
      res.w = ddim_update(xv.w, res.w, z.w, sc);
    }
    *reinterpret_cast<float4*>(out + p * CO) = res;
  }
}

template <int C, bool DDIM>
int launch(const void* x, const void* sa, const void* sb, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* wr, const void* br, void* out,
           long long P, int blocks, cudaStream_t st, const void* xt, const void* nz,
           DdimStep sc) {
  dual_head_kernel<C, DDIM><<<blocks, 128, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sa), static_cast<const bf16*>(sb),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(wr), static_cast<const float*>(br),
      static_cast<float*>(out), P, static_cast<const float*>(xt),
      static_cast<const float*>(nz), sc);
  return (int)cudaGetLastError();
}

template <bool DDIM>
int dispatch(const void* x, const void* sa, const void* sb, const void* w1, const void* b1,
             const void* w2, const void* b2, const void* wr, const void* br, void* out,
             long long P, int C, int blocks, void* stream, const void* xt, const void* nz,
             DdimStep sc) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16, DDIM>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, blocks, st, xt, nz, sc);
    case 32: return launch<32, DDIM>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, blocks, st, xt, nz, sc);
    case 48: return launch<48, DDIM>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, blocks, st, xt, nz, sc);
    case 64: return launch<64, DDIM>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, blocks, st, xt, nz, sc);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, sa, sb: (P, C) bf16; w1: (C, C) fp32 (out, in); b1: (C,); w2, wr: (4, C)
// fp32 (out, in); b2, br: (4,); out: (P, 4) fp32. C in {16, 32, 48, 64}.
ND_EXPORT int nd_dual_head(const void* x, const void* sa, const void* sb, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* wr,
                           const void* br, void* out, long long P, int C, int blocks,
                           void* stream) {
  return dispatch<false>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, C, blocks, stream, nullptr,
                         nullptr, DdimStep{});
}

// The DDIM tail: as nd_dual_head, plus xt: (P, 4) fp32 carry; nz: (P, 4)
// fp32 noise or null (sigma == 0); the seven step scalars; out: (P, 4) fp32
// next carry.
ND_EXPORT int nd_ddim_head(const void* x, const void* sa, const void* sb, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* wr,
                           const void* br, const void* xt, const void* nz, void* out,
                           long long P, int C, int blocks, float ac, float one_m_ac, float rac,
                           float iracm1, float anext, float c, float sig, void* stream) {
  return dispatch<true>(x, sa, sb, w1, b1, w2, b2, wr, br, out, P, C, blocks, stream, xt, nz,
                        DdimStep{ac, one_m_ac, rac, iracm1, anext, c, sig});
}
