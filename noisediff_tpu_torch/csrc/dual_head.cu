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
// about 95 us at 3.35 TB/s; the products are 2.8 GMAC.
//
// What bound the previous design (0.86 ms against 0.10): one thread per
// pixel held the pixel's C-vector in registers and ran the C x C + 8 x C
// FMAs on the fp32 cores, reading broadcast weights from shared memory; at
// C = 48 and 64 it took 255 registers and spilled.
//
// Design: the products on the tensor cores, each warp carrying 16-pixel
// strips as attn_tail.cu's fused forward does (attn_tail_chain.cuh: PTX,
// fragment addressing, gelu_chunk, the staging helpers):
//   * persistent blocks round fc1's fp32 weight to bf16 into shared memory
//     once (and keep b1 in fp32 there); every lane builds its B fragments
//     of fc2 and the read head (N = 4, padded to an n8 tile with zeros)
//     from the fp32 parameters once, into registers;
//   * a warp's next strip (the three maps, and for DDIM the carry and the
//     noise) is in flight by cp.async while it computes this one;
//   * A = round_bf16(sa + sb) from two ldmatrix fragments; fc1 runs 16
//     hidden columns at a time (C / 16 k-steps, two n-tiles), + b1, round,
//     GELU (gelu_accurate: the hardware tanh flips bf16 roundings), round:
//     the accumulator pair is fc2's A fragment, so the hidden vector never
//     leaves registers; fc2 and the read head are one mma per k-step each;
//   * the 4 outputs of a pixel sit in two lanes; one shuffle gives each of
//     them a whole pixel, which the DDIM update (in registers) finishes and
//     one 16-byte store writes.
// No block barrier runs after the weights are staged. Rounding follows the
// TPU kernel: shot_a + shot_b and the fc1 output are bf16, GELU (tanh form)
// is evaluated on the bf16 value and rounded, the 4-wide products sum in
// fp32 as (fc2 + b2) + (read + br).
#include "attn_tail_chain.cuh"

namespace {

constexpr int CO = 4;           // output channels
constexpr int STRIP = 16;       // a warp's pixel strip: one m16 tile of rows
constexpr int HEAD_WARPS = 8;   // per block

template <int C>
struct HeadCfg {
  static constexpr int MIN_BLOCKS = C <= 48 ? 2 : 1;
  static constexpr int LDC = C + PAD;
  static constexpr int MAP = STRIP * LDC;  // elements of one map's strip
  // one strip buffer: sa | sb | x (bf16), then the carry | the noise (fp32)
  static constexpr int BUF_BYTES = 3 * MAP * 2 + 2 * STRIP * CO * 4;
  static constexpr int W1_BYTES = C * LDC * 2;
  static constexpr int SMEM = W1_BYTES + C * 4 + HEAD_WARPS * 2 * BUF_BYTES;
};

// The DDIM step's scalars (ddim_head.ddim_step_scalars): sqrt(a),
// sqrt(1 - a), sqrt(1 / a), 1 / sqrt(1 / a - 1), sqrt(a_next), c, sigma.
struct DdimStep {
  float ac, one_m_ac, rac, iracm1, anext, c, sig;
};

struct HeadArgs {
  const bf16* x;
  const bf16* sa;
  const bf16* sb;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* wr;
  const float* br;
  float* out;
  const float* xt;   // DDIM: (P, 4) carry
  const float* nz;   // DDIM: (P, 4) noise, or null (sigma 0)
  long long P;
  long long strips;
  DdimStep sc;
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

// A warp's strip rows [r0, r0 + 16) into buf, zeros past the last row.
template <int C, bool DDIM>
__device__ __forceinline__ void head_fetch(unsigned char* buf, const HeadArgs& a, long long r0) {
  using K = HeadCfg<C>;
  constexpr int V = C / 8;
  const int lane = threadIdx.x & 31;
  const int rows = (int)max(0LL, min((long long)STRIP, a.P - r0));
  bf16* dst = reinterpret_cast<bf16*>(buf);
  for (int t = lane; t < 3 * STRIP * V; t += 32) {
    const int m = t / (STRIP * V), rem = t - m * STRIP * V;
    const int r = rem / V, v = rem - r * V;
    const bf16* src = m == 0 ? a.sa : m == 1 ? a.sb : a.x;
    const bool ok = r < rows;
    cp16(dst + m * K::MAP + r * K::LDC + v * 8, ok ? src + (r0 + r) * C + v * 8 : src,
         ok ? 16 : 0);
  }
  if (DDIM) {
    float* vec = reinterpret_cast<float*>(buf + 3 * K::MAP * 2);
    const int r = lane & 15;
    const bool ok = r < rows;
    if (lane < 16) {
      cp16(vec + r * CO, ok ? a.xt + (r0 + r) * CO : a.xt, ok ? 16 : 0);
    } else if (a.nz != nullptr) {
      cp16(vec + STRIP * CO + r * CO, ok ? a.nz + (r0 + r) * CO : a.nz, ok ? 16 : 0);
    }
  }
}

// B fragments of a (4, C) fp32 weight (out, in), rounded to bf16, as one
// n8 tile whose rows 4..7 are zero: for k-step kc, lane (g, tig) holds
// W[g][16 kc + 2 tig + {0, 1}] and W[g][16 kc + 8 + 2 tig + {0, 1}].
template <int C>
__device__ __forceinline__ void narrow_fragments(const float* __restrict__ w,
                                                 uint32_t (&b)[C / 16][2]) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc) {
    const int k = 16 * kc + 2 * tig;
    if (g < CO) {
      b[kc][0] = pack_bf2(__ldg(w + g * C + k), __ldg(w + g * C + k + 1));
      b[kc][1] = pack_bf2(__ldg(w + g * C + k + 8), __ldg(w + g * C + k + 9));
    } else {
      b[kc][0] = b[kc][1] = 0u;
    }
  }
}

// DDIM = false: out = the head (fp32). DDIM = true: out = the next carry
// from the head, the carry xt and the noise nz (may be null: sigma is 0).
// Persistent blocks each take a contiguous run of strips; warp w of a block
// takes strips w, w + HEAD_WARPS, ... of the run.
template <int C, bool DDIM>
__global__ void __launch_bounds__(32 * HEAD_WARPS, HeadCfg<C>::MIN_BLOCKS)
    dual_head_kernel(const HeadArgs a) {
  using K = HeadCfg<C>;
  constexpr int KC = C / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W1 = reinterpret_cast<bf16*>(smem);
  float* sB1 = reinterpret_cast<float*>(smem + K::W1_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  unsigned char* bufs = smem + K::W1_BYTES + C * 4 + (size_t)warp * 2 * K::BUF_BYTES;

  const long long s_begin = (long long)blockIdx.x * a.strips / gridDim.x;
  const long long s_end = (long long)(blockIdx.x + 1) * a.strips / gridDim.x;
  long long s = s_begin + warp;
  if (s < s_end) head_fetch<C, DDIM>(bufs, a, s * STRIP);
  cp_commit();
  stage_rounded(W1, K::LDC, a.w1, C, C);
  for (int i = threadIdx.x; i < C; i += blockDim.x) sB1[i] = a.b1[i];
  uint32_t w2f[KC][2], wrf[KC][2];
  narrow_fragments<C>(a.w2, w2f);
  narrow_fragments<C>(a.wr, wrf);
  // this lane's output channels 2 tig, 2 tig + 1 (lanes with tig >= 2 hold
  // the padding columns)
  const int c0 = min(2 * tig, CO - 2);
  const float b2a = a.b2[c0], b2b = a.b2[c0 + 1], bra = a.br[c0], brb = a.br[c0 + 1];
  __syncthreads();

  for (int it = 0; s < s_end; s += HEAD_WARPS, ++it) {
    unsigned char* cur = bufs + (it & 1) * K::BUF_BYTES;
    __syncwarp();  // every lane is done with the other buffer's strip
    if (s + HEAD_WARPS < s_end) {
      head_fetch<C, DDIM>(bufs + ((it + 1) & 1) * K::BUF_BYTES, a, (s + HEAD_WARPS) * STRIP);
    }
    cp_commit();
    cp_wait<1>();  // this strip
    __syncwarp();
    const bf16* sa = reinterpret_cast<const bf16*>(cur);
    const bf16* sb = sa + K::MAP;
    const bf16* xs = sb + K::MAP;

    // read head: x wr^T; shot head's A = round_bf16(sa + sb)
    float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t A[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t xf[4], fa[4], fb[4];
      ldsm4(xf, a_addr(xs, K::LDC, 0, 16 * kc));
      mma(racc, xf, wrf[kc][0], wrf[kc][1]);
      ldsm4(fa, a_addr(sa, K::LDC, 0, 16 * kc));
      ldsm4(fb, a_addr(sb, K::LDC, 0, 16 * kc));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = unpack_bf2(fa[i]), v = unpack_bf2(fb[i]);
        A[kc][i] = pack_bf2(u.x + v.x, u.y + v.y);
      }
    }

    // fc1 -> + b1 -> GELU -> fc2, 16 hidden columns at a time
    float sacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float u[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(W1, K::LDC, 16 * j, 16 * kc));
        mma(u[0], A[kc], b[0], b[1]);
        mma(u[1], A[kc], b[2], b[3]);
      }
      uint32_t hA[4];
      gelu_chunk(u, j, sB1, hA);
      mma(sacc, hA, w2f[j][0], w2f[j][1]);
    }

    // lane (g, tig < 2) holds channels 2 tig, 2 tig + 1 of rows g and g + 8;
    // one exchange gives lane tig 0 row g and lane tig 1 row g + 8 whole
    const float v0 = (sacc[0] + b2a) + (racc[0] + bra), v1 = (sacc[1] + b2b) + (racc[1] + brb);
    const float v2 = (sacc[2] + b2a) + (racc[2] + bra), v3 = (sacc[3] + b2b) + (racc[3] + brb);
    const float o0 = __shfl_xor_sync(0xffffffffu, tig == 0 ? v2 : v0, 1);
    const float o1 = __shfl_xor_sync(0xffffffffu, tig == 0 ? v3 : v1, 1);
    const int r = tig == 0 ? g : g + 8;
    const long long p = s * STRIP + r;
    if (tig < 2 && p < a.P) {
      float4 res = tig == 0 ? make_float4(v0, v1, o0, o1) : make_float4(o0, o1, v2, v3);
      if (DDIM) {
        const float* vec = reinterpret_cast<const float*>(cur + 3 * K::MAP * 2);
        const float4 xv = *reinterpret_cast<const float4*>(vec + r * CO);
        float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (a.nz != nullptr) z = *reinterpret_cast<const float4*>(vec + STRIP * CO + r * CO);
        res.x = ddim_update(xv.x, res.x, z.x, a.sc);
        res.y = ddim_update(xv.y, res.y, z.y, a.sc);
        res.z = ddim_update(xv.z, res.z, z.z, a.sc);
        res.w = ddim_update(xv.w, res.w, z.w, a.sc);
      }
      *reinterpret_cast<float4*>(a.out + p * CO) = res;
    }
  }
}

// the kernel attribute and the launch shape are set up once per card (the
// current one: the caller makes the tensors' card current)
constexpr int MAX_CARDS = 64;

template <int C, bool DDIM>
int launch(HeadArgs a, cudaStream_t st) {
  using K = HeadCfg<C>;
  static int blocks_per_sm_of[MAX_CARDS] = {};
  static int sms_of[MAX_CARDS] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
  int& blocks_per_sm = blocks_per_sm_of[dev];
  int& sms = sms_of[dev];
  if (blocks_per_sm == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dual_head_kernel<C, DDIM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, dual_head_kernel<C, DDIM>, 32 * HEAD_WARPS, K::SMEM);
    }
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  a.strips = (a.P + STRIP - 1) / STRIP;
  const long long want = (a.strips + HEAD_WARPS - 1) / HEAD_WARPS;
  const int grid = (int)max(1LL, min((long long)blocks_per_sm * sms, want));
  dual_head_kernel<C, DDIM><<<grid, 32 * HEAD_WARPS, K::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool DDIM>
int dispatch(const HeadArgs& a, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16, DDIM>(a, st);
    case 32: return launch<32, DDIM>(a, st);
    case 48: return launch<48, DDIM>(a, st);
    case 64: return launch<64, DDIM>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

HeadArgs head_args(const void* x, const void* sa, const void* sb, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* wr, const void* br, void* out,
                   long long P) {
  HeadArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.sa = static_cast<const bf16*>(sa);
  a.sb = static_cast<const bf16*>(sb);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.wr = static_cast<const float*>(wr);
  a.br = static_cast<const float*>(br);
  a.out = static_cast<float*>(out);
  a.P = P;
  return a;
}

}  // namespace

// x, sa, sb: (P, C) bf16; w1: (C, C) fp32 (out, in); b1: (C,); w2, wr: (4, C)
// fp32 (out, in); b2, br: (4,); out: (P, 4) fp32. C in {16, 32, 48, 64}.
// The fp32 weights are rounded to bf16 inside the kernel.
ND_EXPORT int nd_dual_head(const void* x, const void* sa, const void* sb, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* wr,
                           const void* br, void* out, long long P, int C, void* stream) {
  return dispatch<false>(head_args(x, sa, sb, w1, b1, w2, b2, wr, br, out, P), C, stream);
}

// The DDIM tail: as nd_dual_head, plus xt: (P, 4) fp32 carry; nz: (P, 4)
// fp32 noise or null (sigma == 0); the seven step scalars; out: (P, 4) fp32
// next carry.
ND_EXPORT int nd_ddim_head(const void* x, const void* sa, const void* sb, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* wr,
                           const void* br, const void* xt, const void* nz, void* out,
                           long long P, int C, float ac, float one_m_ac, float rac, float iracm1,
                           float anext, float c, float sig, void* stream) {
  HeadArgs a = head_args(x, sa, sb, w1, b1, w2, b2, wr, br, out, P);
  a.xt = static_cast<const float*>(xt);
  a.nz = static_cast<const float*>(nz);
  a.sc = DdimStep{ac, one_m_ac, rac, iracm1, anext, c, sig};
  return dispatch<true>(a, C, stream);
}
