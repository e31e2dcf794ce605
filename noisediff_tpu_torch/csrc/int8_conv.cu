// The w8a8 int8 convolution of the inference route (NOISEDIFF_INT8=1):
//
//   nd_absmax     max |x| of a bf16 or fp32 tensor into one fp32 value on
//                 the device (the activation scale's input)
//   nd_int8_conv  a stride-1 conv of NHWC x with an int8 kernel: x is
//                 quantized as it is loaded (xq = clip(rint(x * (1 / sx)),
//                 -127, 127), sx = max(amax / 127, 1e-12)), the products
//                 sum in int32 on the tensor cores, and the epilogue writes
//                 float(acc) * (sx * sw[co]) in x's dtype, optionally plus
//                 the previous part's output (`into`) and then the bias
//
// Replaces no Pallas kernel: the JAX package's int8 route is XLA's int8
// convolution inside models/blocks.py `_quantized_conv` (:196-216), with
// XLA's reductions and elementwise passes around it. Its arithmetic is
// mirrored bit for bit: IEEE division and multiplication (__fdiv_rn,
// __fmul_rn, __fadd_rn, so nvcc contracts nothing into an FMA), rounding
// half to even (__float2int_rn, not roundf), the int32 sum converted to
// fp32 with round to nearest.
//
// Bound on this card: bytes at the model's widths. At NoiseDiffNet dim 48
// (B 4, 512^2) a 3x3 48 -> 48 conv does 2 * 9 * 48 * 48 operations a pixel
// over 96 bytes read and 96 written in bf16: 217 operations a byte, below
// the int8 tensor cores' 590 (1,979 TOPS over 3.35 TB/s). The deep 384-wide
// stages are bound by operations.
//
// Design (a simple kernel first; wgmma, TMA, and quantizing in the
// producer's epilogue, which would halve the bytes read, are later work):
//   * nd_absmax: a grid-stride pass of 16-byte loads, a block maximum into
//     a per-block slot, and the block that arrives last (an atomicInc
//     ticket whose limit puts the counter back to 0) reduces the slots in
//     a fixed order into out[0]. One launch; non-negative floats order as
//     their bits, but no float atomics are needed.
//   * nd_int8_conv: an implicit GEMM, M = B * Ho * Wo pixels by N = Co by
//     K = kh * kw * Cip (Ci zero-padded to a multiple of 32 in the cached
//     kernel, so a ragged channel chunk multiplies zeros). A block of 8
//     warps owns an 8 x 16 tile of output pixels of one sample by 64
//     output channels; warp w owns output row w of the tile as the 16 rows
//     of eight m16n8k32 tiles (mma.sync s8 x s8 -> s32). For each chunk of
//     32 input channels the block loads the tile's input pixels with their
//     halo once ((8 + kh - 1) x (16 + kw - 1), zero outside the frame and
//     beyond Ci), quantizes them into shared memory, copies every tap's
//     64 x 32 int8 weights beside them (cp.async), and then runs all
//     kh * kw taps from shared memory: a tap is an offset into the halo
//     tile, so each activation is read from device memory and quantized
//     once a chunk, not once a tap, and a barrier pair covers 9 x 8
//     products a warp. Every global load of a chunk is issued before the
//     first is used, and the next chunk's activations are in flight
//     during this chunk's products. The output tile is staged in shared
//     memory and written 8 channels a thread, coalesced, with the previous
//     part's output read the same way. Launch bounds ask for 3 blocks an
//     SM (at most 85 registers a thread): the chunks' load phases of one
//     block overlap the others' products.
//   Measured on the H100 (PERF.md): ~4x the bytes bound at the
//   512^2 3x3 convs, bound by the L2 traffic of reloading every tap's
//   weights a tile and by the load phases' latency; a persistent block
//   that keeps the weights resident, wgmma and quantizing in the
//   producer's epilogue are the next steps.
//     Shared rows are 48 bytes, so a warp's fragment loads hit 32 distinct
//     banks. Co is masked in the epilogue; n-tiles wholly beyond Co are
//     skipped.
#include "common.cuh"

namespace {

constexpr int TH = 8;            // output rows per block: one a warp
constexpr int TW = 16;           // output columns per block: a warp's 16 mma rows
constexpr int BN = 64;           // output channels per block
constexpr int KC = 32;           // input channels a chunk: one m16n8k32 depth
constexpr int THREADS = 32 * TH;
constexpr int LDS = 48;          // bytes per shared pixel or weight row: KC + 16 pad
constexpr int NT = BN / 8;       // n-tiles per warp
constexpr int HALO_H = TH + 2;   // the tile's input rows and columns for a 3x3
constexpr int HALO_W = TW + 2;
constexpr int OUT_LD = BN + 8;   // staged output row, elements: 16 bytes of pad

// 8 consecutive input values as loaded, before quantizing.
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 v;
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void load_vec(const bf16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void load_some(const bf16* p, int n) {
    bf16* e = reinterpret_cast<bf16*>(&v);
    for (int i = 0; i < 8; ++i) e[i] = i < n ? p[i] : __float2bfloat16_rn(0.0f);
  }
  __device__ __forceinline__ void get(float* f) const { unpack8(v, f); }
};
template <>
struct Raw8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void zero() {
    lo = make_float4(0.f, 0.f, 0.f, 0.f);
    hi = lo;
  }
  __device__ __forceinline__ void load_vec(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void load_some(const float* p, int n) {
    float e[8];
    for (int i = 0; i < 8; ++i) e[i] = i < n ? p[i] : 0.0f;
    lo = make_float4(e[0], e[1], e[2], e[3]);
    hi = make_float4(e[4], e[5], e[6], e[7]);
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
// round a float to T (nearest, ties to even) and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) { return round_bf16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// 8 consecutive values of an output-layout tensor (plain loads: `into` may
// be the output itself), and their 16- or 32-byte store
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}

// clip(rint(v * inv), -127, 127) of 8 values, packed little-endian
__device__ __forceinline__ uint2 quantize8(const float* f, float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int q = __float2int_rn(__fmul_rn(f[i], inv));
    q = max(-127, min(127, q));
    w[i >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float scale_of(const float* amax) {
  return fmaxf(__fdiv_rn(__ldg(amax), 127.0f), 1e-12f);
}

struct ConvArgs {
  const void* x;      // (B, H, W, Ci) bf16 or fp32
  const int8_t* kq;   // (Co, K, K, Cip)
  const float* sw;    // (Co,)
  const float* amax;  // (1,)
  const float* bias;  // (Co,) fp32 or null
  const void* into;   // (B, Ho, Wo, Co) or null
  void* out;          // (B, Ho, Wo, Co)
  int H, W, Ci, Cip, Co, ph, pw, Ho, Wo, tiles_w, tiles_h;
  bool vec;           // 16-byte activation loads: x aligned and Ci % 8 == 0
};

// One block: output rows oy0 .. oy0 + 7 (warp w takes row oy0 + w) by
// columns ox0 .. ox0 + 15 of sample n, channels n0 .. n0 + 63.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 3) int8_conv_kernel(const ConvArgs p) {
  // the halo tile and the weights; after the products, the staged output
  constexpr int A_BYTES = HALO_H * HALO_W * LDS, B_BYTES = K * K * BN * LDS;
  constexpr int O_BYTES = TH * TW * OUT_LD * static_cast<int>(sizeof(T));
  __shared__ __align__(16) uint8_t smem[A_BYTES + B_BYTES > O_BYTES ? A_BYTES + B_BYTES
                                                                     : O_BYTES];
  uint8_t* const As = smem;
  uint8_t* const Bs = smem + A_BYTES;
  constexpr int hh = TH + K - 1, hw = TW + K - 1;  // the tile's input pixels
  const T* x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tx = blockIdx.x % p.tiles_w;
  const int ty = (blockIdx.x / p.tiles_w) % p.tiles_h;
  const int n = blockIdx.x / (p.tiles_w * p.tiles_h);
  const int oy0 = ty * TH, ox0 = tx * TW;
  const int iy0 = oy0 - p.ph, ix0 = ox0 - p.pw;
  const int n0 = blockIdx.y * BN;

  const float sx = scale_of(p.amax);
  const float inv = __fdiv_rn(1.0f, sx);

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  // the chunk's input pixels with their halo, 8 channels a thread a step:
  // every load of a chunk is issued before any is used
  constexpr int A_ITEMS = hh * hw * 4;
  constexpr int A_ITERS = (A_ITEMS + THREADS - 1) / THREADS;
  Raw8<T> ra[A_ITERS];
  auto load_a = [&](int c0) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int e = tid + i * THREADS;
      const int px = e >> 2, seg = e & 3;
      const int hy = px / hw, hx = px - hy * hw;
      const int iy = iy0 + hy, ix = ix0 + hx, c = c0 + 8 * seg;
      if (e < A_ITEMS && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c < p.Ci) {
        const T* src = x + ((static_cast<long long>(n) * p.H + iy) * p.W + ix) * p.Ci + c;
        if (p.vec) {
          ra[i].load_vec(src);
        } else {
          ra[i].load_some(src, min(8, p.Ci - c));
        }
      } else {
        ra[i].zero();
      }
    }
  };
  // quantized into shared memory (zero outside the frame and beyond Ci)
  auto store_a = [&]() {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int e = tid + i * THREADS;
      if (e < A_ITEMS) {
        const int px = e >> 2, seg = e & 3;
        const int hy = px / hw, hx = px - hy * hw;
        float f[8];
        ra[i].get(f);
        *reinterpret_cast<uint2*>(As + (hy * HALO_W + hx) * LDS + 8 * seg) = quantize8(f, inv);
      }
    }
  };
  // every tap's int8 weights for the block's 64 output channels, by
  // cp.async (zeros past Co)
  auto load_b = [&](int c0) {
    for (int e = tid; e < K * K * BN * 2; e += THREADS) {
      const int row = e >> 1, half = e & 1;  // row = tap * BN + output channel
      const int tap = row / BN, co = n0 + (row - tap * BN);
      const int8_t* src =
          p.kq + (static_cast<long long>(co < p.Co ? co : 0) * K * K + tap) * p.Cip + c0 +
          16 * half;
      cp16(Bs + row * LDS + 16 * half, src, co < p.Co ? 16 : 0);
    }
  };

  load_a(0);
  load_b(0);
  for (int c0 = 0; c0 < p.Cip; c0 += KC) {
    store_a();
    cp_wait_all();
    __syncthreads();
    if (c0 + KC < p.Cip) load_a(c0 + KC);  // in flight during the products
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      // mma row m is output column ox0 + m: input pixel (warp + dy, m + dx)
      const uint8_t* a = As + ((warp + dy) * HALO_W + dx) * LDS + 4 * t4;
      const uint32_t a0 = lds32(a + g * LDS), a1 = lds32(a + (g + 8) * LDS);
      const uint32_t a2 = lds32(a + g * LDS + 16), a3 = lds32(a + (g + 8) * LDS + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + 8 * j < p.Co) {
          const uint8_t* b = Bs + (tap * BN + 8 * j + g) * LDS + 4 * t4;
          mma_s8(acc[j], a0, a1, a2, a3, lds32(b), lds32(b + 16));
        }
      }
    }
    __syncthreads();
    if (c0 + KC < p.Cip) load_b(c0 + KC);
  }

  // epilogue: float(acc) * (sx * sw) rounded to T, staged in shared memory
  // as the tile's (pixel, channel) rows (c0, c1 of a fragment: pixel g,
  // channels 2 * t4, +1; c2, c3: pixel g + 8) ...
  T* const os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= p.Co) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = 8 * j + 2 * t4 + e, co = n0 + cl;
      const float scale = co < p.Co ? __fmul_rn(sx, __ldg(p.sw + co)) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        store(os + (warp * TW + g + 8 * h) * OUT_LD + cl,
              __fmul_rn(__int2float_rn(acc[j][2 * h + e]), scale));
      }
    }
  }
  __syncthreads();
  // ... then 8 channels of a pixel a thread: the previous part's output
  // added in T, then the bias, and one 16-byte (bf16) or 32-byte store
  T* out = static_cast<T*>(p.out);
  const T* into = static_cast<const T*>(p.into);
  const bool vec = p.Co % 8 == 0;
  for (int e = tid; e < TH * TW * (BN / 8); e += THREADS) {
    const int px = e / (BN / 8), cl = 8 * (e % (BN / 8)), co = n0 + cl;
    const int oy = oy0 + px / TW, ox = ox0 + px % TW;
    if (co >= p.Co || oy >= p.Ho || ox >= p.Wo) continue;
    const long long o = ((static_cast<long long>(n) * p.Ho + oy) * p.Wo + ox) * p.Co + co;
    const int cnt = min(8, p.Co - co);
    float f[8], prev[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = to_float(os[px * OUT_LD + cl + i]);
    if (into) {
      if (vec) {
        load8(into + o, prev);
      } else {
        for (int i = 0; i < cnt; ++i) prev[i] = to_float(into[o + i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = round_to(__fadd_rn(prev[i], f[i]), out);
    }
    if (p.bias) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float b = i < cnt ? round_to(__ldg(p.bias + co + i), out) : 0.0f;
        f[i] = round_to(__fadd_rn(f[i], b), out);
      }
    }
    if (vec) {
      store8(out + o, f);
    } else {
      for (int i = 0; i < cnt; ++i) store(out + o + i, f[i]);
    }
  }
}

constexpr int AM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(AM_THREADS) absmax_kernel(const T* x, long long n, bool vec,
                                                            float* part, unsigned* count,
                                                            float* out) {
  __shared__ float red[AM_THREADS / 32];
  __shared__ bool last;
  const long long stride = static_cast<long long>(gridDim.x) * AM_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * AM_THREADS + threadIdx.x;
  float m = 0.0f;
  long long done = 0;
  if (vec) {
    const long long nv = n / 8;
    for (long long i = first; i < nv; i += stride) {
      Raw8<T> r;
      r.load_vec(x + 8 * i);
      float f[8];
      r.get(f);
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(f[k]));
    }
    done = nv * 8;
  }
  for (long long i = done + first; i < n; i += stride) m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red[0];
    for (int w = 1; w < AM_THREADS / 32; ++w) b = fmaxf(b, red[w]);
    part[blockIdx.x] = b;
    __threadfence();
    last = atomicInc(count, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's maximum, in a fixed order
  float v = 0.0f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += AM_THREADS) {
    v = fmaxf(v, __ldcg(part + i));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red[0];
    for (int w = 1; w < AM_THREADS / 32; ++w) b = fmaxf(b, red[w]);
    out[0] = b;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16
ND_EXPORT int nd_absmax(const void* x, int dtype, long long n, float* part, unsigned* count,
                        float* out, int blocks, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (dtype == 1) {
    absmax_kernel<bf16><<<blocks, AM_THREADS, 0, stream>>>(static_cast<const bf16*>(x), n, vec,
                                                           part, count, out);
  } else {
    absmax_kernel<float><<<blocks, AM_THREADS, 0, stream>>>(static_cast<const float*>(x), n,
                                                            vec, part, count, out);
  }
  return static_cast<int>(cudaGetLastError());
}

ND_EXPORT int nd_int8_conv(const void* x, int dtype, const int8_t* kq, const float* sw,
                           const float* amax, const float* bias, const void* into, void* out,
                           int B, int H, int W, int Ci, int Cip, int Co, int K, int ph, int pw,
                           int aligned, cudaStream_t stream) {
  ConvArgs p;
  p.x = x;
  p.kq = kq;
  p.sw = sw;
  p.amax = amax;
  p.bias = bias;
  p.into = into;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Cip = Cip;
  p.Co = Co;
  p.ph = ph;
  p.pw = pw;
  p.Ho = H + 2 * ph - K + 1;
  p.Wo = W + 2 * pw - K + 1;
  p.tiles_w = (p.Wo + TW - 1) / TW;
  p.tiles_h = (p.Ho + TH - 1) / TH;
  p.vec = aligned && Ci % 8 == 0;
  const dim3 grid(static_cast<unsigned>(B) * p.tiles_w * p.tiles_h, (Co + BN - 1) / BN);
  if (K == 3) {
    if (dtype == 1) {
      int8_conv_kernel<bf16, 3><<<grid, THREADS, 0, stream>>>(p);
    } else {
      int8_conv_kernel<float, 3><<<grid, THREADS, 0, stream>>>(p);
    }
  } else if (dtype == 1) {
    int8_conv_kernel<bf16, 1><<<grid, THREADS, 0, stream>>>(p);
  } else {
    int8_conv_kernel<float, 1><<<grid, THREADS, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
