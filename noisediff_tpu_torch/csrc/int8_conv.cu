// The w8a8 int8 convolution of the inference route (NOISEDIFF_INT8=1):
//
//   nd_absmax          max |x| of a bf16 or fp32 tensor into one fp32 value
//                      on the device (the activation scale's input)
//   nd_int8_conv       a stride-1 conv of NHWC x with an int8 kernel, the
//                      tiled route (below): x is quantized as it is loaded
//                      (xq = clip(rint(x * (1 / sx)), -127, 127), sx =
//                      max(amax / 127, 1e-12)), the products sum in int32 on
//                      the tensor cores, and the epilogue writes float(acc) *
//                      (sx * sw[co]) in x's dtype, optionally plus the
//                      previous part's output (`into`) and then the bias
//   nd_int8_conv_small the same function, the small route: the first
//                      design, for what the tiled route does not take (x or
//                      kq not 16-byte aligned, a row of Ci not a multiple of
//                      16 bytes, Co odd). ops/kernels/int8_conv.py `route`
//                      decides by shape and alignment before the launch.
//
// Replaces no Pallas kernel: the JAX package's int8 route is XLA's int8
// convolution inside models/blocks.py `_quantized_conv` (:196-216), with
// XLA's reductions and elementwise passes around it. Its arithmetic is
// mirrored bit for bit: IEEE division and multiplication (__fdiv_rn,
// __fmul_rn, __fadd_rn, so nvcc contracts nothing into an FMA), rounding
// half to even (rint: __float2int_rn in the small route, a sum with
// 1.5 * 2^23 in the tiled one; not roundf), the int32 sum converted to
// fp32 with round to nearest. The integer sums are exact in any order.
//
// Bound on this card: bytes at the narrow shapes, operations at the wide
// ones. A 3x3 48 -> 48 conv at NoiseDiffNet dim 48 (B 4, 512^2) does
// 2 * 9 * 48 * 48 operations a pixel over 96 bytes read and 96 written in
// bf16: 217 operations a byte, below the int8 tensor cores' 590 (1,979
// TOPS over 3.35 TB/s); a 3x3 384 -> 384 at 64^2 does 1,728 a byte, and
// LSID's 3x3 512-wide convs (fp32) 1,152: bound by operations.
//
// What held the first design (the small route) at 3.9x its bound: every
// 8 x 16-pixel block reloaded every tap's weights from L2 (at 512^2 more
// than the bound's whole DRAM traffic), a chunk loop of load, quantize,
// barrier and products with little to overlap, Ci 48 padded to 64 (25% of
// the K work on zeros), and mma.sync, which does not reach the int8 peak.
//
// Design of the tiled route (nd_int8_conv): an implicit GEMM, M = output
// pixels, N = Co, K = taps x Ci.
//   * Persistent blocks. One block per SM, two where the N tile (<= 96:
//     registers) and the shared memory allow, walks units (pixel tile, N
//     tile) in row-major order, so the blocks running at once read
//     neighbouring halos from L2. A pixel tile is 8 output rows x 16
//     columns, an 8 x 8 M-block a warpgroup; an N tile is the whole Co up
//     to 256, else Co split evenly (384 = 2 x 192), or the tile that pads
//     Co least where that does not fit (512 = 4 x 128 in fp32).
//   * Weights resident where they fit: with one N tile and every input
//     channel in one chunk (the narrow convs: every 3x3 up to Ci 96 and
//     1x1 up to Ci 192 at bf16), they come once a block by TMA and every
//     unit reuses them. Elsewhere they stream with the activations through
//     the ring, chunk by chunk (2-16 channel groups of 16), as one linear
//     bulk copy a chunk: the wrapper keeps a copy of kq laid out as the
//     stage takes it (ops/kernels/int8_conv.py `streamed_weights`; TMA moves
//     boxes of 16-byte rows, the pieces' natural shape, far more slowly).
//   * Activations by TMA. Warp 8 is the producer: one lane issues each
//     (unit, chunk)'s 4-D box - the tile's input pixels with their halo,
//     16 ckg channels - into a ring of 2-4 stages guarded by full / empty
//     mbarriers. Out-of-frame pixels and channels past Ci arrive as zeros:
//     the SAME padding, the ragged edge and a ragged channel group cost no
//     index arithmetic.
//   * Quantized once a chunk, by the two consumer warpgroups, into one of
//     the int8 buffers (planes of 16-byte channel groups stored pixel after
//     pixel) on full-rate float instructions (no float-to-int conversion),
//     fenced for the async proxy; with streamed weights the next chunk is
//     quantized while the last one's products run.
//   * wgmma s8 (m64nNk32, s32 accumulators, both operands from shared
//     memory through no-swizzle K-major descriptors). An M-block is 8
//     output rows x 8 columns: a core matrix is 8 pixels of one row (16
//     bytes apart) and the next is a halo row further, so a tap (dy, dx)
//     is only a descriptor start address dy * hc + dx pixels on: nothing is
//     copied per tap. The descriptors of a chunk's k-steps are a table the
//     entry point builds once a call (kstep_table), so the kernel adds only
//     uniform bases: descriptors built in per-thread registers cost four
//     R2UR moves a wgmma and ran the products at under half the rate.
//   * K padding. Groups pair within a tap; an odd group count (Ci 48: 3
//     groups) pairs its last group across two taps (the descriptor's
//     leading offset is the distance between their shifts) and the ninth
//     tap's with a zero piece: 14 k-steps at Ci 48 instead of the 18 of
//     a 64-channel pad (4% of the K work on zeros, not 25%).
//   * Epilogue: float(acc) * (sx * sw) rounded to x's dtype into each
//     warpgroup's staging rows, then whole output rows in 16-byte stores,
//     `into` read three vectors at a time, and the bias.
//   The host plan (N tile, chunking, stages, grid, shared bytes) is
//   ops/kernels/int8_conv.py `plan`; the entry point refuses a plan whose
//   shared bytes are not this file's layout.
//   Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's int8 phase,
//   PERF.md): one dim-48 evaluation's 77 convs 5.63 ms against the small
//   route's 11.01 in the same run (bound 2.83, cuDNN's bf16 convs 7.41);
//   LSID's 21 on a full frame 3.50 ms (small 5.65, bound 2.15); the 3x3
//   48 -> 48 at 512^2 1.83x its bound, the 1x1 1.40x, the 3x3 at
//   64^2 x 384 2.75x (operations). What binds now: at the narrow shapes the
//   quantize and the epilogue (quarter-rate int-to-float conversions) on
//   the CUDA cores; at the wide ones the products beside them.
//
// Design of the small route (the first design): a block of 8 warps owns an 8 x 16
// tile of output pixels of one sample by 64 output channels; warp w owns
// output row w of the tile as the 16 rows of eight m16n8k32 tiles
// (mma.sync s8 x s8 -> s32). For each chunk of 32 input channels the
// block loads the tile's input pixels with their halo once, quantizes them
// into shared memory, copies every tap's 64 x 32 int8 weights beside them
// (cp.async), and runs all taps from shared memory (a tap is an offset into
// the halo tile). The output tile is staged in shared memory and written 8
// channels a thread. Shared rows are 48 bytes (conflict-free fragment
// loads); Co is masked in the epilogue.
//
// nd_absmax: a grid-stride pass of 16-byte loads, a block maximum into a
// per-block slot, and the block that arrives last (an atomicInc ticket
// whose limit puts the counter back to 0) reduces the slots in a fixed
// order into out[0]. One launch; non-negative floats order as their bits,
// but no float atomics are needed.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry point

#include "common.cuh"

namespace {

constexpr int TH = 8;            // output rows per block: one a warp
constexpr int TW = 16;           // output columns per block: a warp's 16 mma rows
constexpr int BN = 64;           // output channels per block
constexpr int KC = 32;           // input channels a chunk: one m16n8k32 depth
constexpr int THREADS = 32 * TH;
constexpr int LDS = 48;          // bytes per shared pixel or weight row: KC + 16 pad
constexpr int N8 = BN / 8;       // n-tiles per warp
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

// The small route: one block owns output rows oy0 .. oy0 + 7 (warp w
// takes row oy0 + w) by columns ox0 .. ox0 + 15 of sample n, channels
// n0 .. n0 + 63.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 3) int8_conv_small_kernel(const ConvArgs p) {
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

  int acc[N8][4];
#pragma unroll
  for (int j = 0; j < N8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

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
      for (int j = 0; j < N8; ++j) {
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
  for (int j = 0; j < N8; ++j) {
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


// ---------------------------------------------------------------------------
// The tiled route: persistent blocks, activations by TMA, wgmma s8.

constexpr int T_THREADS = 288;    // two consumer warpgroups, then the producer warp
constexpr int T_CONSUMERS = 256;
constexpr int T_ROWS = 8;         // output rows of a tile: an M-block's 8 rows
constexpr int T_COLS = 16;        // output columns: the two warpgroups' M-blocks of 8

// Two blocks an SM for N tiles up to 96: the accumulators (NT / 2 a
// thread) and the rest fit the 96 registers a thread that two blocks of nine
// warps leave. Mirrored by ops/kernels/int8_conv.py (TWO_BLOCKS_MAX_NT).
__host__ __device__ constexpr bool two_blocks(int nt) { return nt <= 96; }
constexpr int T_MAX_KSTEPS = 72;  // k-steps a chunk: 9 taps x 8 group pairs at most

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// channels of the output a staging round of the epilogue writes
__host__ __device__ constexpr int stage_channels(int nt, int es) {
  return nt < 128 / es ? nt : 128 / es;
}

// The dynamic shared memory of one block (ops/kernels/int8_conv.py
// smem_layout computes the same numbers): `stages` stages, each the
// activation box of a chunk (hr x hc pixels x 16 ckg channels in x's
// dtype) and, when the weights stream, the chunk's weights; the quantized
// buffers (ckg planes of hr x hc pixels x 16 bytes, and 128 bytes that the
// lone k-step's partner may read), three where a unit has several chunks
// and two where it has one (see quantize_next); the resident weights with
// a zero piece after them; each warpgroup's output staging (its 64
// pixels x stage_channels + 8 elements); sx * sw and the bias rounded to
// x's dtype for every channel of the N tiles; the mbarriers.
struct Layout {
  int hr, hc;        // the tile's input rows and columns (with the halo)
  int raw_bytes;     // one activation box
  int raw;           // its region, 128-byte aligned
  int bchunk;        // one chunk's weights: K*K*ckg (tap, group) pieces of NT x 16 bytes
  int stage;
  int q, nq;         // one quantized buffer, and how many
  int bres;
  int ldo, o;        // a staging row (elements) and one warpgroup's staging
  int sc;            // sx * sw and the rounded bias of every output channel, fp32
  int q_off, b_off, o_off, sc_off, bar_off, smem;
};

__host__ __device__ inline Layout layout_of(int k, int nt, int ckg, int stages,
                                            bool resident, int es, int n_co) {
  Layout l;
  l.hr = T_ROWS + k - 1;
  l.hc = T_COLS + k - 1;
  l.raw_bytes = l.hr * l.hc * 16 * ckg * es;
  l.raw = align128(l.raw_bytes);
  l.bchunk = k * k * ckg * nt * 16;
  l.stage = l.raw + (resident ? 0 : align128(l.bchunk));
  l.q = align128(ckg * l.hr * l.hc * 16 + 128);
  l.nq = resident ? 2 : 3;
  l.bres = resident ? align128(l.bchunk + nt * 16) : 0;
  l.ldo = stage_channels(nt, es) + 8;
  l.o = align128(64 * l.ldo * es);
  l.sc = align128(2 * n_co * nt * 4);
  l.q_off = stages * l.stage;
  l.b_off = l.q_off + l.nq * l.q;
  l.o_off = l.b_off + l.bres;
  l.sc_off = l.o_off + 2 * l.o;
  l.bar_off = l.sc_off + l.sc;
  l.smem = l.bar_off + 8 * (2 * stages + 1);
  return l;
}

struct TiledArgs {
  const int8_t* ks;   // streamed weights: (N tile, chunk) blocks in the stage's layout, or null
  const float* sw;    // (Co,)
  const float* amax;  // (1,)
  const float* bias;  // (Co,) or null
  const void* into;   // (B, Ho, Wo, Co) or null
  void* out;          // (B, Ho, Wo, Co)
  int Co, K, ph, pw, Ho, Wo;
  int tiles_w, tiles_h, n_co, units;  // units: n_co x B x tiles_h x tiles_w
  int ckg, chunks, stages;            // 16-channel groups a chunk, chunks a unit
  int resident;                       // one chunk, one N tile: weights loaded once
  int vec;                            // 16-byte output vectors: Co * itemsize % 16 == 0
  Layout l;
  // one chunk's k-steps: wgmma descriptors less their start addresses' bases
  // (the quantized buffer + the warpgroup's column, the chunk's weights)
  int nsteps;
  uint64_t ka[T_MAX_KSTEPS], kb[T_MAX_KSTEPS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
// The loop is inside the asm: the compiler sees no branch that depends on
// the thread (wgmma must not follow one it takes for divergent).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory, counted in bytes on
// `bar`; coordinates innermost first, zeros outside the tensor.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The consumer warpgroups only (barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(T_CONSUMERS) : "memory");
}

// One consumer warpgroup (barriers 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N s32, the wgmma fragment) += A (64 x 32 s8) B (N x 32 s8)^T, both
// from shared memory through no-swizzle K-major descriptors; scale_d 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// V consecutive values of an output-layout tensor (plain loads: `into` may
// be the output itself), and 2 values' store
template <int V>
__device__ __forceinline__ void loadv(const float* p, float* f) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    f[0] = a.x; f[1] = a.y;
  }
}
template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float* f) {
  if constexpr (V == 8) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = a.x; f[1] = a.y;
  }
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// clip(rint(v * inv), -127, 127) of 8 values, packed little-endian, on
// full-rate float instructions (no float-to-int conversion): the product
// is clipped first (rint is monotonic and the bounds are integers), then
// 1.5 * 2^23 is added, whose sum rounds to an integer, half to even as
// rint; that integer q is the sum's bits minus 0x4b400000, and its low
// byte, q's two's complement int8, is the sum's low byte.
__device__ __forceinline__ uint2 quantize8_packed(const float* f, float inv) {
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float y = fminf(fmaxf(__fmul_rn(f[i], inv), -127.0f), 127.0f);
    b[i] = __float_as_uint(__fadd_rn(y, 12582912.0f));
  }
  // the low bytes of b[0..3] and b[4..7]
  return make_uint2(__byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                                0x5410),
                    __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040),
                                0x5410));
}

// The activation box (pixel-major, 2 segs 8-channel segments a pixel in
// T) quantized into planes of 16-byte channel groups stored pixel after
// pixel. Thread t takes segment t % segs of pixels t / segs, + 256 / segs,
// ...: no division in the loop, and two pixels' loads in flight at once.
template <typename T>
__device__ __forceinline__ void quantize_box(const unsigned char* raw, unsigned char* q, int npx,
                                             int segs, int plane, float inv, int tid) {
  const int stride = T_CONSUMERS / segs;
  const int sg = tid % segs;
  // the threads past the last whole pixel of a step take none
  const int px0 = tid / segs < stride ? tid / segs : npx;
  const T* src = reinterpret_cast<const T*>(raw) + 8 * sg;
  unsigned char* dst = q + (sg >> 1) * plane + (sg & 1) * 8;
  const int step = 8 * segs;  // elements a pixel
  int px = px0;
  for (; px + stride < npx; px += 2 * stride) {
    float f[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) load8(src + (px + i * stride) * step, f[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint2*>(dst + (px + i * stride) * 16) = quantize8_packed(f[i], inv);
    }
  }
  for (; px < npx; px += stride) {
    float f[8];
    load8(src + px * step, f);
    *reinterpret_cast<uint2*>(dst + px * 16) = quantize8_packed(f, inv);
  }
}

// Every k-step of one chunk for a warpgroup's M-block: the table's
// descriptors (kstep_table) plus the bases. Table and bases are uniform,
// so the descriptors are built in uniform registers; each step fences
// before its products, so ptxas inserts no warpgroup.arrive of its own.
template <int NT>
__device__ __forceinline__ void products(int (&acc)[NT / 2], const TiledArgs& p,
                                         uint32_t qa, uint32_t bb, int col0, int scale) {
  const uint64_t a0 = (qa >> 4) + col0, b0 = bb >> 4;
  for (int i = 0; i < p.nsteps; ++i) {
    wgmma_fence();
    wgmma_s8<NT>(acc, p.ka[i] + a0, p.kb[i] + b0, scale);
    scale = 1;
  }
}

// 16 bytes of an output-layout tensor as floats, and back
__device__ __forceinline__ void unpack16(uint4 v, const float*, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(uint4 v, const bf16*, float* f) { unpack8(v, f); }
__device__ __forceinline__ uint4 pack16(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float* f, const bf16*) { return pack8(f); }

// The staged output of one warpgroup (8 rows x 8 columns of the tile, EC
// channels from co0) to the output, V channels a thread: the previous
// part's output added in T, then the bias (`bia`, already rounded to T),
// and one 16-byte store (V = 16 / itemsize) or 2 channels a store where
// Co * itemsize is not a multiple of 16. Consecutive threads take
// consecutive vectors of a pixel, then the next pixel: whole rows of the
// output. The trip counts are constants: without `into` every load is in
// flight at once; with it, the `into` vectors come three at a time, all
// three loads issued before the first is used.
template <typename T, int V, int EC>
__device__ __forceinline__ void write_staged(const T* stg, int ldo, const float* bia,
                                             const TiledArgs& p, int n, int oy0, int ox0,
                                             int co0, int lt) {
  constexpr int PER_PX = EC / V, ITEMS = 64 * PER_PX, STEPS = (ITEMS + 127) / 128;
  constexpr bool VEC = V * sizeof(T) == 16;
  T* out = static_cast<T*>(p.out);
  const T* into = static_cast<const T*>(p.into);
  if (VEC && into) {
    constexpr int BATCH = 3;
#pragma unroll
    for (int k0 = 0; k0 < STEPS; k0 += BATCH) {
      long long o[BATCH];
      bool ok[BATCH];
      uint4 prev[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = lt + 128 * (k0 + b);
        const int px = e / PER_PX, cv = e - px * PER_PX;
        const int oy = oy0 + px / 8, ox = ox0 + px % 8, co = co0 + cv * V;
        ok[b] = k0 + b < STEPS && e < ITEMS && oy < p.Ho && ox < p.Wo && co < p.Co;
        o[b] = ((static_cast<long long>(n) * p.Ho + oy) * p.Wo + ox) * p.Co + co;
        if (ok[b]) prev[b] = *reinterpret_cast<const uint4*>(into + o[b]);
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (!ok[b]) continue;
        const int e = lt + 128 * (k0 + b), cv = e % PER_PX;
        float f[V], pr[V];
        loadv<V>(stg + (e / PER_PX) * ldo + cv * V, f);
        unpack16(prev[b], out, pr);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = round_to(__fadd_rn(pr[i], f[i]), out);
        if (p.bias) {
          const int co = co0 + cv * V;
#pragma unroll
          for (int i = 0; i < V; ++i) f[i] = round_to(__fadd_rn(f[i], bia[co + i]), out);
        }
        *reinterpret_cast<uint4*>(out + o[b]) = pack16(f, out);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int e = lt + 128 * k;
    const int px = e / PER_PX, cv = e - px * PER_PX;
    const int oy = oy0 + px / 8, ox = ox0 + px % 8, co = co0 + cv * V;
    if (e < ITEMS && oy < p.Ho && ox < p.Wo && co < p.Co) {
      const long long o = ((static_cast<long long>(n) * p.Ho + oy) * p.Wo + ox) * p.Co + co;
      if (VEC && !p.bias) {  // no `into` either: the staged values are the output's
        *reinterpret_cast<uint4*>(out + o) =
            *reinterpret_cast<const uint4*>(stg + px * ldo + cv * V);
        continue;
      }
      float f[V];
      loadv<V>(stg + px * ldo + cv * V, f);
      if (into) {
        float prev[V];
        loadv<V>(into + o, prev);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = round_to(__fadd_rn(prev[i], f[i]), out);
      }
      if (p.bias) {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = round_to(__fadd_rn(f[i], bia[co + i]), out);
      }
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(out + o) = pack16(f, out);
      } else {
        store2(out + o, f[0], f[1]);
      }
    }
  }
}

// One block per SM (two where the accumulators and the shared memory
// allow) walks units u = blockIdx.x, += gridDim.x: unit u is N tile
// u % n_co of pixel tile u / n_co (8 rows x 16 columns of one sample,
// row-major, so the blocks running at once read neighbouring halos).
// Warp 8, lane 0, is the producer: the resident weights once, then each
// (unit, chunk)'s activation box (and streamed weights) into the ring.
// Warpgroup w (warps 4w .. 4w + 3) owns M-block w: columns 8w .. 8w + 7
// of the tile.
template <typename T, int NT>
__global__ void __launch_bounds__(T_THREADS, two_blocks(NT) ? 2 : 1)
    int8_conv_tiled(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, const __grid_constant__ TiledArgs p) {
  constexpr int EC = stage_channels(NT, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + p.l.bar_off, empty0 = full0 + 8 * p.stages;
  const uint32_t wbar = empty0 + 8 * p.stages;
  // the warp's index, warp-uniform to the compiler (a shuffle of lane 0's):
  // wgmma must not sit on a path it takes for divergent
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int ntiles = p.tiles_w * p.tiles_h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      if (p.resident) {
        mbar_expect_tx(wbar, p.l.bchunk);
        tma_load_4d(base + p.l.b_off, &tmw, wbar, 0, 0, 0, 0);
      }
      const uint32_t tx_bytes = p.l.raw_bytes + (p.resident ? 0 : p.l.bchunk);
      int s = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int cot = u % p.n_co, pix = u / p.n_co;
        const int tx = pix % p.tiles_w, ty = (pix / p.tiles_w) % p.tiles_h, n = pix / ntiles;
        for (int c = 0; c < p.chunks; ++c) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t st = base + s * p.l.stage, full = full0 + 8 * s;
          mbar_expect_tx(full, tx_bytes);
          tma_load_4d(st, &tmx, full, c * 16 * p.ckg, tx * T_COLS - p.pw, ty * T_ROWS - p.ph, n);
          if (!p.resident) {  // one linear copy: the wrapper laid the chunk out as the stage
            bulk_load(st + p.l.raw,
                      p.ks + (static_cast<long long>(cot) * p.chunks + c) * p.l.bchunk,
                      p.l.bchunk, full);
          }
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, wg = warp >> 2, wl = warp & 3;
  const int lt = tid & 127;  // the thread within its warpgroup
  const int g = lane >> 2, t4 = lane & 3;
  const float sx = scale_of(p.amax);
  const float inv = __fdiv_rn(1.0f, sx);
  // sx * sw and the bias rounded to T of every channel of the N tiles
  float* const scl = reinterpret_cast<float*>(smem + p.l.sc_off);
  float* const bia = scl + p.n_co * NT;
  for (int i = tid; i < p.n_co * NT; i += T_CONSUMERS) {
    scl[i] = i < p.Co ? __fmul_rn(sx, __ldg(p.sw + i)) : 0.0f;
    bia[i] = i < p.Co && p.bias ? round_to(__ldg(p.bias + i), static_cast<const T*>(nullptr))
                                : 0.0f;
  }
  if (p.resident) {
    // the zero piece after the weights: the lone k-step's partner
    for (int i = tid; i < NT; i += T_CONSUMERS) {
      reinterpret_cast<uint4*>(smem + p.l.b_off + p.l.bchunk)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_shared();
    mbar_wait(wbar, 0);
  }
  consumers_sync();

  const int npx = p.l.hr * p.l.hc, segs = 2 * p.ckg;
  T* const stg = reinterpret_cast<T*>(smem + p.l.o_off + wg * p.l.o);
  const int ldo = p.l.ldo;
  int s = 0, qi = 0;  // the ring's stage and the quantized buffer of the next chunk
  uint32_t ph = 0;

  // The next chunk's stage quantized into q[qi], fenced for wgmma, and (with
  // resident weights) the stage given back. q[qi] was last read by the
  // products of nq chunks ago. With three buffers: this warpgroup waited for
  // them a chunk ago, the other before the barrier of the last chunk, which
  // this one has passed. With two (one chunk a unit, each unit ending in
  // wait_group 0): the other waited for its products of two units ago
  // before the barrier of the last unit, which this one has passed.
  auto quantize_next = [&]() -> uint32_t {
    mbar_wait(full0 + 8 * s, ph);
    unsigned char* q = smem + p.l.q_off + qi * p.l.q;
    quantize_box<T>(smem + s * p.l.stage, q, npx, segs, npx * 16, inv, tid);
    fence_async_shared();
    consumers_sync();
    if (p.resident && lt == 0) mbar_arrive(empty0 + 8 * s);
    __syncwarp();  // wgmma is .aligned: the warp converged again
    return smem_u32(q);
  };
  auto advance = [&]() {
    if (++s == p.stages) {
      s = 0;
      ph ^= 1;
    }
    if (++qi == p.l.nq) qi = 0;
  };

  // epilogue of unit u, EC channels a round: accumulator (j, h, e) is
  // pixel (row 2 wl + h, column g) of the warpgroup's 8 x 8 part of the
  // tile, channel 8 j + 2 t4 + e of the N tile; float(acc) * (sx *
  // sw) rounded to T into the staging rows, then whole rows out
  auto epilogue = [&](int (&acc)[NT / 2], int u) {
    fence_regs<NT / 2>(acc);
    const int cot = u % p.n_co, pix = u / p.n_co;
    const int tx = pix % p.tiles_w, ty = (pix / p.tiles_w) % p.tiles_h, n = pix / ntiles;
    const int n0 = cot * NT;
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += EC) {
#pragma unroll
      for (int j = c0 / 8; j < (c0 + EC) / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(scl + n0 + 8 * j + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = (2 * wl + h) * 8 + g;
          store2(stg + px * ldo + 8 * j - c0 + 2 * t4,
                 __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s2.x),
                 __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s2.y));
        }
      }
      warpgroup_sync(wg);
      if (p.vec) {
        write_staged<T, 16 / sizeof(T), EC>(stg, ldo, bia, p, n, ty * T_ROWS,
                                            tx * T_COLS + 8 * wg, n0 + c0, lt);
      } else {
        write_staged<T, 2, EC>(stg, ldo, bia, p, n, ty * T_ROWS, tx * T_COLS + 8 * wg,
                               n0 + c0, lt);
      }
      warpgroup_sync(wg);
    }
  };

  // The chunks of a unit in turn: with streamed weights each chunk's
  // quantize runs beside the last chunk's products; then the epilogue.
  int acc[NT / 2];
  int pend = -1;  // the stage whose weights the products in flight read
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    for (int c = 0; c < p.chunks; ++c) {
      const uint32_t q = quantize_next();
      const uint32_t bb = p.resident ? base + p.l.b_off : base + s * p.l.stage + p.l.raw;
      products<NT>(acc, p, q, bb, 8 * wg, c > 0);
      wgmma_commit();
      if (pend >= 0) {  // the last chunk's products are done: its stage is free
        wgmma_wait<1>();
        if (lt == 0) mbar_arrive(empty0 + 8 * pend);
      }
      pend = p.resident ? -1 : s;
      advance();
    }
    wgmma_wait<0>();
    if (pend >= 0 && lt == 0) mbar_arrive(empty0 + 8 * pend);
    pend = -1;
    epilogue(acc, u);
  }
}

// One chunk's k-steps as wgmma descriptors (16-byte units) less their
// bases. A: start = the tap's shift (dy rows of hc pixels, dx pixels) +
// the pair's first group plane, SBO = a halo row (wgmma's 8-row core
// matrices are 8 pixels of one output row), LBO = the next group plane. B:
// the (tap, group) pieces of nt x 16 bytes, SBO = 8 rows, LBO = the next
// piece. A tap is a start address: no copy. Groups pair within a tap; an
// odd group count pairs its last group across taps t, t + 1 (LBO = the
// distance between their shifts), and an odd tap count leaves one k-step
// whose partner is the zero piece after the weights. Returns the count.
int kstep_table(int K, int ckg, int hc, int plane, int nt, uint64_t* ka, uint64_t* kb) {
  const int KK = K * K;
  const uint64_t sbo_a = static_cast<uint64_t>(hc) << 32, sbo_b = 8ull << 32;
  int n = 0;
  for (int t = 0; t < KK; ++t) {
    const uint32_t off = (t / K) * hc + t % K;
    for (int g = 0; g + 1 < ckg; g += 2, ++n) {
      ka[n] = sbo_a | (static_cast<uint64_t>(plane) << 16) | (off + g * plane);
      kb[n] = sbo_b | (static_cast<uint64_t>(nt) << 16) | static_cast<uint32_t>((t * ckg + g) * nt);
    }
  }
  if (ckg & 1) {
    const int gl = ckg - 1;
    for (int t = 0; t < KK; t += 2, ++n) {
      const uint32_t off = (t / K) * hc + t % K;
      uint32_t lbo_a = 1, lbo_b = nt;  // the last tap: any A piece, the zero B piece
      if (t + 1 < KK) {
        lbo_a = ((t + 1) / K) * hc + (t + 1) % K - off;
        lbo_b = ckg * nt;
      }
      ka[n] = sbo_a | (static_cast<uint64_t>(lbo_a) << 16) | (off + gl * plane);
      kb[n] = sbo_b | (static_cast<uint64_t>(lbo_b) << 16) |
              static_cast<uint32_t>((t * ckg + gl) * nt);
    }
  }
  return n;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)sym;
  }
  return fn;
}

bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T, int NT>
cudaError_t launch_tiled(const CUtensorMap& tmx, const CUtensorMap& tmw, const TiledArgs& p,
                         int grid, cudaStream_t st) {
  // the opt-in shared memory already granted, per card: the attribute is
  // set for the current card (the caller makes the tensors' card current)
  constexpr int MAX_CARDS = 64;
  static int set_bytes_of[MAX_CARDS] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_CARDS) return cudaErrorInvalidDevice;
  if (p.l.smem > set_bytes_of[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_tiled<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.l.smem);
    if (err != cudaSuccess) return err;
    set_bytes_of[dev] = p.l.smem;
  }
  int8_conv_tiled<T, NT><<<grid, T_THREADS, p.l.smem, st>>>(tmx, tmw, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tiled(int nt, const CUtensorMap& tmx, const CUtensorMap& tmw,
                           const TiledArgs& p, int grid, cudaStream_t st) {
  switch (nt) {
    case 16: return launch_tiled<T, 16>(tmx, tmw, p, grid, st);
    case 32: return launch_tiled<T, 32>(tmx, tmw, p, grid, st);
    case 48: return launch_tiled<T, 48>(tmx, tmw, p, grid, st);
    case 64: return launch_tiled<T, 64>(tmx, tmw, p, grid, st);
    case 96: return launch_tiled<T, 96>(tmx, tmw, p, grid, st);
    case 128: return launch_tiled<T, 128>(tmx, tmw, p, grid, st);
    case 192: return launch_tiled<T, 192>(tmx, tmw, p, grid, st);
    case 256: return launch_tiled<T, 256>(tmx, tmw, p, grid, st);
    default: return cudaErrorInvalidValue;
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

ND_EXPORT int nd_int8_conv_small(const void* x, int dtype, const int8_t* kq, const float* sw,
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
      int8_conv_small_kernel<bf16, 3><<<grid, THREADS, 0, stream>>>(p);
    } else {
      int8_conv_small_kernel<float, 3><<<grid, THREADS, 0, stream>>>(p);
    }
  } else if (dtype == 1) {
    int8_conv_small_kernel<bf16, 1><<<grid, THREADS, 0, stream>>>(p);
  } else {
    int8_conv_small_kernel<float, 1><<<grid, THREADS, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tiled route. x: (B, H, W, Ci) bf16 (dtype 1) or fp32 (0), 16-byte
// aligned, Ci * itemsize a multiple of 16; kq (Co, K, K, Cip) 16-byte
// aligned; ks, where the weights stream, the same weights as (N tile,
// chunk, tap, group, channel of the tile, 16 bytes), zero past Co and Ci
// (ops/kernels/int8_conv.py `streamed_weights`); Co even; out and into
// 16-byte aligned. The plan (N tile nt,
// groups a chunk ckg, stages, resident, grid,
// shared bytes) comes from ops/kernels/int8_conv.py `plan`; the shared
// bytes are checked against this file's layout.
ND_EXPORT int nd_int8_conv(const void* x, int dtype, const int8_t* kq, const int8_t* ks,
                           const float* sw, const float* amax, const float* bias, const void* into,
                           void* out, int B, int H, int W, int Ci, int Cip, int Co, int K, int ph,
                           int pw, int nt, int ckg, int stages, int resident, int grid, int smem,
                           cudaStream_t stream) {
  const int es = dtype == 1 ? 2 : 4;
  const int groups = (Ci + 15) / 16;
  if (B < 1 || Co % 2 || (Ci * es) % 16 || Cip % 16 || ckg < 1 || ckg > 16 || ckg > Cip / 16 ||
      stages < 1 || grid < 1 || (resident && ckg != groups) ||
      (!resident && (ckg % 2 || ks == nullptr || reinterpret_cast<uintptr_t>(ks) % 16)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(kq) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(into) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TiledArgs p;
  p.ks = ks;
  p.sw = sw;
  p.amax = amax;
  p.bias = bias;
  p.into = into;
  p.out = out;
  p.Co = Co;
  p.K = K;
  p.ph = ph;
  p.pw = pw;
  p.Ho = H + 2 * ph - K + 1;
  p.Wo = W + 2 * pw - K + 1;
  p.tiles_w = (p.Wo + T_COLS - 1) / T_COLS;
  p.tiles_h = (p.Ho + T_ROWS - 1) / T_ROWS;
  p.n_co = (Co + nt - 1) / nt;
  p.units = p.n_co * B * p.tiles_h * p.tiles_w;
  p.ckg = ckg;
  p.chunks = (groups + ckg - 1) / ckg;
  p.stages = stages;
  p.resident = resident;
  p.vec = (Co * es) % 16 == 0;
  p.l = layout_of(K, nt, ckg, stages, resident != 0, es, p.n_co);
  if (K * K * ((ckg + 1) / 2) > T_MAX_KSTEPS) return static_cast<int>(cudaErrorInvalidValue);
  p.nsteps = kstep_table(K, ckg, p.l.hc, p.l.hr * p.l.hc, nt, p.ka, p.kb);
  if (p.l.smem != smem || (resident && p.n_co != 1)) return static_cast<int>(cudaErrorInvalidValue);
  // x as (Ci, W, H, B), boxes of a chunk's 16 ckg channels over the tile's
  // input pixels; kq as (16 bytes, Co, Cip / 16 groups, K * K taps), boxes
  // of (tap, group) pieces of nt output channels x 16 bytes
  CUtensorMap tmx, tmw;
  const cuuint64_t xd[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)Ci * es, (cuuint64_t)W * Ci * es,
                            (cuuint64_t)H * W * Ci * es};
  const cuuint32_t xb[4] = {(cuuint32_t)(16 * ckg), (cuuint32_t)p.l.hc, (cuuint32_t)p.l.hr, 1};
  const cuuint64_t wd[4] = {16, (cuuint64_t)Co, (cuuint64_t)(Cip / 16), (cuuint64_t)(K * K)};
  const cuuint64_t ws[3] = {(cuuint64_t)K * K * Cip, 16, (cuuint64_t)Cip};
  const cuuint32_t wb[4] = {16, (cuuint32_t)nt, (cuuint32_t)ckg, (cuuint32_t)(K * K)};
  if (!encode(&tmx, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              x, xd, xs, xb) ||
      !encode(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, kq, wd, ws, wb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = dtype == 1 ? dispatch_tiled<bf16>(nt, tmx, tmw, p, grid, stream)
                                     : dispatch_tiled<float>(nt, tmx, tmw, p, grid, stream);
  return static_cast<int>(err);
}
