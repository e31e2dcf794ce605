// Non-causal attention with an online softmax, bf16 in and out:
//     o = softmax(q k^T scale) v          q (BH, Nq, D), k, v (BH, Nk, D)
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/flash_attention.py
// (_flash_kernel / _flash_forward): q tiles resident, k / v tiles streamed,
// a running max, normaliser and weighted sum per query row. The JAX function
// falls back to its jnp reference for lengths its 256-row tiles do not
// divide; here the ragged tail is masked in the kernel, so every length runs
// on the card.
//
// Bound on this card: 4 Nq Nk D FLOP and Nq Nk exponentials per (batch,
// head). At B = 4, H = 4, N = 4096, D = 32 that is 34.4 GFLOP (35 us at 989
// TFLOP/s) and 268 M exponentials (16 per SM per clock on 132 SMs: 64 us at
// 1.98 GHz), so the exponential unit binds. The bytes are 4.2 MB.
//
// What held the first design back (5.1x the bound, 1.58x SDPA): about
// nine non-exponential instructions per score element (two conversions to
// round a logit, the scale multiply, a key < Nk select on every tile, the
// max, the subtraction, __expf's own multiply, the row sum, half a pack)
// against the exponential unit's 16 lanes, and 16 query rows per warp, so
// every k and v fragment was read from shared memory once per 16 rows.
//
// Design (mma.sync m16n8k16 bf16 products, fp32 accumulators):
//   * per score element the work besides the exponential is: half a
//     `cvt.rn.bf16x2.f32` (the logit rounded to bf16 two at a time), under
//     a quarter of a bf16x2 max (three-input VHMNMX; exact, the values
//     already are bf16), one shift or mask to widen the rounded logit, one
//     FFMA that applies scale * log2(e) and subtracts the scaled row max
//     ahead of `ex2.approx`, one FADD of the row sum and half a pack of the
//     probabilities into the P v operand; the key mask runs only on the
//     last, ragged tile, outside the main loop;
//   * the running max moves only when a row's tile max passes it by more
//     than 2^8 in the exponent (a warp vote), so most tiles skip the
//     rescale of o and of the normaliser; the probabilities against a
//     stale max stay under 2^8, where bf16 rounds them as finely;
//   * each warp owns 32 query rows (16 at D = 64), so a k or v fragment read
//     by ldmatrix feeds two m-tiles: a quarter of an ldmatrix per element;
//   * k and v tiles of 64 keys stream through a ring of STAGES buffers
//     filled by cp.async (zero past Nk), one barrier per tile; rows are
//     padded by 8 elements so the 8 rows an ldmatrix reads fall in distinct
//     bank groups. Four 128-thread blocks share an SM (128 registers), so
//     one warp's exponentials overlap another's products and the 512
//     blocks at 4096 tokens run in one wave (three per SM took 1.3 waves);
//   * the probabilities never leave registers: the accumulator layout of two
//     8-key tiles of S is the operand layout of one 16-key step of P v, and
//     v's operand comes from shared memory transposed by ldmatrix. The row
//     sums stay per lane until the end.
// ptxas (CUDA 12.9, sm_90a): D = 32 128 registers, 30720 bytes of shared
// memory, 24 bytes of stack; D = 64 128 registers, 8 bytes of stack. The
// main loop's SASS (cuobjdump, counted by chip_smoke.flash_sass_counts):
// 9.9 instructions per score element, of them 1.06 MUFU.EX2, 1.0 HMMA,
// 0.25 LDSM and 7.6 others (1.0 F2FP, 1.0 FFMA, 1.19 FADD, 0.75 FMUL of
// which 0.5 are the rarely taken rescale, ~1.1 shifts and masks, the
// rest moves, addresses and the tile's copies), from 12.6 with a rolled
// copy loop and a rescale on every tile. The
// exponential unit (1 per element at 16 per SM per clock) and the issue
// slots (~9.4 taken per element at 128 per SM per clock) now bind about
// equally; what is left is latency between a warp's dependent phases.
// wgmma is not used: at D = 32 both products are 2 k-steps deep, and what
// binds is the exponential and ALU work per element, which the design cuts.
// Rounding follows the plain version (flash_attention._attention_reference
// of the JAX package): the logits are rounded to bf16 before the fp32
// scale, the probabilities go into the P v product as bf16, and the output
// is rounded to bf16 once, after the division by the normaliser.
#include "common.cuh"

namespace {

constexpr int BK = 64;  // keys per k / v tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int D>
struct Cfg {
  static constexpr int MT = D == 32 ? 2 : 1;  // 16-row m-tiles per warp
  static constexpr int BQ = WARPS * 16 * MT;  // query rows per block
  static constexpr int LD = D + 8;            // padded shared row, elements
  static constexpr int KD = D / 16;           // k-steps of q k^T
  static constexpr int DT = D / 8;            // 8-column tiles of o
  static constexpr int NT = BK / 8;           // 8-key tiles of S
  static constexpr int STAGES = D == 32 ? 3 : 2;
  static constexpr int MIN_BLOCKS = 4;        // 128 registers: 16 warps per SM
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p, bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// Two bf16 (round to nearest) from two floats, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t load32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Whole block: start the copy of keys [k0, k0 + BK) of k and v into one
// stage; rows past nk are zero.
template <int D>
__device__ __forceinline__ void load_kv(const bf16* __restrict__ k, const bf16* __restrict__ v,
                                        int k0, int nk, bf16* ks, bf16* vs) {
  constexpr int LD = Cfg<D>::LD, VEC = D / 8;
  static_assert(BK * VEC % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < BK * VEC / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VEC, c = (i % VEC) * 8;
    const bool in = k0 + r < nk;
    const size_t off = in ? (size_t)(k0 + r) * D + c : 0;
    cp_async16(ks + r * LD + c, k + off, in ? 16 : 0);
    cp_async16(vs + r * LD + c, v + off, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Whole block, before tile j: wait until it is in and every warp is done
// with tile j - 1's stage, then start the copy of tile j + STAGES - 1 into
// that stage (an empty group past the last tile keeps the count).
template <int D>
__device__ __forceinline__ void next_tile(int j, int tiles, const bf16* __restrict__ k,
                                          const bf16* __restrict__ v, int nk, bf16* ks,
                                          bf16* vs) {
  constexpr int STAGES = Cfg<D>::STAGES, TILE_ELEMS = BK * Cfg<D>::LD;
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const int jn = j + STAGES - 1;
  if (jn < tiles) {
    const int st = jn % STAGES;
    load_kv<D>(k, v, jn * BK, nk, ks + st * TILE_ELEMS, vs + st * TILE_ELEMS);
  } else {
    asm volatile("cp.async.commit_group;\n" ::);
  }
}

// One warp, one tile of BK keys: S = q k^T, the online softmax update and
// o += P v. `valid` keys of the tile are real (MASK: the ragged last tile).
template <int D, bool MASK>
__device__ __forceinline__ void attend(const bf16* kt, const bf16* vt,
                                       const uint32_t (&qf)[Cfg<D>::MT][Cfg<D>::KD][4],
                                       float (&acc)[Cfg<D>::MT][Cfg<D>::DT][4],
                                       float (&m)[Cfg<D>::MT][2], float (&l)[Cfg<D>::MT][2],
                                       float c, int valid) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, li = lane >> 3, lj = lane & 7, t = lane & 3;

  // S = q k^T, 8 keys at a time (lane: rows g, g + 8 x keys 8 n + 2 t + {0,
  // 1} of each m-tile), each 8-key tile rounded to bf16 two logits per
  // register at once, in the order of P v's A operand: pk[mi][n / 2][2 (n %
  // 2) + r] holds row g + 8 r
  uint32_t pk[C::MT][BK / 16][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n) {
    float s[C::MT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) s[mi][0] = s[mi][1] = s[mi][2] = s[mi][3] = 0.0f;
#pragma unroll
    for (int kq = 0; kq < C::KD / 2; ++kq) {  // 32 columns of d per ldmatrix.x4
      uint32_t kb[4];
      ldsm_x4(kb, kt + (n * 8 + lj) * C::LD + kq * 32 + 8 * li, false);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi) {
        mma16816(s[mi], qf[mi][2 * kq], kb[0], kb[1]);
        mma16816(s[mi], qf[mi][2 * kq + 1], kb[2], kb[3]);
      }
    }
    uint32_t keep = 0xffffffffu;
    if (MASK) {
      const int key = n * 8 + 2 * t;
      keep = (key < valid ? 0x0000ffffu : 0u) | (key + 1 < valid ? 0xffff0000u : 0u);
    }
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t w = pack_bf16(s[mi][2 * r], s[mi][2 * r + 1]);
        pk[mi][n / 2][2 * (n % 2) + r] = MASK ? (w & keep) | (0xff80ff80u & ~keep) : w;
      }
    }
  }

  // The running max m moves only when a row's tile max exceeds it by more
  // than 2^8 in the exponent (and on the first tile, m = -inf); otherwise
  // the probabilities are taken against the stale m and stay under 2^8,
  // where fp32 sums and bf16 roundings are as exact as under 1. Most tiles
  // thus skip the rescale of o and l.
  float mx[C::MT][2];
  bool grow = false;
  const float jump = 8.0f / c;  // 2^8 in the exponent, in logit units
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t mx2 = pk[mi][0][r];
#pragma unroll
      for (int n = 1; n < C::NT; ++n) mx2 = max_bf16x2(mx2, pk[mi][n / 2][2 * (n % 2) + r]);
      float v = fmaxf(lo_f(mx2), hi_f(mx2));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      mx[mi][r] = v;
      grow |= v - m[mi][r] > jump;
    }
  }
  if (__any_sync(0xffffffffu, grow)) {  // the warp's rows take their new max
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[mi][r], mx[mi][r]);
        alpha[r] = ex2((m[mi][r] - mn) * c);  // 0 on the first tile (m = -inf)
        m[mi][r] = mn;
        l[mi][r] *= alpha[r];
      }
#pragma unroll
      for (int d = 0; d < C::DT; ++d) {
        acc[mi][d][0] *= alpha[0];
        acc[mi][d][1] *= alpha[0];
        acc[mi][d][2] *= alpha[1];
        acc[mi][d][3] *= alpha[1];
      }
    }
  }

  // P = 2^(logit c - m c), rounded to bf16 in place; row sums per lane
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mc = m[mi][r] * c;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        uint32_t& w = pk[mi][n / 2][2 * (n % 2) + r];
        const float p0 = ex2(fmaf(lo_f(w), c, -mc));
        const float p1 = ex2(fmaf(hi_f(w), c, -mc));
        rs += p0;
        rs += p1;
        w = pack_bf16(p0, p1);
      }
      l[mi][r] += rs;
    }
  }

  // o += P v, 16 keys a step; P's operand is two 8-key tiles of S
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4(vb, vt + (kc * 16 + lj + 8 * (li & 1)) * C::LD + dp * 16 + 8 * (li >> 1), true);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi) {
        mma16816(acc[mi][2 * dp], pk[mi][kc], vb[0], vb[1]);
        mma16816(acc[mi][2 * dp + 1], pk[mi][kc], vb[2], vb[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
    flash_attention_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                        float c) {
  using C = Cfg<D>;
  __shared__ __align__(16) bf16 ks[C::STAGES][BK * C::LD];
  __shared__ __align__(16) bf16 vs[C::STAGES][BK * C::LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  q += bh * nq * D;
  o += bh * nq * D;
  k += bh * nk * D;
  v += bh * nk * D;
  const int row0 = blockIdx.x * C::BQ + warp * 16 * C::MT + g;  // + 16 mi, + 8

  uint32_t qf[C::MT][C::KD][4];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
    const int r0 = row0 + 16 * mi, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      const int col = kk * 16 + 2 * t;
      qf[mi][kk][0] = r0 < nq ? load32(q + (size_t)r0 * D + col) : 0u;
      qf[mi][kk][1] = r1 < nq ? load32(q + (size_t)r1 * D + col) : 0u;
      qf[mi][kk][2] = r0 < nq ? load32(q + (size_t)r0 * D + col + 8) : 0u;
      qf[mi][kk][3] = r1 < nq ? load32(q + (size_t)r1 * D + col + 8) : 0u;
    }
  }
  float acc[C::MT][C::DT][4];
  float m[C::MT][2], l[C::MT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int d = 0; d < C::DT; ++d) {
      acc[mi][d][0] = acc[mi][d][1] = acc[mi][d][2] = acc[mi][d][3] = 0.0f;
    }
    m[mi][0] = m[mi][1] = neg_inf();  // running max of the bf16 logits
    l[mi][0] = l[mi][1] = 0.0f;       // running normaliser, this lane's keys
  }

  const int tiles = (nk + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < tiles) {
      load_kv<D>(k, v, i * BK, nk, ks[i], vs[i]);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }
  const int whole = nk / BK;  // the main loop: unmasked tiles
  for (int j = 0; j < whole; ++j) {
    next_tile<D>(j, tiles, k, v, nk, &ks[0][0], &vs[0][0]);
    attend<D, false>(ks[j % C::STAGES], vs[j % C::STAGES], qf, acc, m, l, c, BK);
  }
  if (whole < tiles) {  // the ragged last tile
    next_tile<D>(whole, tiles, k, v, nk, &ks[0][0], &vs[0][0]);
    attend<D, true>(ks[whole % C::STAGES], vs[whole % C::STAGES], qf, acc, m, l, c,
                    nk - whole * BK);
  }

#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
    const int r0 = row0 + 16 * mi, r1 = r0 + 8;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mi][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.0f / sum;
    }
#pragma unroll
    for (int d = 0; d < C::DT; ++d) {
      const int col = d * 8 + 2 * t;
      if (r0 < nq) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r0 * D + col) =
            __floats2bfloat162_rn(acc[mi][d][0] * inv[0], acc[mi][d][1] * inv[0]);
      }
      if (r1 < nq) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r1 * D + col) =
            __floats2bfloat162_rn(acc[mi][d][2] * inv[1], acc[mi][d][3] * inv[1]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int nq, int nk,
           float scale, cudaStream_t st) {
  const dim3 grid((nq + Cfg<D>::BQ - 1) / Cfg<D>::BQ, BH);
  flash_attention_fwd<D><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), nq, nk, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (BH, nq, D); k, v: (BH, nk, D); bf16 contiguous; D in {32, 64};
// nq, nk >= 1; scale > 0.
ND_EXPORT int nd_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                 int nq, int nk, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1 || !(scale > 0.0f)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, BH, nq, nk, scale, st);
    case 64: return launch<64>(q, k, v, o, BH, nq, nk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
