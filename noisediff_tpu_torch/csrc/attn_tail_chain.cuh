// The AttnBlock tail's chain, device code shared by its forward
// (attn_tail.cu) and its backward (attn_tail_bwd.cu), which recomputes the
// forward with the same rounding points:
//     tok2 = x + tok[b];  n = LN(tok2);  h = gelu(n w1^T + b1)
//     t2 = (h w2^T + b2) + tok2;  out = (t2 wp^T + bp) + x
// The PTX helpers (cp.async, ldmatrix, mma.sync m16n8k16, the hardware
// tanh and GELU through it), the staging of fp32 weights as bf16 and the
// strips' fragment helpers, the mma fragments' ldmatrix addressing, and
// the bodies of the tiled routes' row and product kernels (`ln_rows_body`,
// `gemm_rows_body` with every epilogue of both directions). Each source
// wraps the bodies in kernels of its own names, so a profile tells the
// forward's launches from the backward's. The dual head (dual_head.cu)
// carries its strips with the same helpers.
//
// One header for all, so the forward and the backward's recompute cannot
// drift apart; _build.py hashes every header into each library's name.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;        // row padding of every shared tile, elements (16 bytes)

// ---------------------------------------------------------------------------
// PTX helpers: cp.async, ldmatrix, mma.sync m16n8k16 (bf16 in, fp32 sums).

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// GELU (tanh form) and its derivative through the hardware tanh
// (tanh.approx.f32, one MUFU instruction, abs. error ~2^-11): the
// recompute and the derivative, whose results are rounded to bf16 (2^-9)
// right after. The plain version uses the exact tanh.
__device__ __forceinline__ float tanh_fast(float v) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}
__device__ __forceinline__ float gelu_fast(float v) {
  return 0.5f * v * (1.0f + tanh_fast(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}
__device__ __forceinline__ float gelu_grad_fast(float v) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  const float th = tanh_fast(k0 * (v + k1 * v * v * v));
  return 0.5f * (1.0f + th) + 0.5f * v * (1.0f - th * th) * k0 * (1.0f + 3.0f * k1 * v * v);
}

// GELU (tanh form) to fp32 rounding, for the forward, which the plain
// version holds to its bf16 rounding: 1 + tanh(y) = 2 - r for y >= 0 and r
// for y < 0, r = 2 / (e + 1), e = 2^(2 |y| / ln 2) through ex2.approx (rel.
// error 2^-22) and one approximate reciprocal; two MUFU instructions where
// tanhf takes a branch and an accurate division.
__device__ __forceinline__ float gelu_accurate(float v) {
  const float y = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(2.8853900817779268f * fabsf(y)));
  const float r = __fdividef(2.0f, e + 1.0f);
  return 0.5f * v * (y < 0.0f ? r : 2.0f - r);
}

// ---------------------------------------------------------------------------
// Staging and strip fragments, shared by the attn_tail forward's strips and
// the dual head's (dual_head.cu): fp32 parameters rounded to bf16 while
// staged; bf16 pairs packed into a 32-bit fragment register. In the
// mma.sync m16n8k16 layout lane l holds rows g = l / 4 and g + 8, columns
// 2 (l % 4) + {0, 1} and + {8, 9} of each 16-column chunk, both of an
// accumulator pair (two n8 tiles) and of an A fragment, so a product's
// output is the next product's A operand without leaving registers.

// Eight consecutive fp32 values, rounded to bf16 in one 16-byte word.
__device__ __forceinline__ uint4 round8(const float* __restrict__ src) {
  float f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = __ldg(src + k);
  return pack8(f);
}

// Whole block: rows x cols of a row-major fp32 matrix, rounded to bf16,
// into shared memory with row stride ldd. cols % 8 == 0.
__device__ __forceinline__ void stage_rounded(bf16* dst, int ldd, const float* __restrict__ src,
                                              int rows, int cols) {
  const int vec = cols / 8;
  for (int t = threadIdx.x; t < rows * vec; t += blockDim.x) {
    const int r = t / vec, v = t - r * vec;
    *reinterpret_cast<uint4*>(dst + r * ldd + v * 8) = round8(src + (size_t)r * cols + v * 8);
  }
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// h = gelu(u + b1) for hidden columns 16 j .. (u: the FF1 accumulator
// pair), as an A fragment of FF2.
__device__ __forceinline__ void gelu_chunk(const float (&u)[2][4], int j, const float* v_b1,
                                           uint32_t (&hA)[4]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = 16 * j + 8 * nt + 2 * tig;
    const float b0 = v_b1[c], b1 = v_b1[c + 1];
    hA[2 * nt] = pack_bf2(gelu_accurate(round_bf16(u[nt][0] + b0)),
                          gelu_accurate(round_bf16(u[nt][1] + b1)));
    hA[2 * nt + 1] = pack_bf2(gelu_accurate(round_bf16(u[nt][2] + b0)),
                              gelu_accurate(round_bf16(u[nt][3] + b1)));
  }
}

// ---------------------------------------------------------------------------
// Fragment addressing. A lane's ldmatrix row address for a 16 x 16 operand
// tile: A (m, k) stored [m][k] (row-major A), or stored [k][m] (the
// transposed operand of a weight gradient, pixels along k); B (k, n) for
// two 8-column n-tiles, stored [n][k] (a Linear weight (out, in) read as
// a W^T) or [k][n] (read as g W).

__device__ __forceinline__ const bf16* a_addr(const bf16* A, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  return A + (size_t)(m0 + (l & 15)) * ld + k0 + ((l >> 4) << 3);
}
__device__ __forceinline__ const bf16* at_addr(const bf16* A, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  return A + (size_t)(k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 + (((l >> 3) & 1) << 3);
}
template <bool KN>
__device__ __forceinline__ const bf16* b_addr(const bf16* B, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  if (KN) return B + (size_t)(k0 + (l & 7) + (((l >> 3) & 1) << 3)) * ld + n0 + ((l >> 4) << 3);
  return B + (size_t)(n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + (((l >> 3) & 1) << 3);
}
template <bool KN>
__device__ __forceinline__ void ldsm_b(uint32_t* r, const bf16* p) {
  if (KN) {
    ldsm4_t(r, p);
  } else {
    ldsm4(r, p);
  }
}
// elements between two k16 steps of a B operand
template <bool KN>
__device__ __forceinline__ int b_kstep(int ld) {
  return KN ? 16 * ld : 16;
}

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The row kernels give each row LPR lanes (16 for C <= 128, else 32; RPW =
// 32 / LPR rows per warp at a time); lane l of a row takes the channel
// groups (l + LPR i) * 8, i < G. C <= 768.
constexpr int MAXG = 3;

// ln_rows: tok2 = x + tok, LayerNorm -> n; with STATS, (mean, 1/std) per
// row. The rows of block b: b * WARPS * RPW ...; a block past them returns.
template <int LPR, int G, bool STATS>
__device__ __forceinline__ void ln_rows_body(const bf16* __restrict__ x,
                                             const bf16* __restrict__ tok,
                                             const float* __restrict__ ln_w,
                                             const float* __restrict__ ln_b,
                                             bf16* __restrict__ n_out,
                                             float2* __restrict__ stats, long long P,
                                             long long HW, int C, float eps) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW + lane / LPR;
  const bool ok = row < P;
  const bf16* tk = tok + (ok ? row / HW : 0) * C;
  float v[G][8];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int c = (sub + LPR * i) * 8;
    if (ok && c < C) {
      float ft[8];
      unpack8(*reinterpret_cast<const uint4*>(x + row * C + c), v[i]);
      unpack8(*reinterpret_cast<const uint4*>(tk + c), ft);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] = round_bf16(v[i][k] + ft[k]);
        s += v[i][k];
      }
    }
  }
  const float mean = group_sum<LPR>(s) / (float)C;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (ok && (sub + LPR * i) * 8 < C) {
#pragma unroll
      for (int k = 0; k < 8; ++k) q += (v[i][k] - mean) * (v[i][k] - mean);
    }
  }
  const float inv = rsqrtf(group_sum<LPR>(q) / (float)C + eps);
  if (!ok) return;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int c = (sub + LPR * i) * 8;
    if (c < C) {
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = (v[i][k] - mean) * inv * ln_w[c + k] + ln_b[c + k];
      *reinterpret_cast<uint4*>(n_out + row * C + c) = pack8(f);
    }
  }
  if (STATS && sub == 0) stats[row] = make_float2(mean, inv);
}

// gemm_rows: out (P, N) = A (P, K) x op(W), a 128 x 128 output tile per
// block, 8 warps as 2 x 4 of 64 x 32 (mma.sync on ldmatrix fragments), K in
// 32-wide steps through a 4-stage cp.async ring of A and W tiles; rows past
// P and columns past K or N load as zeros. KN = false: W is a Linear weight
// (N, K), out = A W^T; KN = true: W (K, N), out = A W. The finished tile goes
// through shared memory in fp32, so the epilogue reads its operands and
// writes its outputs 16 bytes a thread, along rows.
constexpr int GM_BM = 128;
constexpr int GM_BN = 128;
constexpr int GM_BK = 32;
constexpr int GM_STAGES = 4;
constexpr int GM_LDA = GM_BK + PAD;
constexpr int GM_A_ELEMS = GM_BM * GM_LDA;
constexpr int GM_B_ELEMS = GM_BK * (GM_BN + PAD) > GM_BN * (GM_BK + PAD)
                               ? GM_BK * (GM_BN + PAD) : GM_BN * (GM_BK + PAD);
constexpr int GM_LDC = GM_BN + 8;  // fp32 row stride of the finished tile
constexpr int GM_LANES = THREADS / (GM_BN / 8);  // epilogue threads per 8-column group
constexpr size_t GM_RING = (size_t)GM_STAGES * (GM_A_ELEMS + GM_B_ELEMS) * sizeof(bf16);
// the finished fp32 tile, then (kDu) the column sums of each row lane
constexpr size_t GM_TILE = ((size_t)GM_BM * GM_LDC + (size_t)GM_LANES * GM_BN) * sizeof(float);
constexpr size_t GM_SMEM = GM_RING > GM_TILE ? GM_RING : GM_TILE;

// the backward's kU, kT2 (shared with the forward), kDt2, kDu, kDn; the
// forward's kH and kOut
enum GemmEpi { kU, kT2, kDt2, kDu, kDn, kH, kOut };

struct GemmArgs {
  const bf16* A;
  const bf16* W;
  long long P;
  int K, N, C;
  long long HW;
  const float* bias;   // b1 (kU, kH), b2 (kT2), bp (kOut)
  const bf16* x;       // kT2: tok2 = x + tok; kOut: the residual
  const bf16* tok;
  const bf16* u;       // kDu: the FF1 output
  float* colsum;       // kDu: per 128-row tile, the sums of du over its rows (db1)
  bf16* out;           // u (kU), h (kH), t2, dt2, du, dn, the block's output (kOut)
  bf16* out2;          // h (kU)
};

template <bool KN, int EPI>
__device__ __forceinline__ void gemm_rows_body(const GemmArgs& g) {
  extern __shared__ __align__(128) unsigned char gsm[];
  bf16* sA = reinterpret_cast<bf16*>(gsm);
  bf16* sB = sA + GM_STAGES * GM_A_ELEMS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * GM_BM;
  const int n0 = blockIdx.y * GM_BN;
  const int K = g.K, N = g.N;
  const int steps = (K + GM_BK - 1) / GM_BK;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int ldb = KN ? GM_BN + PAD : GM_BK + PAD;

  auto issue = [&](int s) {
    if (s < steps) {
      const int k0 = s * GM_BK;
      bf16* da = sA + (s % GM_STAGES) * GM_A_ELEMS;
      bf16* db = sB + (s % GM_STAGES) * GM_B_ELEMS;
      for (int i = tid; i < GM_BM * (GM_BK / 8); i += THREADS) {
        const int r = i / (GM_BK / 8), v = i - r * (GM_BK / 8);
        const long long row = row0 + r;
        const int k = k0 + v * 8;
        const bool ok = row < g.P && k < K;
        cp16(da + r * GM_LDA + v * 8, ok ? g.A + row * K + k : g.A, ok ? 16 : 0);
      }
      if (KN) {  // rows k0 .. of W (K, N), columns n0 ..
        for (int i = tid; i < GM_BK * (GM_BN / 8); i += THREADS) {
          const int r = i / (GM_BN / 8), v = i - r * (GM_BN / 8);
          const int k = k0 + r, n = n0 + v * 8;
          const bool ok = k < K && n < N;
          cp16(db + r * ldb + v * 8, ok ? g.W + (size_t)k * N + n : g.W, ok ? 16 : 0);
        }
      } else {   // rows n0 .. of W (N, K), columns k0 ..
        for (int i = tid; i < GM_BN * (GM_BK / 8); i += THREADS) {
          const int r = i / (GM_BK / 8), v = i - r * (GM_BK / 8);
          const int n = n0 + r, k = k0 + v * 8;
          const bool ok = k < K && n < N;
          cp16(db + r * ldb + v * 8, ok ? g.W + (size_t)n * K + k : g.W, ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
  for (int s = 0; s < GM_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<GM_STAGES - 2>();
    __syncthreads();
    issue(s + GM_STAGES - 1);
    const bf16* ta = sA + (s % GM_STAGES) * GM_A_ELEMS;
    const bf16* tb = sB + (s % GM_STAGES) * GM_B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm_b<KN>(bfr[np], b_addr<KN>(tb, ldb, wn + np * 16, kk * 16));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldsm4(af, a_addr(ta, GM_LDA, wm + mt * 16, kk * 16));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma(acc[mt][2 * np], af, bfr[np][0], bfr[np][1]);
          mma(acc[mt][2 * np + 1], af, bfr[np][2], bfr[np][3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring's last readers are done: it holds the finished tile now
  float* sC = reinterpret_cast<float*>(gsm);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
        const int c = wn + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(sC + r * GM_LDC + c) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();
  // a thread keeps one 8-column group (tid % 16) over rows tid / 16 + 16 j
  float cs[8] = {};
  for (int i = tid; i < GM_BM * (GM_BN / 8); i += THREADS) {
    const int r = i / (GM_BN / 8), c = (i - r * (GM_BN / 8)) * 8;
    const long long row = row0 + r;
    const int col = n0 + c;
    if (row >= g.P || col >= N) continue;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(sC + r * GM_LDC + c);
    const float4 hi = *reinterpret_cast<const float4*>(sC + r * GM_LDC + c + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    const size_t o = (size_t)row * N + col;
    if (EPI == kU) {
      float h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = round_bf16(v[k] + g.bias[col + k]);
        h[k] = gelu_fast(v[k]);
      }
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
      *reinterpret_cast<uint4*>(g.out2 + o) = pack8(h);
    } else if (EPI == kH) {  // the forward
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = gelu_accurate(round_bf16(v[k] + g.bias[col + k]));
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
    } else if (EPI == kOut) {
      float xv[8];
      unpack8(*reinterpret_cast<const uint4*>(g.x + o), xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = round_bf16(v[k] + g.bias[col + k]) + xv[k];
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
    } else if (EPI == kT2) {
      float xv[8], tv[8];
      unpack8(*reinterpret_cast<const uint4*>(g.x + o), xv);
      unpack8(*reinterpret_cast<const uint4*>(g.tok + (row / g.HW) * N + col), tv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = round_bf16(v[k] + g.bias[col + k]) + round_bf16(xv[k] + tv[k]);
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
    } else if (EPI == kDu) {
      float u[8];
      unpack8(*reinterpret_cast<const uint4*>(g.u + o), u);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = round_bf16(round_bf16(v[k]) * gelu_grad_fast(u[k]));
        cs[k] += v[k];
      }
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
    } else {  // kDt2, kDn: the gradient rounded to bf16
      *reinterpret_cast<uint4*>(g.out + o) = pack8(v);
    }
  }
  if (EPI == kDu) {  // db1: the tile's column sums, row lanes added in order
    float* red = sC + GM_BM * GM_LDC;  // [GM_LANES][GM_BN]
    const int lane_row = tid / (GM_BN / 8), c = (tid % (GM_BN / 8)) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) red[lane_row * GM_BN + c + k] = cs[k];
    __syncthreads();
    if (tid < GM_BN && n0 + tid < N) {
      float s = 0.0f;
      for (int l = 0; l < GM_LANES; ++l) s += red[l * GM_BN + tid];
      g.colsum[(size_t)blockIdx.x * N + n0 + tid] = s;
    }
  }
}

}  // namespace
