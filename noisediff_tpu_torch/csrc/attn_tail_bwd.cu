// AttnBlock tail backward, bf16: the gradients of
//     tok2 = x + tok[b];  out = proj(FF(LN2(tok2)) + tok2) + x
// (csrc/attn_tail.cu) with respect to x (bf16), tok and the eight
// parameters (fp32 sums over every pixel), for the upstream gradient g.
// x, g, dx are row-major (pixels, C) matrices of any pixel count P; a
// row's sample is row / (H W). Rounding follows autograd of the plain
// version (ops/kernels/attn_tail.reference_attn_tail_bwd): the recomputed
// n, u, h, t2 and the gradients dt2, dh, du, dn, dtok2 and dx are rounded
// to bf16 where it rounds them.
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/attn_tail.py:
// _pallas_bwd (_bwd_kernel: tile recompute plus the in-kernel VJP).
//
// Bound on this card: 30 C^2 FLOP per pixel (the recompute, the data
// gradients, the weight gradients; 72.5 GFLOP per call at every stage of
// the canonical model, 73 us at 989 TFLOP/s) against x and g read and dx
// written (302 MB at 512^2 x 48, 90 us): bytes bind at C = 48, the tensor
// cores above.
//
// What bound the previous design (2.52-3.77 ms per call against 0.07-0.09):
// one 16-row strip per warp, so each staged 64x64 weight chunk fed only the
// block's few strips (two at C = 384) and every 16x16 accumulator went
// through a scratch tile for its epilogue; the operands of the weight
// gradients (n, h, t2, dt2, du: 14 C bytes per pixel) made a round trip
// through device memory into 64x64-tile split-K products; five launches
// with partial-sum passes between them.
//
// This design has two routes, chosen by C (ops/kernels/attn_tail.bwd_plan):
//
// fused, C in {16, 32, 48} (the full-resolution stages, where bytes bind):
// one persistent kernel, two blocks of 8 warps per SM, each walking a
// contiguous run of 64-row pixel tiles, then one fixed-order reduction.
//   * The three weights stay in shared memory for the whole run (23 KB at
//     C = 48): no weight traffic per tile.
//   * A tile is carried through LN -> FF1 -> GELU -> FF2 and dt2 = g wp,
//     dh = dt2 w2 -> du, dn = du w1 entirely in shared memory, each product
//     a block-wide mma.sync m16n8k16 on ldmatrix fragments (warps 2 x 4 of
//     32 x 16); epilogues (bias, rounding, GELU and its derivative through
//     the hardware tanh, residuals) run on the accumulator fragments.
//   * dW1 += du^T n, dW2 += dt2^T h, dWp += g^T t2 are taken from the same
//     shared tiles (ldmatrix.trans) into registers, 48 fp32 per thread at
//     C = 48, summed over all the block's tiles: the operands never reach
//     device memory. One partial per block.
//   * The per-channel sums (the biases', LN's, dtok per sample) run over
//     the tile's rows in a fixed order into the block's running sums in
//     shared memory; a tile across a sample boundary splits dtok by
//     sample, a ragged last tile loads zeros past P and stores nothing.
//   * Launches: 2 (the kernel, reduce_fused).
//
// tiled, 64 <= C <= 768 (the deep stages, where operations bind): the
// chain as pipelined tiled products over all P rows, the intermediates
// through device memory (10 C bf16 per pixel, 126 MB at 64^2 x 384; the
// products are what lose the time there, and the weight gradients no
// longer fit in registers).
//   * ln_rows; five gemm_rows products (128 x 128 output tiles, 8 warps of
//     64 x 32, K in 32-wide steps through a 4-stage cp.async ring; the
//     finished tile goes through shared memory so that the epilogue reads
//     and writes 16 bytes a thread); ln_bwd_rows (dx and the per-channel
//     sums per sample and row range); db1 from the du product's epilogue,
//     one column sum per 128-row tile; wgrad_gemm (dW1, dW2, dWp in one
//     launch, 128 x 128 tiles, one fixed-order split over the pixels);
//     reduce_tiled.
//   * Launches: 9.
//
// No sum uses atomics: every partial has one writer and is added in a fixed
// order, so two calls give the same bits.
//
// ptxas -v (sm_90a), registers per thread, no spills in any kernel:
//   attn_tail_bwd_fused<48> 128, <32> 124, <16> 87 (256 threads, 2 blocks
//     per SM; dynamic shared memory 113,600 / 74,368 / 39,104 bytes);
//   gemm_rows (all five) 128 (81,920 bytes: the ring, then the fp32 tile);
//   wgrad_gemm 126 (69,632 bytes); ln_bwd_rows<16, 1> 80, <32, 1> 93,
//   <32, 2> 151, <32, 3> 209 (160 C bytes); ln_rows 32-48; reduce_tiled
//   56; reduce_fused 32.
#include "attn_tail_chain.cuh"

namespace {

constexpr int FM = 64;        // the fused kernel's pixel tile rows

// ---------------------------------------------------------------------------
// Route 1, fused (C in {16, 32, 48}): one kernel per call and a reduction.

// One warp: acc[MT][2] += A[m0 : m0 + 16 MT, k0 : k0 + 16 ks] x
// B[k0' : , n0 : n0 + 16] with A row-major in shared memory.
template <int MT, bool KN>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][2][4], const bf16* A, int lda, int m0,
                                         int ka, const bf16* B, int ldb, int n0, int kb,
                                         int ksteps) {
  const bf16* pa = a_addr(A, lda, m0, ka);
  const bf16* pb = b_addr<KN>(B, ldb, n0, kb);
  const int bstep = b_kstep<KN>(ldb);
#pragma unroll 2
  for (int s = 0; s < ksteps; ++s) {
    uint32_t b[4];
    ldsm_b<KN>(b, pb + (size_t)s * bstep);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm4(a, pa + (size_t)mt * 16 * lda + s * 16);
      mma(acc[mt][0], a, b[0], b[1]);
      mma(acc[mt][1], a, b[2], b[3]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][2][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// Products over a pixel tile of M rows, the weights resident in shared
// memory. The 8 warps split a product as WARPS_M x
// WARPS_N warps of WM rows x 16 columns (MT m16-tiles, two n8-tiles);
// NCH = 16 WARPS_N columns at a time.
template <int M>
struct Tile {
  static constexpr int WM = 32;
  static constexpr int MT = WM / 16;
  static constexpr int WARPS_M = M / WM;
  static constexpr int WARPS_N = WARPS / WARPS_M;
  static constexpr int NCH = 16 * WARPS_N;
};

// Call f(row, col, v0, v1) for each pair of neighbouring columns a lane
// holds in a finished warp tile (rows m0 .., columns c0 ..).
template <int MT, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[MT][2][4], int m0, int c0, F f) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(m0 + mt * 16 + (l >> 2) + 8 * h, c0 + nt * 8 + 2 * (l & 3), acc[mt][nt][2 * h],
          acc[mt][nt][2 * h + 1]);
}

// Whole block: out = A (M x K, row stride lda) x op(W), N columns, both in
// shared memory; each warp's finished tile goes to epi(acc, m0, c0). KN =
// false: W is a Linear weight (N, K), out = A W^T; KN = true: W is (K, N),
// out = A W.
template <int M, bool KN, class Epi>
__device__ void product(const bf16* A, int lda, int K, const bf16* W, int ldw, int N, Epi epi) {
  using T = Tile<M>;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / T::WARPS_N) * T::WM;
  const int wc = (warp % T::WARPS_N) * 16;
  float acc[T::MT][2][4];
  __syncthreads();  // A is complete
  for (int n0 = 0; n0 < N; n0 += T::NCH) {
    if (n0 + wc >= N) continue;
    zero(acc);
    warp_mma<T::MT, KN>(acc, A, lda, m0, 0, W, ldw, n0 + wc, 0, K / 16);
    epi(acc, m0, n0 + wc);
  }
}

// Whole block: stage rows x cols of a row-major matrix (row stride lds)
// into shared memory with row stride ldd. cols % 8 == 0.
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* __restrict__ src, int lds,
                                      int rows, int cols) {
  const int vec = cols / 8;
  for (int t = threadIdx.x; t < rows * vec; t += blockDim.x) {
    const int r = t / vec, v = t - r * vec;
    cp16(dst + r * ldd + v * 8, src + (size_t)r * lds + v * 8);
  }
}


struct FusedArgs {
  const bf16* x;
  const bf16* tok;
  const bf16* g;
  const float* ln_w;
  const float* ln_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* wp;
  bf16* dx;
  float* wpart;  // per block: dW1 | dW2 | dWp in PyTorch layout (5 C^2)
  float* vpart;  // per block: dbp | db2 | db1 (2C) | dlnw | dlnb (6C), then dtok (B, C)
  long long P;
  long long HW;
  long long tiles;
  int B;
  float eps;
};

// offsets in the per-block vector partial, in units of C
enum VecSlot { kDbp = 0, kDb2 = 1, kDb1 = 2, kDlnw = 4, kDlnb = 5, kVec = 6 };

// Shared-memory plan of the fused kernel, offsets in bf16 elements: the
// weights, then the tile's buffers (tok2, n, u then du, h, g, t2, dn, and
// d = dt2 | dtok2), the row statistics, the column sums' partials and the
// block's running sums.
struct Smem {
  int ldc, ld2;                          // row strides of C- and 2C-wide tiles
  size_t w1, w2, wp;
  size_t x, n, u, h, g, t2, dn, d;
  size_t stats;                          // bytes: mean, 1/std (M floats each), sample (M ints)
  size_t slots;                          // bytes: Q (5C) + Q1 (2C) floats
  size_t sums;                           // bytes: the block's 6C vector sums, dtok (C)
  int q, q1;                             // row groups of the column sums over C and over 2C
  size_t bytes;
};

__host__ __device__ inline Smem smem_plan(int C) {
  constexpr int M = FM, T = THREADS;
  Smem s;
  s.ldc = C + PAD;
  s.ld2 = 2 * C + PAD;
  size_t o = 0;
  s.w1 = o; o += (size_t)2 * C * s.ldc;
  s.w2 = o; o += (size_t)C * s.ld2;
  s.wp = o; o += (size_t)C * s.ldc;
  s.x = o; o += (size_t)M * s.ldc;
  s.n = o; o += (size_t)M * s.ldc;
  s.u = o; o += (size_t)M * s.ld2;
  s.h = o; o += (size_t)M * s.ld2;
  s.g = o; o += (size_t)M * s.ldc;
  s.t2 = o; o += (size_t)M * s.ldc;
  s.dn = o; o += (size_t)M * s.ldc;
  s.d = o; o += (size_t)M * s.ld2;
  s.stats = o * sizeof(bf16);
  s.slots = s.stats + (size_t)3 * M * sizeof(float);
  s.q = T / (C / 2) < 8 ? T / (C / 2) : 8;
  s.q1 = T / C < 8 ? T / C : 8;
  s.sums = s.slots + ((size_t)s.q * 5 * C + (size_t)s.q1 * 2 * C) * sizeof(float);
  s.bytes = s.sums + (size_t)7 * C * sizeof(float);
  return s;
}

// Persistent blocks (two per SM) each walk a contiguous run of M-row pixel
// tiles (tiles [k T / G, (k + 1) T / G) for block k of G). Per tile: LayerNorm, the
// recompute (FF1, FF2), the data gradients (dt2, dh -> du, dn), the three
// weight gradients into registers, the LayerNorm backward and dx, and the
// per-channel sums into the block's partial.
template <int C>
__global__ void __launch_bounds__(THREADS, 2) attn_tail_bwd_fused(const FusedArgs a) {
  constexpr int M = FM;
  constexpr int RPW = M / WARPS;  // rows per warp in the row passes
  constexpr int LPR = 32 / RPW;   // lanes per row
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sp = smem_plan(C);
  bf16* sb = reinterpret_cast<bf16*>(smem);
  bf16* sX = sb + sp.x;
  bf16* sN = sb + sp.n;
  bf16* sU = sb + sp.u;
  bf16* sH = sb + sp.h;
  bf16* sT2 = sb + sp.t2;
  bf16* sDN = sb + sp.dn;
  bf16* sD = sb + sp.d;
  const bf16* W1 = sb + sp.w1;
  const bf16* W2 = sb + sp.w2;
  const bf16* WP = sb + sp.wp;
  float* sMean = reinterpret_cast<float*>(smem + sp.stats);
  float* sInv = sMean + M;
  int* sSample = reinterpret_cast<int*>(sInv + M);
  float* slot = reinterpret_cast<float*>(smem + sp.slots);
  float* slot1 = slot + (size_t)sp.q * 5 * C;
  float* sVec = reinterpret_cast<float*>(smem + sp.sums);  // dbp | db2 | db1 | dlnw | dlnb
  float* sDtok = sVec + kVec * C;  // dtok of sample `cur`, the block's current sample
  constexpr int ldc = C + PAD, ld2 = 2 * C + PAD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long P = a.P, HW = a.HW;

  // a tile's rows of x or g -> dst, zeros past the last row
  auto issue_rows = [&](bf16* dst, const bf16* __restrict__ src, long long tile) {
    const long long r0 = tile * M;
    const int rows = (int)min((long long)M, P - r0);
    for (int t = tid; t < M * (C / 8); t += THREADS) {
      const int r = t / (C / 8), v = t - r * (C / 8);
      const bool ok = r < rows;
      cp16(dst + r * ldc + v * 8, ok ? src + (r0 + r) * C + v * 8 : src, ok ? 16 : 0);
    }
  };
  const long long t_begin = (long long)blockIdx.x * a.tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * a.tiles / gridDim.x;
  stage(sb + sp.w1, ldc, a.w1, C, 2 * C, C);
  stage(sb + sp.w2, ld2, a.w2, 2 * C, C, 2 * C);
  stage(sb + sp.wp, ldc, a.wp, C, C, C);
  cp_commit();

  // weight gradients: 5C/16 units of 16 output rows x C columns (dW1: 2C/16
  // units; dW2: C/16 row tiles in two column halves; dWp: C/16)
  constexpr int NT = C / 8;
  constexpr int UNITS = 5 * C / 16;
  constexpr int UPW = (UNITS + WARPS - 1) / WARPS;
  float wacc[UPW][NT][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) wacc[i][j][k] = 0.0f;

  float* vp = a.vpart + (size_t)blockIdx.x * ((size_t)kVec * C + (size_t)a.B * C);
  for (int i = tid; i < kVec * C + a.B * C; i += THREADS) vp[i] = 0.0f;
  for (int i = tid; i < (kVec + 1) * C; i += THREADS) sVec[i] = 0.0f;
  // samples only grow along the block's tiles: dtok of each is written once
  int cur = (int)(t_begin * M / HW);

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long row0 = tile * M;
    const int rows = (int)min((long long)M, P - row0);  // a ragged last tile
    bf16* sG = sb + sp.g;
    __syncthreads();  // the previous tile's readers are done
    issue_rows(sG, a.g, tile);
    issue_rows(sX, a.x, tile);  // raw x; the LayerNorm makes tok2 of it in place
    cp_commit();
    cp_wait<0>();     // (and, on the first tile, the weights)
    __syncthreads();

    // tok2 = x + tok -> sX; LayerNorm with fp32 centred statistics -> sN
    {
      const int r = warp * RPW + lane / LPR, sub = lane % LPR;
      const bool ok = r < rows;
      const long long row = row0 + r;
      const int smp = ok ? (int)(row / HW) : 0;
      const bf16* tk = a.tok + (size_t)smp * C;
      float s = 0.0f;
      for (int c = sub * 8; c < C; c += LPR * 8) {
        float fx[8], ft[8];
        unpack8(*reinterpret_cast<const uint4*>(sX + r * ldc + c), fx);
        unpack8(*reinterpret_cast<const uint4*>(tk + c), ft);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          fx[k] = round_bf16(fx[k] + ft[k]);
          s += fx[k];
        }
        *reinterpret_cast<uint4*>(sX + r * ldc + c) = pack8(fx);
      }
      const float mean = group_sum<LPR>(s) / (float)C;
      float q = 0.0f;
      for (int c = sub * 8; c < C; c += LPR * 8) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(sX + r * ldc + c), f);
#pragma unroll
        for (int k = 0; k < 8; ++k) q += (f[k] - mean) * (f[k] - mean);
      }
      const float inv = rsqrtf(group_sum<LPR>(q) / (float)C + a.eps);
      for (int c = sub * 8; c < C; c += LPR * 8) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(sX + r * ldc + c), f);
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = (f[k] - mean) * inv * a.ln_w[c + k] + a.ln_b[c + k];
        *reinterpret_cast<uint4*>(sN + r * ldc + c) = pack8(f);
      }
      if (sub == 0) {
        sMean[r] = mean;
        sInv[r] = inv;
        sSample[r] = smp;
      }
    }

    // u = n w1^T + b1 -> sU; h = gelu(u) -> sH
    product<M, false>(sN, ldc, C, W1, ldc, 2 * C, [&](auto& acc, int m0, int c0) {
      for_pairs(acc, m0, c0, [&](int r, int c, float v0, float v1) {
        const float u0 = round_bf16(v0 + a.b1[c]), u1 = round_bf16(v1 + a.b1[c + 1]);
        st_bf2(sU + r * ld2 + c, u0, u1);
        st_bf2(sH + r * ld2 + c, gelu_fast(u0), gelu_fast(u1));
      });
    });

    // t2 = (h w2^T + b2) + tok2 -> sT2
    product<M, false>(sH, ld2, 2 * C, W2, ld2, C, [&](auto& acc, int m0, int c0) {
      for_pairs(acc, m0, c0, [&](int r, int c, float v0, float v1) {
        const float2 t = ld_bf2(sX + r * ldc + c);
        st_bf2(sT2 + r * ldc + c, round_bf16(v0 + a.b2[c]) + t.x,
               round_bf16(v1 + a.b2[c + 1]) + t.y);
      });
    });
    // dt2 = g wp -> sD[:, :C]
    product<M, true>(sG, ldc, C, WP, ldc, C, [&](auto& acc, int m0, int c0) {
      for_pairs(acc, m0, c0,
                [&](int r, int c, float v0, float v1) { st_bf2(sD + r * ld2 + c, v0, v1); });
    });
    // du = (dt2 w2) * gelu'(u) -> sU, in place
    product<M, true>(sD, ld2, C, W2, ld2, 2 * C, [&](auto& acc, int m0, int c0) {
      for_pairs(acc, m0, c0, [&](int r, int c, float v0, float v1) {
        const float2 u = ld_bf2(sU + r * ld2 + c);
        st_bf2(sU + r * ld2 + c, round_bf16(round_bf16(v0) * gelu_grad_fast(u.x)),
               round_bf16(round_bf16(v1) * gelu_grad_fast(u.y)));
      });
    });
    // dn = du w1 -> sDN
    product<M, true>(sU, ld2, 2 * C, W1, ldc, C, [&](auto& acc, int m0, int c0) {
      for_pairs(acc, m0, c0,
                [&](int r, int c, float v0, float v1) { st_bf2(sDN + r * ldc + c, v0, v1); });
    });

    // dW1 += du^T n, dW2 += dt2^T h, dWp += g^T t2 over the tile's rows
    // (rows past the last are zero in g, so in dt2 and du too). du was
    // finished before the dn product's barrier.
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      const int u = warp + WARPS * i;
      if (u < UNITS) {
        const bf16* A;
        const bf16* Bm;
        int lda, ldb, am, bn;
        if (u < 2 * C / 16) {
          A = sU; lda = ld2; am = u * 16; Bm = sN; ldb = ldc; bn = 0;
        } else if (u < 4 * C / 16) {
          const int v = u - 2 * C / 16;
          A = sD; lda = ld2; am = (v >> 1) * 16; Bm = sH; ldb = ld2; bn = (v & 1) * C;
        } else {
          A = sG; lda = ldc; am = (u - 4 * C / 16) * 16; Bm = sT2; ldb = ldc; bn = 0;
        }
#pragma unroll 2
        for (int k = 0; k < M / 16; ++k) {
          uint32_t af[4];
          ldsm4_t(af, at_addr(A, lda, am, k * 16));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bfr[4];
            ldsm4_t(bfr, b_addr<true>(Bm, ldb, bn + np * 16, k * 16));
            mma(wacc[i][2 * np], af, bfr[0], bfr[1]);
            mma(wacc[i][2 * np + 1], af, bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();  // dn is complete

    // LayerNorm backward: dt = inv (dxh - mean(dxh) - xh mean(dxh xh)),
    // dxh = dn ln_w; dtok2 = round(round(dt) + dt2) -> sD[:, C:]; dx = g + dtok2
    {
      const int r = warp * RPW + lane / LPR, sub = lane % LPR;
      const float mean = sMean[r], inv = sInv[r];
      float sa = 0.0f, sbb = 0.0f;
      for (int c = sub * 8; c < C; c += LPR * 8) {
        float xt[8], dn[8];
        unpack8(*reinterpret_cast<const uint4*>(sX + r * ldc + c), xt);
        unpack8(*reinterpret_cast<const uint4*>(sDN + r * ldc + c), dn);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xt[k] - mean) * inv;
          const float dxh = dn[k] * a.ln_w[c + k];
          sa += dxh;
          sbb += dxh * xh;
        }
      }
      sa = group_sum<LPR>(sa) / (float)C;
      sbb = group_sum<LPR>(sbb) / (float)C;
      for (int c = sub * 8; c < C; c += LPR * 8) {
        float xt[8], dn[8], d2[8], gr[8], dtk[8], dxo[8];
        unpack8(*reinterpret_cast<const uint4*>(sX + r * ldc + c), xt);
        unpack8(*reinterpret_cast<const uint4*>(sDN + r * ldc + c), dn);
        unpack8(*reinterpret_cast<const uint4*>(sD + r * ld2 + c), d2);
        unpack8(*reinterpret_cast<const uint4*>(sG + r * ldc + c), gr);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xt[k] - mean) * inv;
          const float dxh = dn[k] * a.ln_w[c + k];
          dtk[k] = round_bf16(round_bf16(inv * (dxh - sa - xh * sbb)) + d2[k]);
          dxo[k] = gr[k] + dtk[k];
        }
        *reinterpret_cast<uint4*>(sD + r * ld2 + C + c) = pack8(dtk);
        if (r < rows) *reinterpret_cast<uint4*>(a.dx + (row0 + r) * C + c) = pack8(dxo);
      }
    }
    __syncthreads();

    // per-channel sums over the tile's rows: thread (pair, q) takes rows
    // q, q + Q, ...; the Q partials are added in order below
    const bool one_sample = sSample[0] == sSample[rows - 1];
    {
      constexpr int P2 = C / 2;
      const int Q = sp.q;
      for (int t = tid; t < P2 * Q; t += THREADS) {
        const int c = 2 * (t % P2), q = t / P2;
        float s[5][2] = {};
        for (int r = q; r < rows; r += Q) {
          const float2 g2 = ld_bf2(sG + r * ldc + c);
          const float2 d2 = ld_bf2(sD + r * ld2 + c);
          const float2 n2 = ld_bf2(sDN + r * ldc + c);
          const float2 k2 = ld_bf2(sD + r * ld2 + C + c);
          const float2 x2 = ld_bf2(sX + r * ldc + c);
          s[0][0] += g2.x; s[0][1] += g2.y;
          s[1][0] += d2.x; s[1][1] += d2.y;
          s[2][0] += n2.x; s[2][1] += n2.y;
          s[3][0] += n2.x * ((x2.x - sMean[r]) * sInv[r]);
          s[3][1] += n2.y * ((x2.y - sMean[r]) * sInv[r]);
          s[4][0] += k2.x; s[4][1] += k2.y;
        }
        float* out = slot + (size_t)q * 5 * C + c;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          out[k * C] = s[k][0];
          out[k * C + 1] = s[k][1];
        }
      }
      for (int t = tid; t < C * sp.q1; t += THREADS) {
        const int c = 2 * (t % C), q = t / C;
        float s0 = 0.0f, s1 = 0.0f;
        for (int r = q; r < rows; r += sp.q1) {
          const float2 d = ld_bf2(sU + r * ld2 + c);
          s0 += d.x;
          s1 += d.y;
        }
        slot1[(size_t)q * 2 * C + c] = s0;
        slot1[(size_t)q * 2 * C + c + 1] = s1;
      }
      if (!one_sample) {  // dtok of a tile across samples: rows in order, per sample
        for (int c = 2 * tid; c < C; c += 2 * THREADS) {
          int smp = sSample[0], held = cur;
          float s0 = 0.0f, s1 = 0.0f;
          for (int r = 0; r <= rows; ++r) {
            if (r == rows || sSample[r] != smp) {
              if (smp != held) {  // the sample held so far is complete
                vp[(size_t)(kVec + held) * C + c] = sDtok[c];
                vp[(size_t)(kVec + held) * C + c + 1] = sDtok[c + 1];
                sDtok[c] = sDtok[c + 1] = 0.0f;
                held = smp;
              }
              sDtok[c] += s0;
              sDtok[c + 1] += s1;
              if (r == rows) break;
              smp = sSample[r];
              s0 = s1 = 0.0f;
            }
            const float2 k2 = ld_bf2(sD + r * ld2 + C + c);
            s0 += k2.x;
            s1 += k2.y;
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < 5 * C; i += THREADS) {
      const int k = i / C, c = i - k * C;
      if (k == 4 && !one_sample) continue;
      float s = 0.0f;
      for (int q = 0; q < sp.q; ++q) s += slot[(size_t)q * 5 * C + i];
      if (k == 4) {  // dtok of this tile's one sample
        if (sSample[0] != cur) {
          vp[(size_t)(kVec + cur) * C + c] = sDtok[c];
          sDtok[c] = 0.0f;
        }
        sDtok[c] += s;
      } else {
        sVec[(k == 0 ? kDbp : k == 1 ? kDb2 : k == 2 ? kDlnb : kDlnw) * C + c] += s;
      }
    }
    for (int i = tid; i < 2 * C; i += THREADS) {
      float s = 0.0f;
      for (int q = 0; q < sp.q1; ++q) s += slot1[(size_t)q * 2 * C + i];
      sVec[kDb1 * C + i] += s;
    }
    cur = sSample[rows - 1];
  }
  __syncthreads();
  for (int i = tid; i < kVec * C; i += THREADS) vp[i] = sVec[i];
  if (t_begin < t_end) {
    for (int c = tid; c < C; c += THREADS) vp[(size_t)(kVec + cur) * C + c] = sDtok[c];
  }

  // the block's weight-gradient partial, PyTorch layouts
  float* out = a.wpart + (size_t)blockIdx.x * 5 * C * C;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + WARPS * i;
    if (u >= UNITS) continue;
    size_t off;
    int ldo, am, bn;
    if (u < 2 * C / 16) {
      off = 0; ldo = C; am = u * 16; bn = 0;
    } else if (u < 4 * C / 16) {
      const int v = u - 2 * C / 16;
      off = (size_t)2 * C * C; ldo = 2 * C; am = (v >> 1) * 16; bn = (v & 1) * C;
    } else {
      off = (size_t)4 * C * C; ldo = C; am = (u - 4 * C / 16) * 16; bn = 0;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = am + (lane >> 2) + 8 * h, col = bn + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + off + (size_t)row * ldo + col) =
            make_float2(wacc[i][nt][2 * h], wacc[i][nt][2 * h + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// Route 2, tiled (C >= 64, C % 16 == 0, C <= 768): the chain as a run of
// pipelined tiled products over all P rows, the operands through device
// memory.
//   ln_rows                 tok2, LayerNorm -> n; per-row mean, 1/std
//   gemm_rows x 5           u, h = gelu(u) | t2 | dt2 | du | dn, each A x op(W)
//                           with its elementwise epilogue; du's also sums
//                           its tile's columns (db1)
//   ln_bwd_rows             the LayerNorm backward, dx, and the per-channel
//                           sums but db1, per (sample, row split)
//   wgrad_gemm              dW1, dW2, dWp per pixel split
//   reduce_tiled            every sum over its partials, in order

// The shared bodies (attn_tail_chain.cuh) under the backward's kernel names.
template <int LPR, int G>
__global__ void __launch_bounds__(THREADS) ln_rows(const bf16* __restrict__ x,
                                                   const bf16* __restrict__ tok,
                                                   const float* __restrict__ ln_w,
                                                   const float* __restrict__ ln_b,
                                                   bf16* __restrict__ n_out,
                                                   float2* __restrict__ stats, long long P,
                                                   long long HW, int C, float eps) {
  ln_rows_body<LPR, G, true>(x, tok, ln_w, ln_b, n_out, stats, P, HW, C, eps);
}

template <bool KN, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_rows(const GemmArgs g) {
  gemm_rows_body<KN, EPI>(g);
}


// ln_bwd_rows: grid (S, B); block (s, b) takes rows [s R, min(HW, (s + 1)
// R)) of sample b, RPW rows per warp at a time. Writes dx and the block's
// sums [sum g, sum dt2, sum dn, sum dn xh, sum dtok2] (5C) to part[b][s],
// its warps' rows added in warp order.
template <int LPR, int G>
__global__ void __launch_bounds__(THREADS) ln_bwd_rows(
    const bf16* __restrict__ x, const bf16* __restrict__ tok, const bf16* __restrict__ g,
    const float* __restrict__ ln_w, const bf16* __restrict__ dn, const bf16* __restrict__ dt2,
    const float2* __restrict__ stats, bf16* __restrict__ dx, float* __restrict__ part,
    long long HW, int C, long long R) {
  constexpr int RPW = 32 / LPR;
  extern __shared__ float red[];  // [WARPS][5C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane % LPR;
  const int b = blockIdx.y, S = gridDim.x;
  const long long r0 = (long long)blockIdx.x * R;
  const long long r1 = min(HW, r0 + R);
  const bf16* tk = tok + (size_t)b * C;
  float sums[5][G][8];
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sums[k][i][j] = 0.0f;

  // every lane runs the same trip count, so the row sums' shuffles line up
  for (long long base = r0 + warp * RPW; base < r1; base += WARPS * RPW) {
    const long long lr = base + lane / LPR;
    const bool ok = lr < r1;
    const long long row = (long long)b * HW + (ok ? lr : r0);
    const float2 st = stats[row];
    float xh[G][8], dv[G][8];
    float sa = 0.0f, sbb = 0.0f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int c = (sub + LPR * i) * 8;
      if (ok && c < C) {
        float xr[8], ft[8];
        unpack8(*reinterpret_cast<const uint4*>(x + row * C + c), xr);
        unpack8(*reinterpret_cast<const uint4*>(tk + c), ft);
        unpack8(*reinterpret_cast<const uint4*>(dn + row * C + c), dv[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xh[i][k] = (round_bf16(xr[k] + ft[k]) - st.x) * st.y;
          const float dxh = dv[i][k] * ln_w[c + k];
          sa += dxh;
          sbb += dxh * xh[i][k];
        }
      }
    }
    sa = group_sum<LPR>(sa) / (float)C;
    sbb = group_sum<LPR>(sbb) / (float)C;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int c = (sub + LPR * i) * 8;
      if (ok && c < C) {
        float d2[8], gr[8], dtk[8], dxo[8];
        unpack8(*reinterpret_cast<const uint4*>(dt2 + row * C + c), d2);
        unpack8(*reinterpret_cast<const uint4*>(g + row * C + c), gr);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float dxh = dv[i][k] * ln_w[c + k];
          dtk[k] = round_bf16(round_bf16(st.y * (dxh - sa - xh[i][k] * sbb)) + d2[k]);
          dxo[k] = gr[k] + dtk[k];
          sums[0][i][k] += gr[k];
          sums[1][i][k] += d2[k];
          sums[2][i][k] += dv[i][k];
          sums[3][i][k] += dv[i][k] * xh[i][k];
          sums[4][i][k] += dtk[k];
        }
        *reinterpret_cast<uint4*>(dx + row * C + c) = pack8(dxo);
      }
    }
  }
  // the warp's rows: lanes l, l + LPR, ... hold the same channels
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          sums[k][i][j] += __shfl_xor_sync(0xffffffffu, sums[k][i][j], off);
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int c = (sub + LPR * i) * 8;
      if (c < C) {
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int j = 0; j < 8; ++j) red[(size_t)warp * 5 * C + k * C + c + j] = sums[k][i][j];
      }
    }
  }
  __syncthreads();
  float* out = part + ((size_t)b * S + blockIdx.x) * 5 * C;
  for (int i = threadIdx.x; i < 5 * C; i += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += red[(size_t)w * 5 * C + i];
    out[i] = s;
  }
}

// wgrad_gemm: dW = A^T B over the pixels for dW1 (A = du, B = n), dW2
// (dt2, h) and dWp (g, t2) in one launch. Block: a 128 x 128 output tile of
// one of the three over one split of the pixels; 8 warps as 2 x 4 of 64 x 32
// (mma.sync on ldmatrix.trans fragments); the pixels stream in 32-row steps
// through a 4-stage cp.async ring. Each split writes its own fp32 partial;
// reduce_tiled adds the splits in order.
constexpr int WG_BM = 128;
constexpr int WG_BN = 128;
constexpr int WG_BK = 32;
constexpr int WG_STAGES = 4;
constexpr int WG_LDA = WG_BM + PAD;
constexpr int WG_LDB = WG_BN + PAD;
constexpr size_t WG_SMEM = (size_t)WG_STAGES * WG_BK * (WG_LDA + WG_LDB) * sizeof(bf16);

struct WgArgs {
  const bf16* a[3];
  const bf16* b[3];
  int m[3];
  int n[3];
  long long off[3];    // offset of each weight in the 5 C^2 partial
  int tiles_n[3];
  int tile_start[4];   // first block of each weight; tile_start[3] = blocks per split
  long long P;
  long long rows_per_split;
  long long part_stride;  // 5 C^2
  float* part;            // (splits, 5 C^2)
};

__global__ void __launch_bounds__(THREADS) wgrad_gemm(const WgArgs w) {
  extern __shared__ __align__(128) unsigned char wsm[];
  bf16* sA = reinterpret_cast<bf16*>(wsm);
  bf16* sB = sA + WG_STAGES * WG_BK * WG_LDA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int p = 0;
  while (p < 2 && (int)blockIdx.x >= w.tile_start[p + 1]) ++p;
  const int t = blockIdx.x - w.tile_start[p];
  const int M = w.m[p], N = w.n[p];
  const int m0 = (t / w.tiles_n[p]) * WG_BM, n0 = (t % w.tiles_n[p]) * WG_BN;
  const bf16* __restrict__ A = w.a[p];
  const bf16* __restrict__ Bm = w.b[p];
  const long long k_begin = (long long)blockIdx.y * w.rows_per_split;
  const long long k_end = min(w.P, k_begin + w.rows_per_split);
  const int steps = (int)((k_end - k_begin + WG_BK - 1) / WG_BK);
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  auto issue = [&](int s) {
    if (s < steps) {
      const long long k0 = k_begin + (long long)s * WG_BK;
      bf16* da = sA + (s % WG_STAGES) * WG_BK * WG_LDA;
      bf16* db = sB + (s % WG_STAGES) * WG_BK * WG_LDB;
      for (int i = tid; i < WG_BK * (WG_BM / 8); i += THREADS) {
        const int r = i / (WG_BM / 8), v = i - r * (WG_BM / 8);
        const long long k = k0 + r;
        const int m = m0 + v * 8;
        const bool ok = k < k_end && m < M;
        cp16(da + r * WG_LDA + v * 8, ok ? A + k * M + m : A, ok ? 16 : 0);
      }
      for (int i = tid; i < WG_BK * (WG_BN / 8); i += THREADS) {
        const int r = i / (WG_BN / 8), v = i - r * (WG_BN / 8);
        const long long k = k0 + r;
        const int n = n0 + v * 8;
        const bool ok = k < k_end && n < N;
        cp16(db + r * WG_LDB + v * 8, ok ? Bm + k * N + n : Bm, ok ? 16 : 0);
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
  for (int s = 0; s < WG_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<WG_STAGES - 2>();
    __syncthreads();
    issue(s + WG_STAGES - 1);
    const bf16* ta = sA + (s % WG_STAGES) * WG_BK * WG_LDA;
    const bf16* tb = sB + (s % WG_STAGES) * WG_BK * WG_LDB;
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm4_t(bfr[np], b_addr<true>(tb, WG_LDB, wn + np * 16, kk * 16));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldsm4_t(af, at_addr(ta, WG_LDA, wm + mt * 16, kk * 16));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma(acc[mt][2 * np], af, bfr[np][0], bfr[np][1]);
          mma(acc[mt][2 * np + 1], af, bfr[np][2], bfr[np][3]);
        }
      }
    }
  }
  cp_wait<0>();
  float* out = w.part + (size_t)blockIdx.y * w.part_stride + w.off[p];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn + nt * 8 + 2 * (lane & 3);
        if (row < M && col < N) {
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
}

// Fused route: wout[i] = sum_k wpart[k][i] (5 C^2), vout[j] = sum_k
// vpart[k][j] (6C + B C), over the G blocks in block order.
__global__ void reduce_fused(const float* __restrict__ wpart, const float* __restrict__ vpart,
                             int G, long long nw, long long nv, float* __restrict__ wout,
                             float* __restrict__ vout) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nw + nv; i += stride) {
    const bool w = i < nw;
    const float* src = w ? wpart + i : vpart + (i - nw);
    const long long n = w ? nw : nv;
    float s = 0.0f;
    for (int k = 0; k < G; ++k) s += src[(size_t)k * n];
    if (w) {
      wout[i] = s;
    } else {
      vout[i - nw] = s;
    }
  }
}

// Tiled route: wout[i] = sum over the wgrad splits; vout = [dbp | db2 | db1
// (2C) | dlnw | dlnb | dtok (B, C)] from ln_bwd_rows' partials lpart (B, S,
// 5C: g, dt2, dn, dn xh, dtok2) in (sample, split) order and the du
// product's column sums dpart (T row tiles, 2C) in tile order.
__global__ void reduce_tiled(const float* __restrict__ wpart, int splits,
                             const float* __restrict__ lpart, int S,
                             const float* __restrict__ dpart, int T, int B, int C,
                             float* __restrict__ wout, float* __restrict__ vout) {
  const long long nw = (long long)5 * C * C, nv = (long long)(6 + B) * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nw + nv; i += stride) {
    float s = 0.0f;
    if (i < nw) {
      for (int k = 0; k < splits; ++k) s += wpart[(size_t)k * nw + i];
      wout[i] = s;
      continue;
    }
    const int j = (int)(i - nw);
    if (j >= 2 * C && j < 4 * C) {  // db1
      for (int k = 0; k < T; ++k) s += dpart[(size_t)k * 2 * C + (j - 2 * C)];
    } else if (j >= 6 * C) {        // dtok of sample b
      const int b = (j - 6 * C) / C, c = (j - 6 * C) % C;
      for (int k = 0; k < S; ++k) s += lpart[((size_t)b * S + k) * 5 * C + 4 * C + c];
    } else {                        // dbp, db2, dlnw, dlnb over every (sample, split)
      const int slotc = j < C ? j : j < 2 * C ? C + (j - C) : j < 5 * C ? 3 * C + (j - 4 * C)
                                                                        : 2 * C + (j - 5 * C);
      for (int k = 0; k < B * S; ++k) s += lpart[(size_t)k * 5 * C + slotc];
    }
    vout[j] = s;
  }
}

template <int C>
cudaError_t launch_fused(const FusedArgs& a, int grid, cudaStream_t st) {
  const size_t smem = smem_plan(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_tail_bwd_fused<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_tail_bwd_fused<C><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int C>
int fused_occupancy() {
  const size_t smem = smem_plan(C).bytes;
  int blocks = 0;
  if (cudaFuncSetAttribute(attn_tail_bwd_fused<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_tail_bwd_fused<C>, THREADS,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

bool fused_supported(int C) { return C == 16 || C == 32 || C == 48; }

template <bool KN, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gemm_rows<KN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.P + GM_BM - 1) / GM_BM), (g.N + GM_BN - 1) / GM_BN);
  gemm_rows<KN, EPI><<<grid, THREADS, GM_SMEM, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the fused kernel at width C, bytes; the host plan
// (ops/kernels/attn_tail.bwd_smem_bytes) mirrors it.
ND_EXPORT int nd_attn_tail_bwd_smem(int C) { return (int)smem_plan(C).bytes; }

// Resident fused-kernel blocks per SM at width C; 0 where it is not built.
ND_EXPORT int nd_attn_tail_bwd_occupancy(int C) {
  return C == 16 ? fused_occupancy<16>() : C == 32 ? fused_occupancy<32>()
                                         : C == 48 ? fused_occupancy<48>() : 0;
}

// Backward of nd_attn_tail (attn_tail.cu) for the upstream gradient g, the
// fused route. x, g, dx: (P, C) bf16, P = B * HW >= 1; tok (B, C) bf16;
// ln_w, ln_b, b1, b2 fp32; w1 (2C, C), w2 (C, 2C), wp (C, C) bf16, PyTorch
// layout. Tile M and grid from ops/kernels/attn_tail.bwd_plan. Outputs:
// wout (5 C^2 fp32: dW1 | dW2 | dWp), vout ((6 + B) C fp32: dbp | db2 | db1
// | dlnw | dlnb | dtok). Scratch: wpart (grid, 5 C^2), vpart (grid, (6 + B) C).
ND_EXPORT int nd_attn_tail_bwd_fused(const void* x, const void* tok, const void* g,
                                     const void* ln_w, const void* ln_b, const void* w1,
                                     const void* b1, const void* w2, const void* b2,
                                     const void* wp, void* dx, void* wpart, void* vpart,
                                     void* wout, void* vout, int B, long long HW, int C,
                                     int grid, float eps, void* stream) {
  if (!fused_supported(C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FusedArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<const bf16*>(tok);
  a.g = static_cast<const bf16*>(g);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.wp = static_cast<const bf16*>(wp);
  a.dx = static_cast<bf16*>(dx);
  a.wpart = static_cast<float*>(wpart);
  a.vpart = static_cast<float*>(vpart);
  a.P = (long long)B * HW;
  a.HW = HW;
  a.tiles = (a.P + FM - 1) / FM;
  a.B = B;
  a.eps = eps;
  const cudaError_t err = C == 16 ? launch_fused<16>(a, grid, st)
                          : C == 32 ? launch_fused<32>(a, grid, st) : launch_fused<48>(a, grid, st);
  if (err != cudaSuccess) return (int)err;
  const long long nw = (long long)5 * C * C, nv = (long long)(kVec + B) * C;
  reduce_fused<<<(int)min((nw + nv + 255) / 256, 1024LL), 256, 0, st>>>(
      a.wpart, a.vpart, grid, nw, nv, static_cast<float*>(wout), static_cast<float*>(vout));
  return (int)cudaGetLastError();
}

// The tiled route, same arguments and outputs as nd_attn_tail_bwd_fused
// (C % 16 == 0, 64 <= C <= 768). Scratch: ops (P, 10C) bf16 (n | h | t2 |
// dt2 | du | u | dn), stats (P, 2) fp32, lpart (B, S, 5C), dpart
// (ceil(P / 128), 2C), wpart (splits, 5 C^2) fp32. S row splits of R rows
// per sample for the LayerNorm backward, splits of
// rows_per_split pixels for the weight gradients.
ND_EXPORT int nd_attn_tail_bwd_tiled(const void* x, const void* tok, const void* g,
                                     const void* ln_w, const void* ln_b, const void* w1,
                                     const void* b1, const void* w2, const void* b2,
                                     const void* wp, void* dx, void* ops, void* stats,
                                     void* lpart, void* dpart, void* wpart, void* wout,
                                     void* vout, int B, long long HW, int C, int S, long long R,
                                     int splits, long long rows_per_split,
                                     float eps, void* stream) {
  if (C % 16 || C < 64 || C > 256 * MAXG) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)B * HW;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(tok);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* o = static_cast<bf16*>(ops);
  bf16* n = o;
  bf16* h = o + P * C;
  bf16* t2 = o + P * 3 * C;
  bf16* dt2 = o + P * 4 * C;
  bf16* du = o + P * 5 * C;
  bf16* u = o + P * 7 * C;
  bf16* dn = o + P * 9 * C;
  float2* sts = static_cast<float2*>(stats);
  cudaError_t err;

  // LPR lanes per row and G channel groups per lane for this C
  const int lpr = C <= 128 ? 16 : 32;
  const int groups = (C / 8 + lpr - 1) / lpr;
  const unsigned ln_blocks = (unsigned)((P + WARPS * (32 / lpr) - 1) / (WARPS * (32 / lpr)));
#define ND_LN(L, GG)                                                                       \
  if (lpr == L && groups == GG)                                                            \
    ln_rows<L, GG><<<ln_blocks, THREADS, 0, st>>>(xb, tb, static_cast<const float*>(ln_w), \
                                                  static_cast<const float*>(ln_b), n, sts, P, \
                                                  HW, C, eps);
  ND_LN(16, 1) ND_LN(32, 1) ND_LN(32, 2) ND_LN(32, 3)
#undef ND_LN
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmArgs ga = {};
  ga.P = P;
  ga.C = C;
  ga.HW = HW;
  // u = n w1^T + b1, h = gelu(u)
  ga.A = n; ga.W = static_cast<const bf16*>(w1); ga.K = C; ga.N = 2 * C;
  ga.bias = static_cast<const float*>(b1); ga.out = u; ga.out2 = h;
  if ((err = launch_gemm<false, kU>(ga, st)) != cudaSuccess) return (int)err;
  // t2 = (h w2^T + b2) + tok2
  ga.A = h; ga.W = static_cast<const bf16*>(w2); ga.K = 2 * C; ga.N = C;
  ga.bias = static_cast<const float*>(b2); ga.x = xb; ga.tok = tb; ga.out = t2;
  if ((err = launch_gemm<false, kT2>(ga, st)) != cudaSuccess) return (int)err;
  // dt2 = g wp
  ga.A = gb; ga.W = static_cast<const bf16*>(wp); ga.K = C; ga.N = C; ga.out = dt2;
  if ((err = launch_gemm<true, kDt2>(ga, st)) != cudaSuccess) return (int)err;
  // du = (dt2 w2) * gelu'(u)
  ga.A = dt2; ga.W = static_cast<const bf16*>(w2); ga.K = C; ga.N = 2 * C; ga.u = u; ga.out = du;
  ga.colsum = static_cast<float*>(dpart);
  if ((err = launch_gemm<true, kDu>(ga, st)) != cudaSuccess) return (int)err;
  // dn = du w1
  ga.A = du; ga.W = static_cast<const bf16*>(w1); ga.K = 2 * C; ga.N = C; ga.out = dn;
  if ((err = launch_gemm<true, kDn>(ga, st)) != cudaSuccess) return (int)err;

  const size_t red = (size_t)WARPS * 5 * C * sizeof(float);
  float* lp = static_cast<float*>(lpart);
  const float* lnw = static_cast<const float*>(ln_w);
  err = cudaErrorInvalidValue;
#define ND_LNB(L, GG)                                                                        \
  if (lpr == L && groups == GG) {                                                            \
    err = cudaFuncSetAttribute(ln_bwd_rows<L, GG>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)red);                                                    \
    if (err == cudaSuccess)                                                                  \
      ln_bwd_rows<L, GG><<<dim3(S, B), THREADS, red, st>>>(xb, tb, gb, lnw, dn, dt2, sts,     \
                                                           static_cast<bf16*>(dx), lp, HW, C, R); \
  }
  ND_LNB(16, 1) ND_LNB(32, 1) ND_LNB(32, 2) ND_LNB(32, 3)
#undef ND_LNB
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess) return (int)err;

  WgArgs w;
  const bf16* operands[3][2] = {{du, n}, {dt2, h}, {gb, t2}};
  const int mn[3][2] = {{2 * C, C}, {C, 2 * C}, {C, C}};
  int start = 0;
  for (int k = 0; k < 3; ++k) {
    w.a[k] = operands[k][0];
    w.b[k] = operands[k][1];
    w.m[k] = mn[k][0];
    w.n[k] = mn[k][1];
    w.off[k] = (long long)2 * C * C * k;
    w.tiles_n[k] = (w.n[k] + WG_BN - 1) / WG_BN;
    w.tile_start[k] = start;
    start += ((w.m[k] + WG_BM - 1) / WG_BM) * w.tiles_n[k];
  }
  w.tile_start[3] = start;
  w.P = P;
  w.rows_per_split = rows_per_split;
  w.part_stride = (long long)5 * C * C;
  w.part = static_cast<float*>(wpart);
  err = cudaFuncSetAttribute(wgrad_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  wgrad_gemm<<<dim3(start, splits), THREADS, WG_SMEM, st>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long total = (long long)5 * C * C + (long long)(6 + B) * C;
  reduce_tiled<<<(int)min((total + 255) / 256, 1024LL), 256, 0, st>>>(
      static_cast<const float*>(wpart), splits, lp, S, static_cast<const float*>(dpart),
      (int)((P + GM_BM - 1) / GM_BM), B, C,
      static_cast<float*>(wout), static_cast<float*>(vout));
  return (int)cudaGetLastError();
}
