// AttnBlock tail for a single-token context, forward, bf16:
//     tok2 = x + tok[b]
//     out  = proj(FF(LN2(tok2)) + tok2) + x
// LN over C with fp32 statistics; FF = Linear(C -> 2C) -> GELU (tanh) ->
// Linear(2C -> C); proj a 1x1 C -> C conv. x is a row-major (pixels, C)
// matrix of any pixel count P; a row's sample is row / (H * W). The
// weights are the fp32 parameters in PyTorch (out, in) layout, rounded to
// bf16 (to nearest even, as .to(torch.bfloat16)) inside the kernels.
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/attn_tail.py: _forward
// (_kernel, _tile_chain; public fused_attn_tail). The TPU version feeds the
// array (H, W, B, C)-transposed and folds width into lanes; both are TPU
// layout devices and are not carried over.
//
// Bound on this card, per stage of the canonical model (B 4, crop 512):
// 10 C^2 FLOP per pixel, 24.2 GFLOP per call at every stage (24 us at 989
// TFLOP/s), against x read and the output written (4 C bytes per pixel):
// 512^2 x 48 moves 201 MB (60 us) and 256^2 x 96 100 MB (30 us), both
// bound by bytes; 128^2 x 192 and 64^2 x 384 are bound by the tensor cores
// (24 us each).
//
// What bound the previous design (0.33-0.53 ms per call against
// 0.024-0.060): each warp carried a 16-row strip through the chain as WMMA
// 16x16x16 tiles whose accumulators each went through a per-warp fp32
// scratch tile for the epilogue; the weights were re-staged in 64 x 64
// chunks for every block of 5-8 strips, so LayerNorm, barriers and load
// latency set the pace; the next strip's x was not in flight while this one
// computed. Its wrapper cast w1, w2 and wp to bf16 on every call.
//
// Three routes, chosen by C (ops/kernels/attn_tail.fwd_plan):
//
// fused, C in {16, 32, 48, 96} (the full-resolution stages, bound by
// bytes): one persistent kernel, attn_tail_fwd_fused.
//   * Each block rounds the three weights into shared memory once (98 KB at
//     C = 96) and keeps them for its whole run.
//   * Each warp carries 16-row strips through the whole chain in registers,
//     with no block barrier: mma.sync m16n8k16 accumulators are re-packed
//     as the next product's A fragments, the weights are the B fragments
//     (ldmatrix). FF1 and FF2 run 16 hidden columns at a time, so h never
//     leaves registers; the epilogues (bias, rounding, GELU, residuals) run
//     on the fragments; the output goes out through the strip's x buffer
//     in 16-byte stores. The next strip's x is in flight by cp.async.
//   * Launches: 1.
//
// streamed, C = 192: the fused route where the weights (368 KB in bf16)
// do not fit in shared memory. The same strips, 8 warps on a 128-row group
// at a time, one block per SM; the weights, rounded by a first launch,
// stream through a 3-slot cp.async ring in steps the block shares (per
// hidden chunk: W1's rows and W2's columns; per 16 output columns: WP's
// rows), so each staged chunk feeds 128 rows. Launches: 2.
//
// tiled, the other widths up to 768 (C = 384: the strip's f alone would
// take 192 registers a lane): the chain as tiled products over all P rows,
// the intermediates n, h and t2 through device memory (mostly L2).
//   * attn_tail_fwd_ln: tok2 and LayerNorm -> n (ln_rows_body); its last
//     blocks round w1 | w2 | wp to bf16 into the scratch.
//   * attn_tail_fwd_gemm<kH>: h = gelu(n w1^T + b1); <kT2>: t2 = (h w2^T
//     + b2) + tok2; <kOut>: out = (t2 wp^T + bp) + x (gemm_rows_body, the
//     backward's products: 128 x 128 tiles, a 4-stage cp.async ring, the
//     epilogue through shared memory for 16-byte accesses).
//   * Launches: 4.
// At 256^2 x 96 and 128^2 x 192 the tiled route also runs, to be measured
// against the fused and streamed ones (chip_smoke.py).
//
// Rounding follows _tile_chain and reference_attn_tail: tok2, the LN output
// n, the FF1 output before GELU, GELU's output, the FF2 output f, f + tok2,
// the proj output and the final residual sum are bf16; sums and statistics
// are fp32. GELU is the tanh form to fp32 rounding (gelu_accurate), as the
// plain version computes it; the hardware tanh (2^-11) flipped the bf16
// rounding of several percent of h.
//
// Ragged pixel counts: a last strip, group or tile that is only partly
// filled loads zeros past the last row and stores nothing there; each row
// reads its own sample's token. Any B * H * W >= 1 runs.
//
// ptxas -v (sm_90a; chip_smoke.py's build phase), registers per thread:
//   attn_tail_fwd_fused<16> 74, <32> 100, <48> 111, no spills; <96> 128
//     (the cap at 16 warps a block) with an 8-byte spill;
//   attn_tail_fwd_streamed<192> 243, no spills; attn_tail_fwd_cast 16;
//   attn_tail_fwd_ln 32-46; attn_tail_fwd_gemm<kH>, <kT2>, <kOut> 128.
//
// The backward is csrc/attn_tail_bwd.cu; both include attn_tail_chain.cuh.
#include "attn_tail_chain.cuh"

namespace {

// The fused kernel: warps per block (8 at C <= 48; 16 at C = 96, where
// the weights take 98 KB and one block fills an SM) and blocks per SM it is
// compiled for.
__host__ __device__ constexpr int fwd_warps(int C) { return C <= 48 ? 8 : 16; }

template <int C>
struct FwdCfg {
  static constexpr int NW = fwd_warps(C);
  static constexpr int MIN_BLOCKS = C <= 48 ? 2 : 1;
};
constexpr int STRIP = 16;  // a warp's pixel strip: one m16 tile of rows

struct FwdArgs {
  const bf16* x;
  const bf16* tok;
  const float* ln_w;
  const float* ln_b;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* wp;
  const float* bp;
  bf16* out;
  long long P;
  long long HW;
  long long units;  // 16-row strips (fused) or 128-row groups (streamed)
  float eps;
};

// Shared-memory plan of the fused kernel: the three weights (bf16, padded
// rows; offsets in elements), each warp's two x strip buffers (this strip,
// the next), then the vectors ln_w | ln_b | b1 (2C) | b2 | bp in fp32
// (offset in bytes).
struct FwdSmem {
  int ldc, ld2;
  size_t w1, w2, wp, x;
  size_t vec;
  size_t bytes;
};

__host__ __device__ inline FwdSmem fwd_smem_plan(int C) {
  FwdSmem s;
  s.ldc = C + PAD;
  s.ld2 = 2 * C + PAD;
  size_t o = 0;
  s.w1 = o; o += (size_t)2 * C * s.ldc;
  s.w2 = o; o += (size_t)C * s.ld2;
  s.wp = o; o += (size_t)C * s.ldc;
  s.x = o; o += (size_t)fwd_warps(C) * 2 * STRIP * s.ldc;
  s.vec = o * sizeof(bf16);
  s.bytes = s.vec + (size_t)6 * C * sizeof(float);
  return s;
}

// The strip helpers below run on one warp and its 16-row strip in the
// mma.sync m16n8k16 fragment layout: lane l holds rows g = l / 4 and g + 8,
// columns 2 (l % 4) + {0, 1} and + {8, 9} of each 16-column chunk, both of
// an accumulator pair (two n8 tiles) and of an A fragment, so a product's
// output is the next product's A operand without leaving registers.
// `cur` is the strip's x buffer in shared memory (row stride C + PAD);
// tka / tkb the token rows of rows g and g + 8; v_* the vectors in shared
// memory.

// tok2 = x + tok and LayerNorm with fp32 centred statistics -> FF1's A
// fragments.
template <int C>
__device__ __forceinline__ void strip_layernorm(const bf16* cur, const bf16* tka,
                                                const bf16* tkb, const float* v_lnw,
                                                const float* v_lnb, float eps,
                                                uint32_t (&nA)[C / 16][4]) {
  constexpr int KC = C / 16, ldc = C + PAD;
  const int tig = threadIdx.x & 3;
  float ta[KC][4], tb[KC][4];  // tok2 of rows g and g + 8
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t xf[4];
    ldsm4(xf, a_addr(cur, ldc, 0, 16 * kc));
    const int c0 = 16 * kc + 2 * tig, c1 = c0 + 8;
    const float2 xa0 = unpack_bf2(xf[0]), xb0 = unpack_bf2(xf[1]);
    const float2 xa1 = unpack_bf2(xf[2]), xb1 = unpack_bf2(xf[3]);
    const float2 ka0 = ld_bf2(tka + c0), ka1 = ld_bf2(tka + c1);
    const float2 kb0 = ld_bf2(tkb + c0), kb1 = ld_bf2(tkb + c1);
    ta[kc][0] = round_bf16(xa0.x + ka0.x); ta[kc][1] = round_bf16(xa0.y + ka0.y);
    ta[kc][2] = round_bf16(xa1.x + ka1.x); ta[kc][3] = round_bf16(xa1.y + ka1.y);
    tb[kc][0] = round_bf16(xb0.x + kb0.x); tb[kc][1] = round_bf16(xb0.y + kb0.y);
    tb[kc][2] = round_bf16(xb1.x + kb1.x); tb[kc][3] = round_bf16(xb1.y + kb1.y);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sa += ta[kc][k];
      sb += tb[kc][k];
    }
  }
  const float mean_a = group_sum<4>(sa) / (float)C, mean_b = group_sum<4>(sb) / (float)C;
  float qa = 0.0f, qb = 0.0f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qa += (ta[kc][k] - mean_a) * (ta[kc][k] - mean_a);
      qb += (tb[kc][k] - mean_b) * (tb[kc][k] - mean_b);
    }
  const float inv_a = rsqrtf(group_sum<4>(qa) / (float)C + eps);
  const float inv_b = rsqrtf(group_sum<4>(qb) / (float)C + eps);
  auto ln = [&](float t, float mean, float inv, int c) {
    return (t - mean) * inv * v_lnw[c] + v_lnb[c];
  };
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c0 = 16 * kc + 2 * tig, c1 = c0 + 8;
    nA[kc][0] = pack_bf2(ln(ta[kc][0], mean_a, inv_a, c0), ln(ta[kc][1], mean_a, inv_a, c0 + 1));
    nA[kc][1] = pack_bf2(ln(tb[kc][0], mean_b, inv_b, c0), ln(tb[kc][1], mean_b, inv_b, c0 + 1));
    nA[kc][2] = pack_bf2(ln(ta[kc][2], mean_a, inv_a, c1), ln(ta[kc][3], mean_a, inv_a, c1 + 1));
    nA[kc][3] = pack_bf2(ln(tb[kc][2], mean_b, inv_b, c1), ln(tb[kc][3], mean_b, inv_b, c1 + 1));
  }
}

// t2 = (f + b2) + tok2 (f: the FF2 accumulators) -> proj's A fragments.
template <int C>
__device__ __forceinline__ void strip_t2(const float (&f)[C / 8][4], const bf16* cur,
                                         const bf16* tka, const bf16* tkb, const float* v_b2,
                                         uint32_t (&tA)[C / 16][4]) {
  constexpr int ldc = C + PAD;
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int nc = 0; nc < C / 16; ++nc)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = 16 * nc + 8 * nt + 2 * tig;
      const float2 xa = ld_bf2(cur + g * ldc + c), xb = ld_bf2(cur + (g + 8) * ldc + c);
      const float2 ka = ld_bf2(tka + c), kb = ld_bf2(tkb + c);
      const float b0 = v_b2[c], b1 = v_b2[c + 1];
      const float* fv = f[2 * nc + nt];
      tA[nc][2 * nt] = pack_bf2(round_bf16(fv[0] + b0) + round_bf16(xa.x + ka.x),
                                round_bf16(fv[1] + b1) + round_bf16(xa.y + ka.y));
      tA[nc][2 * nt + 1] = pack_bf2(round_bf16(fv[2] + b0) + round_bf16(xb.x + kb.x),
                                    round_bf16(fv[3] + b1) + round_bf16(xb.y + kb.y));
    }
}

// out = (o + bp) + x for output columns 16 nc .. (o: the proj accumulator
// pair), in place of x in the strip's buffer: each lane reads and writes
// only its own elements.
template <int C>
__device__ __forceinline__ void strip_out(const float (&o)[2][4], int nc, bf16* cur,
                                          const float* v_bp) {
  constexpr int ldc = C + PAD;
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = 16 * nc + 8 * nt + 2 * tig;
    const float b0 = v_bp[c], b1 = v_bp[c + 1];
    bf16* pa = cur + g * ldc + c;
    bf16* pb = cur + (g + 8) * ldc + c;
    const float2 xa = ld_bf2(pa), xb = ld_bf2(pb);
    st_bf2(pa, round_bf16(o[nt][0] + b0) + xa.x, round_bf16(o[nt][1] + b1) + xa.y);
    st_bf2(pb, round_bf16(o[nt][2] + b0) + xb.x, round_bf16(o[nt][3] + b1) + xb.y);
  }
}

// The strip's rows [row0, min(row0 + 16, P)) from its buffer to out, 16
// bytes a lane.
template <int C>
__device__ __forceinline__ void strip_store(const bf16* cur, bf16* __restrict__ out,
                                            long long row0, long long P) {
  constexpr int ldc = C + PAD;
  const int rows = (int)max(0LL, min((long long)STRIP, P - row0));
  for (int t = threadIdx.x & 31; t < rows * (C / 8); t += 32) {
    const int r = t / (C / 8), v = t - r * (C / 8);
    *reinterpret_cast<uint4*>(out + (row0 + r) * C + v * 8) =
        *reinterpret_cast<const uint4*>(cur + r * ldc + v * 8);
  }
}

// A warp's strip rows [r0, r0 + 16) of x -> dst, zeros past the last row.
template <int C>
__device__ __forceinline__ void strip_fetch(bf16* dst, const bf16* __restrict__ x, long long r0,
                                            long long P) {
  constexpr int ldc = C + PAD;
  const int rows = (int)max(0LL, min((long long)STRIP, P - r0));
  for (int t = threadIdx.x & 31; t < STRIP * (C / 8); t += 32) {
    const int r = t / (C / 8), v = t - r * (C / 8);
    const bool ok = r < rows;
    cp16(dst + r * ldc + v * 8, ok ? x + (r0 + r) * C + v * 8 : x, ok ? 16 : 0);
  }
}

// The vectors ln_w | ln_b | b1 (2C) | b2 | bp -> shared memory, fp32.
__device__ __forceinline__ void stage_vectors(float* sV, const FwdArgs& a, int C) {
  for (int i = threadIdx.x; i < 6 * C; i += blockDim.x) {
    sV[i] = i < C ? a.ln_w[i] : i < 2 * C ? a.ln_b[i - C] : i < 4 * C ? a.b1[i - 2 * C]
          : i < 5 * C ? a.b2[i - 4 * C] : a.bp[i - 5 * C];
  }
}

// Persistent blocks each take a contiguous run of 16-row strips (strips
// [k S / G, (k + 1) S / G) for block k of G); warp w of the block takes
// strips w, w + NW, ... of the run. A warp carries its strip through the
// whole chain in registers: mma.sync m16n8k16 accumulators are re-packed
// as the next product's A fragments (row g = lane / 4 and g + 8, columns
// 2 (lane % 4) + {0, 1, 8, 9} of each 16-column chunk), the weights are
// the B fragments (ldmatrix from shared memory). FF1 and FF2 run chunk by
// chunk of the hidden dimension, so h never leaves registers. Only the
// weights' staging takes a block barrier; the strips need none.
template <int C>
__global__ void __launch_bounds__(32 * FwdCfg<C>::NW, FwdCfg<C>::MIN_BLOCKS)
    attn_tail_fwd_fused(const FwdArgs a) {
  constexpr int NW = FwdCfg<C>::NW;
  constexpr int KC = C / 16;       // 16-column chunks of a C-wide row
  constexpr int HC = 2 * C / 16;   // of the hidden row
  constexpr int ldc = C + PAD, ld2 = 2 * C + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem sp = fwd_smem_plan(C);
  bf16* sb = reinterpret_cast<bf16*>(smem);
  const bf16* W1 = sb + sp.w1;
  const bf16* W2 = sb + sp.w2;
  const bf16* WP = sb + sp.wp;
  float* sV = reinterpret_cast<float*>(smem + sp.vec);  // ln_w | ln_b | b1 | b2 | bp
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  bf16* xbuf = sb + sp.x + (size_t)warp * 2 * STRIP * ldc;
  const long long P = a.P, HW = a.HW;

  const long long s_begin = (long long)blockIdx.x * a.units / gridDim.x;
  const long long s_end = (long long)(blockIdx.x + 1) * a.units / gridDim.x;
  long long s = s_begin + warp;
  if (s < s_end) strip_fetch<C>(xbuf, a.x, s * STRIP, P);
  cp_commit();
  stage_rounded(sb + sp.w1, ldc, a.w1, 2 * C, C);
  stage_rounded(sb + sp.w2, ld2, a.w2, C, 2 * C);
  stage_rounded(sb + sp.wp, ldc, a.wp, C, C);
  stage_vectors(sV, a, C);
  __syncthreads();

  for (int it = 0; s < s_end; s += NW, ++it) {
    bf16* cur = xbuf + (it & 1) * STRIP * ldc;
    __syncwarp();  // the other buffer's last strip is written out
    if (s + NW < s_end) {
      strip_fetch<C>(xbuf + ((it + 1) & 1) * STRIP * ldc, a.x, (s + NW) * STRIP, P);
    }
    cp_commit();
    cp_wait<1>();  // this strip's x
    __syncwarp();
    const long long row0 = s * STRIP;
    const long long ra = row0 + g, rb = ra + 8;
    const bf16* tka = a.tok + (size_t)(ra < P ? ra / HW : 0) * C;
    const bf16* tkb = a.tok + (size_t)(rb < P ? rb / HW : 0) * C;
    uint32_t nA[KC][4];
    strip_layernorm<C>(cur, tka, tkb, sV, sV + C, a.eps, nA);

    // FF1 -> GELU -> FF2, 16 hidden columns at a time: h = gelu(n w1^T +
    // b1) for the chunk, re-packed as an A fragment, into f += h w2^T
    float f[2 * KC][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KC; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) f[nt][k] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < HC; ++j) {
      float u[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(W1, ldc, 16 * j, 16 * kc));
        mma(u[0], nA[kc], b[0], b[1]);
        mma(u[1], nA[kc], b[2], b[3]);
      }
      uint32_t hA[4];
      gelu_chunk(u, j, sV + 2 * C, hA);
#pragma unroll
      for (int nc = 0; nc < KC; ++nc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(W2, ld2, 16 * nc, 16 * j));
        mma(f[2 * nc], hA, b[0], b[1]);
        mma(f[2 * nc + 1], hA, b[2], b[3]);
      }
    }
    uint32_t tA[KC][4];
    strip_t2<C>(f, cur, tka, tkb, sV + 4 * C, tA);
    __syncwarp();  // every lane has read x for tok2

    // out = (t2 wp^T + bp) + x, 16 columns at a time, into the x buffer
#pragma unroll
    for (int nc = 0; nc < KC; ++nc) {
      float o[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(WP, ldc, 16 * nc, 16 * kc));
        mma(o[0], tA[kc], b[0], b[1]);
        mma(o[1], tA[kc], b[2], b[3]);
      }
      strip_out<C>(o, nc, cur, sV + 5 * C);
    }
    __syncwarp();
    strip_store<C>(cur, a.out, row0, P);
  }
}

// w1 | w2 | wp (2C^2 + 2C^2 + C^2 fp32) rounded to bf16 into wb, 8 values a
// thread, by `blocks` blocks of THREADS from block index blk on.
__device__ __forceinline__ void round_weights(long long blk, const float* __restrict__ w1,
                                              const float* __restrict__ w2,
                                              const float* __restrict__ wp,
                                              bf16* __restrict__ wb, int C) {
  const long long i = (blk * THREADS + threadIdx.x) * 8;
  const long long c2 = (long long)C * C;
  if (i >= 5 * c2) return;
  const float* src = i < 2 * c2 ? w1 + i : i < 4 * c2 ? w2 + (i - 2 * c2) : wp + (i - 4 * c2);
  *reinterpret_cast<uint4*>(wb + i) = round8(src);
}

__global__ void __launch_bounds__(THREADS) attn_tail_fwd_cast(const float* __restrict__ w1,
                                                             const float* __restrict__ w2,
                                                             const float* __restrict__ wp,
                                                             bf16* __restrict__ wb, int C) {
  round_weights(blockIdx.x, w1, w2, wp, wb, C);
}

// The fused route extended to C = 192, where the weights (368 KB in bf16)
// do not fit in shared memory: the same register-resident strips, 8 warps
// on a 128-row group at a time, one block per SM; the rounded weights
// stream through a ring of SW_STAGES slots in steps shared by the block:
// per hidden chunk j, W1's rows 16 j .. and W2's columns 16 j .. (the FF
// steps), then per 16 output columns WP's rows (the proj steps). The ring
// runs on across the block's groups; the next group's x is fetched with
// the first step's weights.
constexpr int SW_NW = 8;
constexpr int SW_STAGES = 3;
constexpr int SW_GROUP = SW_NW * STRIP;  // 128 rows

struct SwSmem {
  int ldc, ldh;
  size_t x, ring, slot;  // elements: the warps' x buffers, the ring, one slot
  size_t vec;            // bytes
  size_t bytes;
};

__host__ __device__ inline SwSmem sw_smem_plan(int C) {
  SwSmem s;
  s.ldc = C + PAD;
  s.ldh = 16 + PAD;
  size_t o = 0;
  s.x = o; o += (size_t)SW_NW * 2 * STRIP * s.ldc;
  s.slot = (size_t)16 * s.ldc + (size_t)C * s.ldh;  // W1 rows | W2 columns, or WP rows
  s.ring = o; o += (size_t)SW_STAGES * s.slot;
  s.vec = o * sizeof(bf16);
  s.bytes = s.vec + (size_t)6 * C * sizeof(float);
  return s;
}

template <int C>
__global__ void __launch_bounds__(32 * SW_NW, 1)
    attn_tail_fwd_streamed(const FwdArgs a, const bf16* __restrict__ wb) {
  constexpr int KC = C / 16, HC = 2 * C / 16, STEPS = HC + KC;
  constexpr int ldc = C + PAD, ldh = 16 + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const SwSmem sp = sw_smem_plan(C);
  bf16* sb = reinterpret_cast<bf16*>(smem);
  bf16* ring = sb + sp.ring;
  float* sV = reinterpret_cast<float*>(smem + sp.vec);  // ln_w | ln_b | b1 | b2 | bp
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  bf16* xbuf = sb + sp.x + (size_t)warp * 2 * STRIP * ldc;
  const long long P = a.P, HW = a.HW;
  const bf16* w1b = wb;
  const bf16* w2b = wb + (size_t)2 * C * C;
  const bf16* wpb = wb + (size_t)4 * C * C;
  const long long g_begin = (long long)blockIdx.x * a.units / gridDim.x;
  const long long g_end = (long long)(blockIdx.x + 1) * a.units / gridDim.x;
  const long long total = (g_end - g_begin) * STEPS;

  // whole block: the weights of step q -> its ring slot
  auto issue_step = [&](long long q) {
    if (q >= total) return;
    bf16* dst = ring + (q % SW_STAGES) * sp.slot;
    const int t = (int)(q % STEPS);
    const bf16* rows = t < HC ? w1b + (size_t)16 * t * C : wpb + (size_t)16 * (t - HC) * C;
    for (int i = tid; i < 16 * (C / 8); i += 32 * SW_NW) {
      const int r = i / (C / 8), v = i - r * (C / 8);
      cp16(dst + r * ldc + v * 8, rows + (size_t)r * C + v * 8);
    }
    if (t < HC) {  // W2 (C, 2C): columns 16 t .. 16 t + 15 of every row
      bf16* d2 = dst + 16 * ldc;
      for (int i = tid; i < 2 * C; i += 32 * SW_NW) {
        const int n = i >> 1, v = i & 1;
        cp16(d2 + n * ldh + v * 8, w2b + (size_t)n * 2 * C + 16 * t + v * 8);
      }
    }
  };
  // step q's weights (and what was fetched with earlier steps) are visible
  // to the block, step q - 1's slot is free; step q + STAGES - 1 in flight
  auto next_step = [&](long long q) {
    cp_wait<SW_STAGES - 2>();
    __syncthreads();
    issue_step(q + SW_STAGES - 1);
  };

  if (g_begin < g_end) strip_fetch<C>(xbuf, a.x, g_begin * SW_GROUP + warp * STRIP, P);
  for (int q = 0; q < SW_STAGES - 1; ++q) {
    issue_step(q);
    cp_commit();
  }
  stage_vectors(sV, a, C);

  long long q = 0;
  for (long long grp = g_begin, gi = 0; grp < g_end; ++grp, ++gi) {
    bf16* cur = xbuf + (gi & 1) * STRIP * ldc;
    const long long row0 = grp * SW_GROUP + warp * STRIP;
    const long long ra = row0 + g, rb = ra + 8;
    const bf16* tka = a.tok + (size_t)(ra < P ? ra / HW : 0) * C;
    const bf16* tkb = a.tok + (size_t)(rb < P ? rb / HW : 0) * C;
    next_step(q);  // with the group's first step, its x; the next group's is fetched now
    if (grp + 1 < g_end) {
      strip_fetch<C>(xbuf + ((gi + 1) & 1) * STRIP * ldc, a.x, row0 + SW_GROUP, P);
    }
    cp_commit();
    uint32_t nA[KC][4];
    strip_layernorm<C>(cur, tka, tkb, sV, sV + C, a.eps, nA);

    // per hidden chunk j: h = gelu(n w1^T + b1), then f += h w2^T; FF1's
    // sum in two halves over k, so two mma chains run at once
    float f[2 * KC][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KC; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) f[nt][k] = 0.0f;
    for (int j = 0; j < HC; ++j, ++q) {
      if (j > 0) {
        next_step(q);
        cp_commit();
      }
      const bf16* W1c = ring + (q % SW_STAGES) * sp.slot;
      const bf16* W2c = W1c + 16 * ldc;
      float uh[2][2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(W1c, ldc, 0, 16 * kc));
        mma(uh[kc & 1][0], nA[kc], b[0], b[1]);
        mma(uh[kc & 1][1], nA[kc], b[2], b[3]);
      }
      float u[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) u[nt][k] = uh[0][nt][k] + uh[1][nt][k];
      uint32_t hA[4];
      gelu_chunk(u, j, sV + 2 * C, hA);
#pragma unroll
      for (int nc = 0; nc < KC; ++nc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(W2c, ldh, 16 * nc, 0));
        mma(f[2 * nc], hA, b[0], b[1]);
        mma(f[2 * nc + 1], hA, b[2], b[3]);
      }
    }
    uint32_t tA[KC][4];
    strip_t2<C>(f, cur, tka, tkb, sV + 4 * C, tA);
    __syncwarp();

    // out = (t2 wp^T + bp) + x, 16 output columns per step, into the x buffer
    for (int nc = 0; nc < KC; ++nc, ++q) {
      next_step(q);
      cp_commit();
      const bf16* WPc = ring + (q % SW_STAGES) * sp.slot;
      float o[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ldsm4(b, b_addr<false>(WPc, ldc, 0, 16 * kc));
        mma(o[0], tA[kc], b[0], b[1]);
        mma(o[1], tA[kc], b[2], b[3]);
      }
      strip_out<C>(o, nc, cur, sV + 5 * C);
    }
    __syncwarp();
    strip_store<C>(cur, a.out, row0, P);
  }
}

// The tiled route's first launch: blocks [0, ln_blocks) run tok2 and the
// LayerNorm over the rows (ln_rows_body); the blocks after them round
// w1 | w2 | wp (2C^2 + 2C^2 + C^2 fp32) to bf16 into wb, 8 values a thread.
template <int LPR, int G>
__global__ void __launch_bounds__(THREADS) attn_tail_fwd_ln(
    const bf16* __restrict__ x, const bf16* __restrict__ tok, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bf16* __restrict__ n_out, long long P, long long HW, int C,
    float eps, unsigned ln_blocks, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ wp, bf16* __restrict__ wb) {
  if (blockIdx.x >= ln_blocks) {
    round_weights(blockIdx.x - ln_blocks, w1, w2, wp, wb, C);
    return;
  }
  ln_rows_body<LPR, G, false>(x, tok, ln_w, ln_b, n_out, nullptr, P, HW, C, eps);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS) attn_tail_fwd_gemm(const GemmArgs g) {
  gemm_rows_body<false, EPI>(g);
}

template <int C>
cudaError_t launch_fused(const FwdArgs& a, int grid, cudaStream_t st) {
  const size_t smem = fwd_smem_plan(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_tail_fwd_fused<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_tail_fwd_fused<C><<<grid, 32 * FwdCfg<C>::NW, smem, st>>>(a);
  return cudaGetLastError();
}

template <int C>
int fused_occupancy() {
  const size_t smem = fwd_smem_plan(C).bytes;
  int blocks = 0;
  if (cudaFuncSetAttribute(attn_tail_fwd_fused<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_tail_fwd_fused<C>,
                                                    32 * FwdCfg<C>::NW, smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

template <int C>
cudaError_t launch_streamed(const FwdArgs& a, const bf16* wb, int grid, cudaStream_t st) {
  const size_t smem = sw_smem_plan(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_tail_fwd_streamed<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_tail_fwd_streamed<C><<<grid, 32 * SW_NW, smem, st>>>(a, wb);
  return cudaGetLastError();
}

template <int C>
int streamed_occupancy() {
  const size_t smem = sw_smem_plan(C).bytes;
  int blocks = 0;
  if (cudaFuncSetAttribute(attn_tail_fwd_streamed<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_tail_fwd_streamed<C>,
                                                    32 * SW_NW, smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(attn_tail_fwd_gemm<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.P + GM_BM - 1) / GM_BM), (g.N + GM_BN - 1) / GM_BN);
  attn_tail_fwd_gemm<EPI><<<grid, THREADS, GM_SMEM, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the fused kernel at width C, bytes: of the resident one
// (the weights resident, C in {16, 32, 48, 96}) or of the streamed one
// (C = 192); ops/kernels/attn_tail.fwd_smem_bytes mirrors both.
ND_EXPORT int nd_attn_tail_smem(int C) {
  return (int)(C == 192 ? sw_smem_plan(C).bytes : fwd_smem_plan(C).bytes);
}

// Resident blocks per SM of the fused kernel at width C; 0 where it is not
// built.
ND_EXPORT int nd_attn_tail_occupancy(int C) {
  return C == 16 ? fused_occupancy<16>() : C == 32 ? fused_occupancy<32>()
         : C == 48 ? fused_occupancy<48>() : C == 96 ? fused_occupancy<96>()
         : C == 192 ? streamed_occupancy<192>() : 0;
}

// The fused route. x, out: (P, C) bf16 row-major, P = B * HW >= 1; tok (B, C)
// bf16; ln_w, ln_b, b1, b2, bp fp32; w1 (2C, C), w2 (C, 2C), wp (C, C) fp32,
// PyTorch (out, in) layout. C in {16, 32, 48, 96}; grid from
// ops/kernels/attn_tail.fwd_plan.
ND_EXPORT int nd_attn_tail_fused(const void* x, const void* tok, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* wp, const void* bp,
                                 void* out, long long P, long long HW, int C, int grid, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<const bf16*>(tok);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.wp = static_cast<const float*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.out = static_cast<bf16*>(out);
  a.P = P;
  a.HW = HW;
  a.units = (P + STRIP - 1) / STRIP;
  a.eps = eps;
  const cudaError_t err = C == 16 ? launch_fused<16>(a, grid, st)
                          : C == 32 ? launch_fused<32>(a, grid, st)
                          : C == 48 ? launch_fused<48>(a, grid, st)
                          : C == 96 ? launch_fused<96>(a, grid, st) : cudaErrorInvalidValue;
  return (int)err;
}

// The fused route at C = 192, the weights streamed: the same arguments,
// grid over 128-row groups (fwd_plan); wb, 5 C^2 bf16 of scratch for the
// rounded w1 | w2 | wp. Launches: the rounding, the kernel.
ND_EXPORT int nd_attn_tail_streamed(const void* x, const void* tok, const void* ln_w,
                                    const void* ln_b, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* wp,
                                    const void* bp, void* out, void* wb, long long P,
                                    long long HW, int C, int grid, float eps, void* stream) {
  if (C != 192) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* w = static_cast<bf16*>(wb);
  const unsigned cast_blocks = (unsigned)((5LL * C * C / 8 + THREADS - 1) / THREADS);
  attn_tail_fwd_cast<<<cast_blocks, THREADS, 0, st>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(wp), w, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<const bf16*>(tok);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w1 = nullptr;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = nullptr;
  a.b2 = static_cast<const float*>(b2);
  a.wp = nullptr;
  a.bp = static_cast<const float*>(bp);
  a.out = static_cast<bf16*>(out);
  a.P = P;
  a.HW = HW;
  a.units = (P + SW_GROUP - 1) / SW_GROUP;  // 128-row groups
  a.eps = eps;
  return (int)launch_streamed<192>(a, w, grid, st);
}

// The tiled route, same arguments (C % 16 == 0, 16 <= C <= 768). Scratch:
// ops, 5 C^2 + 4 C P bf16 (the rounded w1 | w2 | wp, then n (P, C), h (P,
// 2C), t2 (P, C)).
ND_EXPORT int nd_attn_tail_tiled(const void* x, const void* tok, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* wp, const void* bp,
                                 void* out, void* ops, long long P, long long HW, int C, float eps,
                                 void* stream) {
  if (C % 16 || C < 16 || C > 256 * MAXG) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(tok);
  bf16* wb = static_cast<bf16*>(ops);
  bf16* n = wb + (size_t)5 * C * C;
  bf16* h = n + (size_t)P * C;
  bf16* t2 = h + (size_t)P * 2 * C;
  cudaError_t err;

  // LPR lanes per row and G channel groups per lane for this C
  const int lpr = C <= 128 ? 16 : 32;
  const int groups = (C / 8 + lpr - 1) / lpr;
  const unsigned ln_blocks = (unsigned)((P + WARPS * (32 / lpr) - 1) / (WARPS * (32 / lpr)));
  const unsigned cast_blocks = (unsigned)((5LL * C * C / 8 + THREADS - 1) / THREADS);
  const float* f1 = static_cast<const float*>(w1);
  const float* f2 = static_cast<const float*>(w2);
  const float* fp = static_cast<const float*>(wp);
#define ND_LN(L, GG)                                                                          \
  if (lpr == L && groups == GG)                                                               \
    attn_tail_fwd_ln<L, GG><<<ln_blocks + cast_blocks, THREADS, 0, st>>>(                     \
        xb, tb, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), n, P, HW, C, \
        eps, ln_blocks, f1, f2, fp, wb);
  ND_LN(16, 1) ND_LN(32, 1) ND_LN(32, 2) ND_LN(32, 3)
#undef ND_LN
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmArgs ga = {};
  ga.P = P;
  ga.C = C;
  ga.HW = HW;
  ga.x = xb;
  ga.tok = tb;
  // h = gelu(n w1^T + b1)
  ga.A = n; ga.W = wb; ga.K = C; ga.N = 2 * C;
  ga.bias = static_cast<const float*>(b1); ga.out = h;
  if ((err = launch_gemm<kH>(ga, st)) != cudaSuccess) return (int)err;
  // t2 = (h w2^T + b2) + tok2
  ga.A = h; ga.W = wb + (size_t)2 * C * C; ga.K = 2 * C; ga.N = C;
  ga.bias = static_cast<const float*>(b2); ga.out = t2;
  if ((err = launch_gemm<kT2>(ga, st)) != cudaSuccess) return (int)err;
  // out = (t2 wp^T + bp) + x
  ga.A = t2; ga.W = wb + (size_t)4 * C * C; ga.K = C; ga.N = C;
  ga.bias = static_cast<const float*>(bp); ga.out = static_cast<bf16*>(out);
  return (int)launch_gemm<kOut>(ga, st);
}
