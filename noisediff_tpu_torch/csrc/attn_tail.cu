// AttnBlock tail for a single-token context, forward and backward, bf16:
//     tok2 = x + tok[b]
//     out  = proj(FF(LN2(tok2)) + tok2) + x
// LN over C with fp32 statistics; FF = Linear(C -> 2C) -> GELU (tanh) ->
// Linear(2C -> C); proj a 1x1 C -> C conv. x is a row-major (pixels, C)
// matrix; a row's sample is row / (H * W).
//
// Replaces the TPU kernels noisediff_tpu/ops/pallas/attn_tail.py: _forward
// (_kernel, _tile_chain; public fused_attn_tail) and _pallas_bwd
// (_bwd_kernel: tile recompute plus the in-kernel VJP). The TPU versions
// feed the array (H, W, B, C)-transposed and fold width into lanes; both are
// TPU layout devices and are not carried over.
//
// Forward bound on this card: 10 C^2 FLOP per pixel against 4 C bytes
// moved, so the full-resolution stages (C = 48, 96) are bound by memory (s0
// moves 201 MB, 60 us) and the deep ones (C = 192, 384) by the tensor cores
// (24.2 GFLOP per call at every stage, 24 us at 989 TFLOP/s).
//
// Forward design:
//   * each warp owns a strip of 16 rows and carries it through the whole
//     chain on chip: the strip's LN output (later f + tok2) and its hidden
//     activations live in the warp's slice of shared memory (96 C + 1 KB
//     bytes, 37 KB at C = 384), so x is read from device memory and the
//     result written once (tok2 and x are re-read for the epilogues, from
//     L2);
//   * the three products run on the tensor cores as WMMA 16x16x16 bf16
//     tiles with fp32 accumulators; the strip is the A operand;
//   * the weights, in their PyTorch (out, in) layout, stream through shared
//     memory in chunks of up to 64 outputs x 64 inputs, loaded with cp.async
//     by the whole block and double-buffered, so one load of a chunk feeds
//     every strip of the block (5 at C = 384, 8 below) and the next chunk
//     is in flight while the tensor cores work on this one. No weight matrix
//     has to fit in shared memory, which at C = 384 it would not (w1 alone
//     is 576 KB);
//   * each 16x16 accumulator tile goes through a per-warp fp32 scratch tile
//     for its epilogue (bias, rounding, GELU, residuals), 8 channels per
//     lane with 16-byte accesses.
// Rounding follows _tile_chain: the LN output n, the FF1 output before
// GELU, GELU's output, the FF2 output f, f + tok2, the proj output and the
// final residual sum are bf16; sums and statistics are fp32.
//
// Backward bound: 30 C^2 FLOP per pixel (the forward recomputed, the data
// gradients and the weight gradients), 72.5 GFLOP per call at every stage
// of the canonical model, 73 us at 989 TFLOP/s; the bytes it must move are
// x and g read and dx written (302 MB, 90 us at stage 0).
//
// Backward design (three kernels; the wrapper counts them as one launch):
//   1. attn_tail_bwd_rows: one 16-row strip per warp, as in the forward. The
//      strip recomputes LN -> FF1 -> GELU -> FF2 on chip (the proj output is
//      not needed), then runs the data gradients as WMMA products with the
//      weights streamed through shared memory in (in, out) orientation:
//      dt2 = g wp, dh = dt2 w2, du = dh * gelu'(u), dn = du w1, then the LN
//      backward and dx = g + dtok2. Per-channel sums (the bias, LN and tok
//      gradients) are reduced across the strip by warp shuffles into the
//      warp's own row in shared memory, one writer per slot; the block then
//      adds its warps' rows in warp order, one partial per block; a block's
//      strips all lie in one sample. The operands of the three weight gradients
//      (n, h, t2, dt2, du: 7 C bf16 per pixel) are written to a scratch
//      buffer.
//   2. attn_tail_bwd_vec_samples, attn_tail_bwd_vec: sum the per-block
//      partials in a fixed order, per sample, then over the samples.
//   3. wgrad_partial + sum_splits (common.cuh), once per weight: dW = A^T B
//      over all pixels, a split-K WMMA product (64 x 64 output tiles,
//      64-pixel steps staged with cp.async), fp32 partials per split summed
//      in a fixed order. No sum anywhere uses atomics, so the gradients are
//      deterministic.
// The scratch round trip (14 C bytes per pixel, about 0.7 GB at stage 0)
// makes this slower than its bound: the weight gradients at C = 384 do not
// fit a block's shared memory (dw1 alone is 576 KB in fp32), and a block
// that kept them would have to recompute its pixels once per weight slice.
// Rounding follows autograd of the plain version: each gradient of a bf16
// intermediate (dt2, dh, du, dn, the LN input's, dx) is rounded to bf16.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 16;             // rows per warp strip (one WMMA tile high)
constexpr int CHUNK = 64;            // most rows / columns of one staged weight chunk
constexpr int BLD = CHUNK + 8;       // staged chunk row stride, elements (padded)
constexpr int STAGE = CHUNK * BLD;   // elements per staging buffer
constexpr size_t STAGE_BYTES = 2 * STAGE * sizeof(bf16);  // two buffers
constexpr size_t SMEM_BUDGET = 225 * 1024;
constexpr int NVEC = 7;              // per-channel sums of the backward, in units of C

enum Epilogue { kFF1, kFF2, kProj };

struct Args {
  const bf16* x;
  const bf16* tok;
  const float* ln_w;
  const float* ln_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* wp;
  const float* bp;
  bf16* out;
  long long P;
  long long HW;
  int C;
  float eps;
};

__host__ __device__ inline size_t warp_smem_bytes(int C) {
  // LN output / t2 (16 x C bf16) + hidden (16 x 2C bf16) + a 16x16 fp32 tile
  return (size_t)ROWS * C * 2 * 3 + ROWS * 16 * sizeof(float);
}

__device__ __forceinline__ int tiles_per_chunk(int tiles) {
  return tiles % 4 == 0 ? 4 : tiles % 3 == 0 ? 3 : tiles % 2 == 0 ? 2 : 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Whole block: stage M[r0 : r0+nr, c0 : c0+nc] of a row-major matrix with
// row stride ld into dst (row stride BLD). nc % 8 == 0.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ M, int ld, int r0,
                                          int c0, int nr, int nc) {
  const int vec_per_row = nc / 8;
  for (int i = threadIdx.x; i < nr * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int v = i - r * vec_per_row;
    cp_async16(dst + r * BLD + v * 8, M + (size_t)(r0 + r) * ld + c0 + v * 8);
  }
  cp_async_commit();
}

// One lane's 8 values of a finished 16x16 fp32 tile: row lane / 2, columns
// (lane & 1) * 8 + [0, 8).
__device__ __forceinline__ void tile8(const float* s_acc, float* v) {
  const int lane = threadIdx.x & 31;
  const float4 lo = *reinterpret_cast<const float4*>(s_acc + (lane >> 1) * 16 + (lane & 1) * 8);
  const float4 hi = *reinterpret_cast<const float4*>(s_acc + (lane >> 1) * 16 + (lane & 1) * 8 + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One warp: the forward epilogue of a finished 16x16 accumulator tile (in
// s_acc), columns [n_base, n_base + 16) of the product. Lane l takes row
// l / 2 and 8 channels.
template <int MODE>
__device__ __forceinline__ void epilogue(const Args& a, const float* s_acc, int n_base,
                                         long long row0, bf16* s_n, bf16* s_h) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int n = n_base + (lane & 1) * 8;
  const int C = a.C;
  float v[8];
  tile8(s_acc, v);
  if (MODE == kFF1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu_tanh(round_bf16(v[i] + a.b1[n + i]));
    *reinterpret_cast<uint4*>(s_h + r * 2 * C + n) = pack8(v);
    return;
  }
  const long long row = row0 + r;
  float xr[8];
  unpack8(*reinterpret_cast<const uint4*>(a.x + row * C + n), xr);
  if (MODE == kFF2) {
    float tk[8];
    unpack8(*reinterpret_cast<const uint4*>(a.tok + (row / a.HW) * C + n), tk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = round_bf16(v[i] + a.b2[n + i]) + round_bf16(xr[i] + tk[i]);  // f + tok2
    }
    *reinterpret_cast<uint4*>(s_n + r * C + n) = pack8(v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i] + a.bp[n + i]) + xr[i];
    *reinterpret_cast<uint4*>(a.out + row * C + n) = pack8(v);
  }
}

// Whole block: every active warp multiplies its strip sA (16 x K, leading
// dimension lda; shared or device memory) by a K x N weight operand, chunk
// by chunk through the staging buffers, and hands each finished 16x16 fp32
// tile (in s_acc) with its first column to epi. W_IS_KN = false: the
// operand is W^T for W (N, K) row-major, a Linear's forward (a W^T);
// W_IS_KN = true: it is W itself, (K, N) row-major, a Linear's data
// gradient (g W).
template <bool W_IS_KN, class Epi>
__device__ void strip_gemm(const bf16* __restrict__ W, int N, int K, const bf16* sA, int lda,
                           bf16* stage, float* s_acc, bool active, Epi epi) {
  using BLayout = typename std::conditional<W_IS_KN, wmma::row_major, wmma::col_major>::type;
  const int tn = tiles_per_chunk(N / 16);
  const int tk = tiles_per_chunk(K / 16);
  const int nb = tn * 16, kb = tk * 16;
  const int k_chunks = K / kb;
  const int total = (N / nb) * k_chunks;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;

  auto load = [&](int i, bf16* dst) {
    const int nc = i / k_chunks;
    const int kc = i - nc * k_chunks;
    if (W_IS_KN) {
      load_rows(dst, W, N, kc * kb, nc * nb, kb, nb);
    } else {
      load_rows(dst, W, K, nc * nb, kc * kb, nb, kb);
    }
  };

  __syncthreads();  // the staging buffers' previous readers are done
  load(0, stage);
  for (int i = 0; i < total; ++i) {
    const int nc = i / k_chunks;
    const int kc = i - nc * k_chunks;
    const bf16* cur = stage + (i & 1) * STAGE;
    cp_async_wait_all();
    __syncthreads();  // chunk i is visible; chunk i-1's buffer is free
    if (i + 1 < total) load(i + 1, stage + ((i + 1) & 1) * STAGE);
    if (!active) continue;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    }
    for (int t = 0; t < tk; ++t) {
      wmma::load_matrix_sync(fa, sA + kc * kb + t * 16, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < tn) {
          if (W_IS_KN) {
            wmma::load_matrix_sync(fb, cur + t * 16 * BLD + j * 16, BLD);
          } else {
            wmma::load_matrix_sync(fb, cur + j * 16 * BLD + t * 16, BLD);
          }
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    if (kc == k_chunks - 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < tn) {
          wmma::store_matrix_sync(s_acc, acc[j], 16, wmma::mem_row_major);
          __syncwarp();
          epi(s_acc, nc * nb + j * 16);
          __syncwarp();
        }
      }
    }
  }
}

// One warp: tok2 = x + tok[b] for the strip's 16 rows into s_n, then
// LayerNorm in place with fp32 centered statistics (two lanes per row, each
// taking alternate 8-channel groups). Returns the row's mean and 1/std in
// the lane pair that owns row lane / 2; n_out (device memory) gets a copy
// of the LN output when it is not null.
__device__ __forceinline__ void strip_layernorm(const bf16* __restrict__ x,
                                                const bf16* __restrict__ tok,
                                                const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b, long long row0,
                                                long long HW, int C, float eps, bf16* s_n,
                                                bf16* n_out, float* mean_out, float* inv_out) {
  const int lane = threadIdx.x & 31;
  const int vec_per_row = C / 8;
  for (int i = lane; i < ROWS * vec_per_row; i += 32) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * 8;
    const long long row = row0 + r;
    float fx[8], ft[8];
    unpack8(*reinterpret_cast<const uint4*>(x + row * C + c), fx);
    unpack8(*reinterpret_cast<const uint4*>(tok + (row / HW) * C + c), ft);
#pragma unroll
    for (int k = 0; k < 8; ++k) fx[k] += ft[k];
    *reinterpret_cast<uint4*>(s_n + r * C + c) = pack8(fx);
  }
  __syncwarp();
  const int r = lane >> 1;
  bf16* rowp = s_n + r * C;
  float s = 0.0f;
  for (int c = (lane & 1) * 8; c < C; c += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(rowp + c), f);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += f[k];
  }
  const float mean = (s + __shfl_xor_sync(0xffffffffu, s, 1)) / (float)C;
  float q = 0.0f;
  for (int c = (lane & 1) * 8; c < C; c += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(rowp + c), f);
#pragma unroll
    for (int k = 0; k < 8; ++k) q += (f[k] - mean) * (f[k] - mean);
  }
  const float inv = rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 1)) / (float)C + eps);
  for (int c = (lane & 1) * 8; c < C; c += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(rowp + c), f);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = (f[k] - mean) * inv * ln_w[c + k] + ln_b[c + k];
    const uint4 packed = pack8(f);
    *reinterpret_cast<uint4*>(rowp + c) = packed;
    if (n_out != nullptr) *reinterpret_cast<uint4*>(n_out + (row0 + r) * C + c) = packed;
  }
  __syncwarp();
  *mean_out = mean;
  *inv_out = inv;
}

__global__ void attn_tail_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int C = a.C;
  const long long row0 = ((long long)blockIdx.x * warps + warp) * ROWS;
  // a warp past the last row still joins every block barrier and chunk load
  const bool active = row0 < a.P;

  bf16* stage = reinterpret_cast<bf16*>(smem);
  unsigned char* base = smem + STAGE_BYTES + (size_t)warp * warp_smem_bytes(C);
  bf16* s_n = reinterpret_cast<bf16*>(base);
  bf16* s_h = s_n + ROWS * C;
  float* s_acc = reinterpret_cast<float*>(s_h + ROWS * 2 * C);

  if (active) {
    float mean, inv;
    strip_layernorm(a.x, a.tok, a.ln_w, a.ln_b, row0, a.HW, C, a.eps, s_n, nullptr, &mean,
                    &inv);
  }

  // hidden = gelu(n @ w1^T + b1); t2 = (hidden @ w2^T + b2) + tok2 over n;
  // out = (t2 @ wp^T + bp) + x
  strip_gemm<false>(a.w1, 2 * C, C, s_n, C, stage, s_acc, active,
                    [&](const float* acc, int nb) { epilogue<kFF1>(a, acc, nb, row0, s_n, s_h); });
  strip_gemm<false>(a.w2, C, 2 * C, s_h, 2 * C, stage, s_acc, active,
                    [&](const float* acc, int nb) { epilogue<kFF2>(a, acc, nb, row0, s_n, s_h); });
  strip_gemm<false>(a.wp, C, C, s_n, C, stage, s_acc, active,
                    [&](const float* acc, int nb) { epilogue<kProj>(a, acc, nb, row0, s_n, s_h); });
}

// ---------------------------------------------------------------------------
// Backward.

struct BwdArgs {
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
  // weight-gradient operands, (P, C) or (P, 2C) row-major
  bf16* n_out;
  bf16* h_out;
  bf16* t2_out;
  bf16* dt2_out;
  bf16* du_out;
  float* vec_part;  // (B, blocks per sample, NVEC * C)
  long long HW;
  int C;
  float eps;
};

// per-channel sums, offsets in units of C: dbp, db2, db1 (2C), dlnw, dlnb, dtok
enum VecSlot { kDbp = 0, kDb2 = 1, kDb1 = 2, kDlnw = 4, kDlnb = 5, kDtok = 6 };

__host__ __device__ inline size_t bwd_warp_smem_bytes(int C) {
  // n (then the warp's NVEC * C fp32 sums), u / du (2C), h (2C), t2 / dn,
  // dt2: 7C bf16 per row; a 16x16 fp32 tile
  return (size_t)ROWS * C * NVEC * 2 + ROWS * 16 * sizeof(float);
}
static_assert(NVEC * sizeof(float) <= ROWS * sizeof(bf16), "the sums must fit n's buffer");

__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  const float th = tanhf(k0 * (v + k1 * v * v * v));
  return 0.5f * (1.0f + th) + 0.5f * v * (1.0f - th * th) * k0 * (1.0f + 3.0f * k1 * v * v);
}

// One warp: add 8 per-lane values, summed over the strip's 16 rows, to
// dst[0..8) in the warp's own row of sums. Lanes of the same parity hold
// the same channels (row = lane / 2), so the row sum is a shuffle over the
// other lane bits; lanes 0 and 1 then add their groups, the only writers
// of those slots.
__device__ __forceinline__ void colsum8(float* dst, const float* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = v[i];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane < 2) dst[i] += s;
  }
}

__global__ void attn_tail_bwd_rows(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const int C = a.C;
  const long long local = ((long long)blockIdx.x * warps + warp) * ROWS;
  // a warp past its sample's last row still joins every block barrier
  const bool active = local < a.HW;
  const long long row0 = (long long)blockIdx.y * a.HW + local;

  bf16* stage = reinterpret_cast<bf16*>(smem);
  unsigned char* base = smem + STAGE_BYTES + (size_t)warp * bwd_warp_smem_bytes(C);
  bf16* s_n = reinterpret_cast<bf16*>(base);  // LN output n
  float* s_vec = reinterpret_cast<float*>(base);  // after FF1: the warp's sums
  bf16* s_u = s_n + ROWS * C;                 // FF1 output u, then du
  bf16* s_h = s_u + ROWS * 2 * C;             // gelu(u)
  bf16* s_t = s_h + ROWS * 2 * C;             // t2 = f + tok2, then dn
  bf16* s_d = s_t + ROWS * C;                 // dt2
  float* s_acc = reinterpret_cast<float*>(s_d + ROWS * C);

  float mean = 0.0f, inv = 0.0f;
  if (active) {
    strip_layernorm(a.x, a.tok, a.ln_w, a.ln_b, row0, a.HW, C, a.eps, s_n, a.n_out, &mean, &inv);
  }
  const int r = lane >> 1;
  const long long row = row0 + r;
  const int C2 = 2 * C;

  // recompute: u = n w1^T + b1, h = gelu(u); t2 = (h w2^T + b2) + tok2
  strip_gemm<false>(a.w1, C2, C, s_n, C, stage, s_acc, active, [&](const float* acc, int nb) {
    const int n = nb + (lane & 1) * 8;
    float v[8], h[8];
    tile8(acc, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = round_bf16(v[i] + a.b1[n + i]);
      h[i] = gelu_tanh(v[i]);
    }
    *reinterpret_cast<uint4*>(s_u + r * C2 + n) = pack8(v);
    const uint4 hp = pack8(h);
    *reinterpret_cast<uint4*>(s_h + r * C2 + n) = hp;
    *reinterpret_cast<uint4*>(a.h_out + row * C2 + n) = hp;
  });
  // n is read no more: its buffer holds the warp's sums from here on
  __syncwarp();
  for (int i = lane; i < NVEC * C; i += 32) s_vec[i] = 0.0f;
  __syncwarp();
  strip_gemm<false>(a.w2, C, C2, s_h, C2, stage, s_acc, active, [&](const float* acc, int nb) {
    const int n = nb + (lane & 1) * 8;
    float v[8], xr[8], tk[8];
    tile8(acc, v);
    unpack8(*reinterpret_cast<const uint4*>(a.x + row * C + n), xr);
    unpack8(*reinterpret_cast<const uint4*>(a.tok + blockIdx.y * C + n), tk);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i] + a.b2[n + i]) + round_bf16(xr[i] + tk[i]);
    const uint4 tp = pack8(v);
    *reinterpret_cast<uint4*>(s_t + r * C + n) = tp;
    *reinterpret_cast<uint4*>(a.t2_out + row * C + n) = tp;
  });

  // dt2 = g wp (the proj's data gradient; g is the strip's A operand, read
  // from device memory)
  strip_gemm<true>(a.wp, C, C, a.g + row0 * C, C, stage, s_acc, active,
                   [&](const float* acc, int nb) {
    const int n = nb + (lane & 1) * 8;
    float v[8];
    tile8(acc, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i]);
    const uint4 dp = pack8(v);
    *reinterpret_cast<uint4*>(s_d + r * C + n) = dp;
    *reinterpret_cast<uint4*>(a.dt2_out + row * C + n) = dp;
    colsum8(s_vec + kDb2 * C + n, v);
  });
  // du = (dt2 w2) * gelu'(u)
  strip_gemm<true>(a.w2, C2, C, s_d, C, stage, s_acc, active, [&](const float* acc, int nb) {
    const int n = nb + (lane & 1) * 8;
    float v[8], u[8];
    tile8(acc, v);
    unpack8(*reinterpret_cast<const uint4*>(s_u + r * C2 + n), u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(round_bf16(v[i]) * gelu_tanh_grad(u[i]));
    const uint4 dp = pack8(v);
    *reinterpret_cast<uint4*>(s_u + r * C2 + n) = dp;
    *reinterpret_cast<uint4*>(a.du_out + row * C2 + n) = dp;
    colsum8(s_vec + kDb1 * C + n, v);
  });
  // dn = du w1, over t2 (already in device memory)
  strip_gemm<true>(a.w1, C, C2, s_u, C2, stage, s_acc, active, [&](const float* acc, int nb) {
    const int n = nb + (lane & 1) * 8;
    float v[8];
    tile8(acc, v);
    *reinterpret_cast<uint4*>(s_t + r * C + n) = pack8(v);
  });

  if (active) {
    __syncwarp();
    // LayerNorm backward: dt = inv * (dxh - mean(dxh) - xh * mean(dxh * xh)),
    // dxh = dn * ln_w; then dtok2 = dt + dt2 and dx = g + dtok2
    float sa = 0.0f, sb = 0.0f;
    for (int c = (lane & 1) * 8; c < C; c += 16) {
      float xr[8], tk[8], dn[8];
      unpack8(*reinterpret_cast<const uint4*>(a.x + row * C + c), xr);
      unpack8(*reinterpret_cast<const uint4*>(a.tok + blockIdx.y * C + c), tk);
      unpack8(*reinterpret_cast<const uint4*>(s_t + r * C + c), dn);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (round_bf16(xr[k] + tk[k]) - mean) * inv;
        const float dxh = dn[k] * a.ln_w[c + k];
        sa += dxh;
        sb += dxh * xh;
      }
    }
    sa = (sa + __shfl_xor_sync(0xffffffffu, sa, 1)) / (float)C;
    sb = (sb + __shfl_xor_sync(0xffffffffu, sb, 1)) / (float)C;
    for (int c = (lane & 1) * 8; c < C; c += 16) {
      float xr[8], tk[8], dn[8], d2[8], gr[8], dxo[8], dtk[8], dw[8];
      unpack8(*reinterpret_cast<const uint4*>(a.x + row * C + c), xr);
      unpack8(*reinterpret_cast<const uint4*>(a.tok + blockIdx.y * C + c), tk);
      unpack8(*reinterpret_cast<const uint4*>(s_t + r * C + c), dn);
      unpack8(*reinterpret_cast<const uint4*>(s_d + r * C + c), d2);
      unpack8(*reinterpret_cast<const uint4*>(a.g + row * C + c), gr);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (round_bf16(xr[k] + tk[k]) - mean) * inv;
        const float dxh = dn[k] * a.ln_w[c + k];
        const float dt = inv * (dxh - sa - xh * sb);
        dtk[k] = round_bf16(round_bf16(dt) + d2[k]);
        dxo[k] = gr[k] + dtk[k];
        dw[k] = dn[k] * xh;
      }
      *reinterpret_cast<uint4*>(a.dx + row * C + c) = pack8(dxo);
      colsum8(s_vec + kDbp * C + c, gr);
      colsum8(s_vec + kDlnw * C + c, dw);
      colsum8(s_vec + kDlnb * C + c, dn);
      colsum8(s_vec + kDtok * C + c, dtk);
    }
  }
  __syncthreads();
  // the block's partial: its warps' rows added in warp order
  float* out = a.vec_part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NVEC * C;
  const size_t row_stride = bwd_warp_smem_bytes(C) / sizeof(float);
  const float* rows = reinterpret_cast<const float*>(smem + STAGE_BYTES);
  for (int i = threadIdx.x; i < NVEC * C; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += rows[w * row_stride + i];
    out[i] = s;
  }
}

// Fixed-order sum of the per-block partials, in two steps. Step 1, grid
// (ceil(7C / 32), B), 256 threads: 32 columns x 8 row lanes per block; lane
// r sums blocks r, r + 8, ... of sample b, then the 8 lane sums are added in
// order, into per_sample (B, 7C). Step 2: the first 6C columns summed over
// the samples in order (vec_out: dbp, db2, db1, dlnw, dlnb), the last C per
// sample (dtok, (B, C)).
constexpr int VEC_COLS = 32;
constexpr int VEC_LANES = 8;

__global__ void attn_tail_bwd_vec_samples(const float* __restrict__ part,
                                          float* __restrict__ per_sample, int blocks, int C) {
  __shared__ float red[VEC_LANES][VEC_COLS];
  const int width = NVEC * C;
  const int b = blockIdx.y;
  const int col = blockIdx.x * VEC_COLS + (threadIdx.x % VEC_COLS);
  const int lane = threadIdx.x / VEC_COLS;
  float s = 0.0f;
  if (col < width) {
    for (int k = lane; k < blocks; k += VEC_LANES) s += part[((size_t)b * blocks + k) * width + col];
  }
  red[lane][threadIdx.x % VEC_COLS] = s;
  __syncthreads();
  if (lane == 0 && col < width) {
    float acc = 0.0f;
    for (int r = 0; r < VEC_LANES; ++r) acc += red[r][threadIdx.x % VEC_COLS];
    per_sample[(size_t)b * width + col] = acc;
  }
}

__global__ void attn_tail_bwd_vec(const float* __restrict__ per_sample,
                                  float* __restrict__ vec_out, float* __restrict__ dtok, int B,
                                  int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int width = NVEC * C;
  if (i >= width) return;
  if (i < kDtok * C) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += per_sample[(size_t)b * width + i];
    vec_out[i] = s;
  } else {
    for (int b = 0; b < B; ++b) dtok[(size_t)b * C + i - kDtok * C] = per_sample[(size_t)b * width + i];
  }
}

constexpr int WG_TILE = 64;           // output tile edge of the weight-gradient product
constexpr int WG_LD = WG_TILE + 8;    // staged row stride, elements (padded)

// part[s] = A[p0:p1]^T B[p0:p1] for split s: A (P, M), B (P, N) bf16
// row-major, M and N multiples of 16; a block of 4 warps makes one 64 x 64
// output tile, warp w its rows [16 w, 16 w + 16).
__global__ void __launch_bounds__(128) wgrad_partial(const bf16* __restrict__ A,
                                                     const bf16* __restrict__ Bm,
                                                     float* __restrict__ part, long long P,
                                                     int M, int N, long long rows_per_split) {
  __shared__ __align__(128) bf16 sA[WG_TILE * WG_LD];
  __shared__ __align__(128) bf16 sB[WG_TILE * WG_LD];
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * WG_TILE;
  const int n0 = blockIdx.y * WG_TILE;
  const int tm = min(WG_TILE, M - m0);
  const int tn = min(WG_TILE, N - n0);
  const long long p0 = (long long)blockIdx.z * rows_per_split;
  const long long p1 = min(P, p0 + rows_per_split);
  const bool active = warp * 16 < tm;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (long long p = p0; p < p1; p += WG_TILE) {
    const int kb = (int)min((long long)WG_TILE, p1 - p);  // a multiple of 16
    __syncthreads();  // the previous step's readers are done
    const int va = tm / 8, vb = tn / 8;
    for (int i = threadIdx.x; i < kb * va; i += blockDim.x) {
      const int rr = i / va, v = i - rr * va;
      cp_async16(sA + rr * WG_LD + v * 8, A + (size_t)(p + rr) * M + m0 + v * 8);
    }
    for (int i = threadIdx.x; i < kb * vb; i += blockDim.x) {
      const int rr = i / vb, v = i - rr * vb;
      cp_async16(sB + rr * WG_LD + v * 8, Bm + (size_t)(p + rr) * N + n0 + v * 8);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < kb / 16; ++t) {
      // A^T tile: element (m, k) at sA[k * WG_LD + m], a column-major operand
      wmma::load_matrix_sync(fa, sA + t * 16 * WG_LD + warp * 16, WG_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 16 < tn) {
          wmma::load_matrix_sync(fb, sB + t * 16 * WG_LD + j * 16, WG_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j * 16 < tn) {
      float* dst = part + ((size_t)blockIdx.z * M + m0 + warp * 16) * N + n0 + j * 16;
      wmma::store_matrix_sync(dst, acc[j], N, wmma::mem_row_major);
    }
  }
}

cudaError_t weight_grad(const bf16* A, const bf16* Bm, float* part, float* out, long long P,
                        int M, int N, int splits, long long rows_per_split, cudaStream_t st) {
  const dim3 grid((M + WG_TILE - 1) / WG_TILE, (N + WG_TILE - 1) / WG_TILE, splits);
  wgrad_partial<<<grid, 128, 0, st>>>(A, Bm, part, P, M, N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = (long long)M * N;
  const int blocks = mn >= 1024 * 256 ? 1024 : (int)((mn + 255) / 256);
  sum_splits<<<blocks, 256, 0, st>>>(part, out, splits, mn);
  return cudaGetLastError();
}

}  // namespace

// Warp strips per block for channel width C: as many as shared memory holds, at most 8.
static int warps_per_block(int C) {
  int w = (int)((SMEM_BUDGET - STAGE_BYTES) / warp_smem_bytes(C));
  if (w > 8) w = 8;
  return w < 1 ? 1 : w;
}

// x, out: (P, C) bf16 row-major; tok: (B, C) bf16; ln_w, ln_b: (C,) fp32;
// w1: (2C, C) bf16; b1: (2C,) fp32; w2: (C, 2C) bf16; b2: (C,) fp32;
// wp: (C, C) bf16; bp: (C,) fp32 — weights in PyTorch (out, in) layout.
// P % 16 == 0, C % 16 == 0.
ND_EXPORT int nd_attn_tail(const void* x, const void* tok, const void* ln_w, const void* ln_b,
                           const void* w1, const void* b1, const void* w2, const void* b2,
                           const void* wp, const void* bp, void* out, long long P,
                           long long HW, int C, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = warps_per_block(C);
  const size_t smem = STAGE_BYTES + warps * warp_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(attn_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<const bf16*>(tok);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.out = static_cast<bf16*>(out);
  a.P = P;
  a.HW = HW;
  a.C = C;
  a.eps = eps;
  const long long strips = P / ROWS;
  const long long blocks = (strips + warps - 1) / warps;
  attn_tail_kernel<<<(unsigned)blocks, warps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Warp strips per block of the backward row kernel for channel width C.
ND_EXPORT int nd_attn_tail_bwd_warps(int C) {
  int w = (int)((SMEM_BUDGET - STAGE_BYTES) / bwd_warp_smem_bytes(C));
  if (w > 8) w = 8;
  return w < 1 ? 1 : w;
}

// Backward of nd_attn_tail for upstream gradient g (P, C) bf16, P = B * HW,
// HW % 16 == 0, C % 16 == 0. Outputs: dx (P, C) bf16; vec_out (6C,) fp32 =
// [dbp, db2, db1 (2C), dlnw, dlnb]; dtok (B, C) fp32; dw1 (2C, C), dw2
// (C, 2C), dwp (C, C) fp32 in PyTorch layout. Scratch: ops (P * 7C bf16),
// vec_part (B * blocks_per_sample * 7C fp32), wpart (max(splits * 2C * C,
// B * 7C) fp32).
ND_EXPORT int nd_attn_tail_bwd(const void* x, const void* tok, const void* g, const void* ln_w,
                               const void* ln_b, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* wp, void* dx, void* vec_out,
                               void* dtok, void* dw1, void* dw2, void* dwp, void* ops,
                               void* vec_part, void* wpart, int B, long long HW, int C,
                               int blocks_per_sample, int splits, long long rows_per_split,
                               float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = nd_attn_tail_bwd_warps(C);
  const size_t smem = STAGE_BYTES + warps * bwd_warp_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(attn_tail_bwd_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long P = (long long)B * HW;
  bf16* o = static_cast<bf16*>(ops);
  BwdArgs a;
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
  a.n_out = o;
  a.h_out = o + P * C;
  a.t2_out = o + P * 3 * C;
  a.dt2_out = o + P * 4 * C;
  a.du_out = o + P * 5 * C;
  a.vec_part = static_cast<float*>(vec_part);
  a.HW = HW;
  a.C = C;
  a.eps = eps;
  attn_tail_bwd_rows<<<dim3(blocks_per_sample, B), warps * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // per-sample sums go to the weight-gradient scratch, free until the
  // products below
  float* part = static_cast<float*>(wpart);
  attn_tail_bwd_vec_samples<<<dim3((NVEC * C + VEC_COLS - 1) / VEC_COLS, B),
                              VEC_COLS * VEC_LANES, 0, st>>>(
      static_cast<const float*>(vec_part), part, blocks_per_sample, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_tail_bwd_vec<<<(NVEC * C + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(vec_out), static_cast<float*>(dtok), B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bf16* gg = static_cast<const bf16*>(g);
  // dwp = g^T t2; dw2 = dt2^T h; dw1 = du^T n
  err = weight_grad(gg, a.t2_out, part, static_cast<float*>(dwp), P, C, C, splits,
                    rows_per_split, st);
  if (err != cudaSuccess) return (int)err;
  err = weight_grad(a.dt2_out, a.h_out, part, static_cast<float*>(dw2), P, C, 2 * C, splits,
                    rows_per_split, st);
  if (err != cudaSuccess) return (int)err;
  err = weight_grad(a.du_out, a.n_out, part, static_cast<float*>(dw1), P, 2 * C, C, splits,
                    rows_per_split, st);
  return (int)err;
}
