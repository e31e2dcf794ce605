// AttnBlock tail for a single-token context, forward, bf16:
//     tok2 = x + tok[b]
//     out  = proj(FF(LN2(tok2)) + tok2) + x
// LN over C with fp32 statistics; FF = Linear(C -> 2C) -> GELU (tanh) ->
// Linear(2C -> C); proj a 1x1 C -> C conv. x is a row-major (pixels, C)
// matrix; a row's sample is row / (H * W).
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/attn_tail.py (_forward,
// _kernel, _tile_chain; public fused_attn_tail). The TPU version feeds the
// array (H, W, B, C)-transposed and folds width into lanes; both are TPU
// layout devices and are not carried over.
//
// Bound on this card: 10 C^2 FLOP per pixel against 4 C bytes moved, so the
// full-resolution stages (C = 48, 96) are bound by memory (s0 moves 201 MB,
// 60 us) and the deep ones (C = 192, 384) by the tensor cores (24.2 GFLOP
// per call at every stage, 24 us at 989 TFLOP/s).
//
// Design:
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
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 16;             // rows per warp strip (one WMMA tile high)
constexpr int CHUNK = 64;            // most outputs / inputs of one staged weight chunk
constexpr int BLD = CHUNK + 8;       // staged chunk row stride, elements (padded)
constexpr int STAGE = CHUNK * BLD;   // elements per staging buffer
constexpr size_t STAGE_BYTES = 2 * STAGE * sizeof(bf16);  // two buffers
constexpr size_t SMEM_BUDGET = 225 * 1024;

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

// Whole block: stage W[n0 : n0+nb, k0 : k0+kb] (W is (N, K) row-major).
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ W, int K, int n0,
                                           int k0, int nb, int kb) {
  const int vec_per_row = kb / 8;
  for (int i = threadIdx.x; i < nb * vec_per_row; i += blockDim.x) {
    const int n = i / vec_per_row;
    const int v = i - n * vec_per_row;
    cp_async16(dst + n * BLD + v * 8, W + (size_t)(n0 + n) * K + k0 + v * 8);
  }
  cp_async_commit();
}

// One warp: the epilogue of a finished 16x16 accumulator tile (in s_acc),
// columns [n_base, n_base + 16) of the product. Lane l takes row l / 2 and
// 8 channels.
template <int MODE>
__device__ __forceinline__ void epilogue(const Args& a, const float* s_acc, int n_base,
                                         long long row0, bf16* s_n, bf16* s_h) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int n = n_base + (lane & 1) * 8;
  const int C = a.C;
  float v[8];
  const float4 lo = *reinterpret_cast<const float4*>(s_acc + r * 16 + (lane & 1) * 8);
  const float4 hi = *reinterpret_cast<const float4*>(s_acc + r * 16 + (lane & 1) * 8 + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
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
// dimension lda) by W^T (W is (N, K)), chunk by chunk through the staging
// buffers, and runs the epilogue on each finished 16x16 tile.
template <int MODE>
__device__ void strip_gemm(const Args& a, const bf16* __restrict__ W, int N, int K,
                           const bf16* sA, int lda, bf16* stage, float* s_acc, long long row0,
                           bool active, bf16* s_n, bf16* s_h) {
  const int tn = tiles_per_chunk(N / 16);
  const int tk = tiles_per_chunk(K / 16);
  const int nb = tn * 16, kb = tk * 16;
  const int k_chunks = K / kb;
  const int total = (N / nb) * k_chunks;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;

  __syncthreads();  // the staging buffers' previous readers are done
  load_chunk(stage, W, K, 0, 0, nb, kb);
  for (int i = 0; i < total; ++i) {
    const int nc = i / k_chunks;
    const int kc = i - nc * k_chunks;
    const bf16* cur = stage + (i & 1) * STAGE;
    cp_async_wait_all();
    __syncthreads();  // chunk i is visible; chunk i-1's buffer is free
    if (i + 1 < total) {
      const int nn = (i + 1) / k_chunks;
      load_chunk(stage + ((i + 1) & 1) * STAGE, W, K, nn * nb, ((i + 1) - nn * k_chunks) * kb,
                 nb, kb);
    }
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
          wmma::load_matrix_sync(fb, cur + j * 16 * BLD + t * 16, BLD);
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
          epilogue<MODE>(a, s_acc, nc * nb + j * 16, row0, s_n, s_h);
          __syncwarp();
        }
      }
    }
  }
}

__global__ void attn_tail_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
    // tok2 = x + tok[b] into s_n, 8 channels per access
    const int vec_per_row = C / 8;
    for (int i = lane; i < ROWS * vec_per_row; i += 32) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * 8;
      const long long row = row0 + r;
      float fx[8], ft[8];
      unpack8(*reinterpret_cast<const uint4*>(a.x + row * C + c), fx);
      unpack8(*reinterpret_cast<const uint4*>(a.tok + (row / a.HW) * C + c), ft);
#pragma unroll
      for (int k = 0; k < 8; ++k) fx[k] += ft[k];
      *reinterpret_cast<uint4*>(s_n + r * C + c) = pack8(fx);
    }
    __syncwarp();
    // LayerNorm in place, fp32 centered statistics: two lanes per row, each
    // taking alternate 8-channel groups
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
    const float inv = rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 1)) / (float)C + a.eps);
    for (int c = (lane & 1) * 8; c < C; c += 16) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(rowp + c), f);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = (f[k] - mean) * inv * a.ln_w[c + k] + a.ln_b[c + k];
      *reinterpret_cast<uint4*>(rowp + c) = pack8(f);
    }
    __syncwarp();
  }

  // hidden = gelu(n @ w1^T + b1); t2 = (hidden @ w2^T + b2) + tok2 over n;
  // out = (t2 @ wp^T + bp) + x
  strip_gemm<kFF1>(a, a.w1, 2 * C, C, s_n, C, stage, s_acc, row0, active, s_n, s_h);
  strip_gemm<kFF2>(a, a.w2, C, 2 * C, s_h, 2 * C, stage, s_acc, row0, active, s_n, s_h);
  strip_gemm<kProj>(a, a.wp, C, C, s_n, C, stage, s_acc, row0, active, s_n, s_h);
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
