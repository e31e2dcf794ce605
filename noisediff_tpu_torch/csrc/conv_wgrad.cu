// Weight gradient of a stride-1 SAME convolution, bf16 in, fp32 out:
//     dW[ih, iw, ci, co] = sum_{b,h,w} x[b, h+ih-ph, w+iw-pw, ci] g[b, h, w, co]
// with zeros outside the image, (ph, pw) = ((kh - 1) / 2, (kw - 1) / 2),
// kh, kw in {1, 3}; x (B, H, W, Ci) and g (B, H, W, Co) channels-last.
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/conv_wgrad.py
// (_kernel / conv_wgrad), which streams row blocks through a sequential
// grid and carries the previous block's last row in VMEM for the taps that
// cross a block boundary. Its width fold (kwf = 2) is a TPU layout device
// and is not carried over.
//
// Bound on this card: kh kw Ci Co 2 FLOP per pixel against (Ci + Co) 2
// bytes. A 3x3 48 -> 48 conv at 512^2 x 4 reads 201 MB (60 us) and does
// 43.5 GFLOP (44 us): bytes bind, narrowly. A 3x3 384 -> 384 conv at 64^2
// reads 12.6 MB for the same 43.5 GFLOP: the tensor cores bind.
//
// Design. A GPU grid has no sequential carry, so:
//   * the pixels are cut into tiles of 2 image rows x up to 64 columns; a
//     block takes a contiguous run of tiles (a split) and keeps its sums in
//     registers across them. Its x tile carries a halo of (kh - 1) / 2 rows
//     and (kw - 1) / 2 columns on each side, zero outside the image, so no
//     row has to be carried between blocks;
//   * the channels are cut into tiles of up to 48 (3 WMMA tiles of 16) for
//     ci and for co, and blocks of the grid's second dimension take one
//     (ci tile, co tile) pair each, so a block's partial is at most
//     9 x 48 x 48 fp32 (83 KB) however wide the conv (one whole 3x3 x 384 x
//     384 partial would be 5.3 MB). Every channel count of NoiseDiffNet is
//     a multiple of 48;
//   * the tap products run on the tensor cores as WMMA 16x16x16 bf16 tiles
//     with fp32 accumulators. The pixels are the reduction dimension: for a
//     tap, A^T is the x tile shifted by the tap (a column-major view of the
//     channels-last rows in shared memory) and B the g tile. The 9 warps
//     split the (tap, ci WMMA tile) pairs; each warp loads a g fragment once
//     per 16 pixels and reuses it for all its taps. Where there are fewer
//     pairs than warps (1x1 convs) the warps also split the pixels, each
//     group writing its own partial;
//   * the x and g tiles of the next pixel tile load with cp.async into the
//     second of two shared-memory stages while the tensor cores work on
//     this one;
//   * each block writes its partial once; a second pass (sum_splits,
//     common.cuh) adds the partials of all splits in a fixed order. No sum
//     uses atomics, so the result is deterministic.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 2;     // image rows of a pixel tile
constexpr int COLS = 64;    // most image columns of a pixel tile
constexpr int TILE = 48;    // most channels of a ci or co tile
constexpr int WARPS = 9;
constexpr int THREADS = WARPS * 32;

struct Args {
  const bf16* x;
  const bf16* g;
  float* part;
  int H, W, Ci, Co;
  int MT, NT;       // WMMA tiles per ci tile and per co tile (1, 2 or 3)
  int cols;         // columns of a pixel tile, a multiple of 16, <= COLS
  int col_tiles;    // pixel tiles across the width
  int bands;        // pixel tiles down the height
  long long tiles;  // pixel tiles in all: B * bands * col_tiles
  long long tiles_per_split;
  int co_tiles;     // co tiles; blockIdx.y = ci tile * co_tiles + co tile
};

// Warp groups: UG warps split the (tap, ci WMMA tile) units, UPW units each;
// PG groups of them split the pixels (partials per split: PG).
__host__ __device__ inline void warp_groups(int taps, int MT, int* UG, int* UPW, int* PG) {
  const int U = taps * MT;
  *UG = U >= WARPS ? WARPS : U;
  *UPW = U >= WARPS ? U / WARPS : 1;
  *PG = WARPS / *UG;
}

template <int KH, int KW>
__host__ __device__ constexpr int stage_elems() {
  return (ROWS + KH - 1) * (COLS + KW - 1) * TILE + ROWS * COLS * TILE;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Whole block: start the copy of pixel tile t into one stage (x tile with
// its halo, then the g tile), zeros outside the image.
template <int KH, int KW>
__device__ void load_tile(const Args& a, long long t, int ci0, int co0, bf16* xs, bf16* gs) {
  constexpr int PH = (KH - 1) / 2, PW = (KW - 1) / 2;
  const int ct = (int)(t % a.col_tiles);
  const int band = (int)((t / a.col_tiles) % a.bands);
  const long long b = t / ((long long)a.col_tiles * a.bands);
  const int h0 = band * ROWS, w0 = ct * a.cols;
  const int TC = 16 * a.MT, TO = 16 * a.NT;
  const int xcols = a.cols + KW - 1;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const int xv = TC / 8;
  const int nx = (ROWS + KH - 1) * xcols * xv;
  for (int i = threadIdx.x; i < nx; i += THREADS) {
    const int v = i % xv;
    const int pix = i / xv;
    const int cc = pix % xcols, rr = pix / xcols;
    const int hh = h0 - PH + rr, ww = w0 - PW + cc;
    bf16* dst = xs + (size_t)pix * TC + v * 8;
    if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W) {
      cp_async16(dst, a.x + ((b * a.H + hh) * a.W + ww) * a.Ci + ci0 + v * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = zero;
    }
  }
  const int gv = TO / 8;
  const int ng = ROWS * a.cols * gv;
  for (int i = threadIdx.x; i < ng; i += THREADS) {
    const int v = i % gv;
    const int pix = i / gv;
    const int c = pix % a.cols, r = pix / a.cols;
    const int hh = h0 + r, ww = w0 + c;
    bf16* dst = gs + (size_t)pix * TO + v * 8;
    if (hh < a.H && ww < a.W) {
      cp_async16(dst, a.g + ((b * a.H + hh) * a.W + ww) * a.Co + co0 + v * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = zero;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int KH, int KW>
__global__ void __launch_bounds__(THREADS) conv_wgrad_partial(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int TAPS = KH * KW;
  constexpr int STAGE = stage_elems<KH, KW>();
  constexpr int X_ELEMS = (ROWS + KH - 1) * (COLS + KW - 1) * TILE;

  const int warp = threadIdx.x / 32;
  const int cit = blockIdx.y / a.co_tiles, cot = blockIdx.y % a.co_tiles;
  const int TC = 16 * a.MT, TO = 16 * a.NT;
  const int ci0 = cit * TC, co0 = cot * TO;
  int UG, UPW, PG;
  warp_groups(TAPS, a.MT, &UG, &UPW, &PG);
  const int ug = warp % UG, pg = warp / UG;
  const bool computes = pg < PG;
  const int xcols = a.cols + KW - 1;
  const int csteps = a.cols / 16;
  const int ksteps = ROWS * csteps;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][3];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int n = 0; n < 3; ++n) wmma::fill_fragment(acc[i][n], 0.0f);
  }

  const long long t0 = (long long)blockIdx.x * a.tiles_per_split;
  const long long t1 = min(a.tiles, t0 + a.tiles_per_split);
  if (t0 < t1) load_tile<KH, KW>(a, t0, ci0, co0, smem, smem + X_ELEMS);
  for (long long t = t0; t < t1; ++t) {
    const int s = (int)((t - t0) & 1);
    if (t + 1 < t1) {
      bf16* next = smem + (1 - s) * STAGE;
      load_tile<KH, KW>(a, t + 1, ci0, co0, next, next + X_ELEMS);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const bf16* xs = smem + s * STAGE;
    const bf16* gs = xs + X_ELEMS;
    if (computes) {
      for (int k = pg; k < ksteps; k += PG) {
        const int r = k / csteps, c = (k % csteps) * 16;
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          if (n < a.NT) wmma::load_matrix_sync(fb[n], gs + (r * a.cols + c) * TO + n * 16, TO);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i < UPW) {
            const int u = ug + i * UG;
            const int tap = u / a.MT, mi = u % a.MT;
            const int ih = tap / KW, iw = tap % KW;
            // A^T: (channel m, pixel k) at xs[pixel k of the shifted row][m]
            wmma::load_matrix_sync(fa, xs + ((r + ih) * xcols + c + iw) * TC + mi * 16, TC);
#pragma unroll
            for (int n = 0; n < 3; ++n) {
              if (n < a.NT) wmma::mma_sync(acc[i][n], fa, fb[n], acc[i][n]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  if (!computes) return;
  const size_t tap_elems = (size_t)a.Ci * a.Co;
  float* dst0 = a.part + ((size_t)blockIdx.x * PG + pg) * TAPS * tap_elems;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i < UPW) {
      const int u = ug + i * UG;
      const int tap = u / a.MT, mi = u % a.MT;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if (n < a.NT) {
          float* dst = dst0 + tap * tap_elems + (size_t)(ci0 + mi * 16) * a.Co + co0 + n * 16;
          wmma::store_matrix_sync(dst, acc[i][n], a.Co, wmma::mem_row_major);
        }
      }
    }
  }
}

template <int KH, int KW>
cudaError_t launch(const Args& a, int splits, int ci_tiles, cudaStream_t st) {
  const size_t smem = 2 * stage_elems<KH, KW>() * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(conv_wgrad_partial<KH, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_wgrad_partial<KH, KW><<<dim3(splits, ci_tiles * a.co_tiles), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Partials each split writes (warp groups that split the pixels).
ND_EXPORT int nd_conv_wgrad_partials_per_split(int kh, int kw, int MT) {
  int UG, UPW, PG;
  warp_groups(kh * kw, MT, &UG, &UPW, &PG);
  return PG;
}

// x: (B, H, W, Ci), g: (B, H, W, Co) bf16 contiguous; out: (kh, kw, Ci, Co)
// fp32. kh, kw in {1, 3}; Ci % (16 MT) == 0, Co % (16 NT) == 0, MT, NT in
// {1, 2, 3}; cols a multiple of 16, at most 64; the pixel tiles (B x
// ceil(H / 2) x ceil(W / cols)) are cut into `splits` runs of
// tiles_per_split. part: splits * partials_per_split * kh * kw * Ci * Co
// fp32 scratch.
ND_EXPORT int nd_conv_wgrad(const void* x, const void* g, void* part, void* out, int B, int H,
                            int W, int Ci, int Co, int kh, int kw, int MT, int NT, int cols,
                            int splits, long long tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MT < 1 || MT > 3 || NT < 1 || NT > 3 || Ci % (16 * MT) || Co % (16 * NT) ||
      cols % 16 || cols < 16 || cols > COLS) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const bf16*>(g);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.MT = MT;
  a.NT = NT;
  a.cols = cols;
  a.col_tiles = (W + cols - 1) / cols;
  a.bands = (H + ROWS - 1) / ROWS;
  a.tiles = (long long)B * a.bands * a.col_tiles;
  a.tiles_per_split = tiles_per_split;
  a.co_tiles = Co / (16 * NT);
  const int ci_tiles = Ci / (16 * MT);
  cudaError_t err;
  if (kh == 3 && kw == 3) {
    err = launch<3, 3>(a, splits, ci_tiles, st);
  } else if (kh == 1 && kw == 1) {
    err = launch<1, 1>(a, splits, ci_tiles, st);
  } else if (kh == 3 && kw == 1) {
    err = launch<3, 1>(a, splits, ci_tiles, st);
  } else if (kh == 1 && kw == 3) {
    err = launch<1, 3>(a, splits, ci_tiles, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)kh * kw * Ci * Co;
  const int parts = splits * nd_conv_wgrad_partials_per_split(kh, kw, MT);
  const int blocks = n >= 1024 * 256 ? 1024 : (int)((n + 255) / 256);
  sum_splits<<<blocks, 256, 0, st>>>(a.part, static_cast<float*>(out), parts, n);
  return (int)cudaGetLastError();
}
