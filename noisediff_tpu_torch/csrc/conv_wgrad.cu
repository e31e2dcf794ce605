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
// What held the first design back (13-22x its bound, 2.95x cuDNN per
// training step): one 9-warp block per SM waiting on two cp.async stages,
// 2-row pixel tiles whose 4-row halo read x twice, integer divisions per
// 16-byte chunk of the halo loads, WMMA fragments reloaded with 2-way bank
// conflicts, and up to 4x the operands' bytes in split partials.
//
// Design. Per tap the weight gradient is a GEMM whose reduction runs over
// the pixels: dW_tap (Ci x Co) = X_tap^T (Ci x P) G (P x Co).
//   * Operands by TMA. One producer warp issues cp.async.bulk.tensor loads
//     from 4-D tensor maps over x and g (built on the host per call) into a
//     ring of shared-memory stages guarded by mbarriers; nine consumer
//     warps wait on a stage's `full` barrier and release it on its `empty`
//     one. A pixel tile is R image rows x WT columns (8 x 32 for 3x3, three
//     stages of 65 KB); its x box carries the (kh - 1) / 2, (kw - 1) / 2
//     halo at negative or past-the-edge coordinates, which TMA fills with
//     zeros: the SAME padding and the ragged image edge cost no index
//     arithmetic, and the halo reads x 1.33x from L2 instead of 2x. The
//     boxes of a conv with taps are 56 channels wide (a 48-channel tile and 8 more,
//     zero past the tensor's last channel), so a pixel's row is 112 bytes
//     and the 8 rows an ldmatrix reads fall in 8 distinct bank groups; a
//     1x1 conv's are the 48-channel tile alone (see Geo::CBOX).
//   * Tensor cores through mma.sync m16n8k16 (bf16, fp32 accumulators),
//     operands by ldmatrix.trans straight from the channels-last rows: A =
//     the x tile shifted by the tap (each lane gives its own row address, so
//     a one-pixel shift costs nothing), B = the g tile. A block owns one
//     (ci tile, co tile) pair at a time and always multiplies 48 x 48 (a
//     pair's tiles are 48 wide at every NoiseDiffNet width; narrower ones
//     compute the box's next channels too and drop them), so the k-loop has
//     no branch and the next k-step's fragments load while this one's 18
//     products run. Consumer warp w keeps the 72 accumulators of tap w
//     (3x3), or of tap w % taps over the k-steps = w / taps mod 9 / taps
//     (1x1, 3x1, 1x3: the pixel groups meet in shared memory at a
//     segment's end and are summed in order). wgmma is not used: its
//     shared-memory descriptors cannot start a one-pixel tap shift inside a
//     swizzle atom, and the 48-channel shapes that dominate a training step
//     are bound by bytes, not by products.
//   * Persistent, balanced split over the pixels. The grid is one block
//     per SM. The (pair, pixel tile) units are numbered pair-major and
//     block b takes units [U b / G, U (b + 1) / G): every block gets the
//     same work whatever the pair count, and a block that crosses a pair
//     boundary writes one partial per pair it touched (slot b + pair, which
//     no other segment uses; a tile per tap). conv_wgrad_reduce sums, per
//     output element, the slots of the blocks that touched its pair in
//     block order: no atomics, the same bits every call. The partials are
//     (G + pairs) x taps x 48 x 48 fp32: 11 MB for 3x3 48 -> 48 (operands
//     201 MB), 16 MB at 384 -> 384 x 64^2 (operands 12.6 MB, the one place
//     they exceed them; they stay in the 50 MB L2).
//   * The host plan (units, tiles, grid, slots) is
//     ops/kernels/conv_wgrad.plan; the entry point checks its numbers
//     against this file's tile constants.
// ptxas (CUDA 12.9, sm_90a): 3x3 161 registers, 1x1 121, 3x1 145, 1x3 149,
// no spills; one 320-thread block per SM; shared memory 200,496 bytes
// (3x3) and 212,032 (1x1, with the pixel groups' 82,944). What binds now:
// at 3x3 the consumers, mma.sync fed by ldmatrix at 3 products per
// ldmatrix.x4 (~340 TFLOP/s), with the loads close behind (TMA moves
// 112-byte box rows more slowly than 96- or 128-byte ones; a 64-channel
// box with the 128-byte swizzle loaded faster, but its swizzled addresses
// slowed the products more than it saved); at 1x1 the loads.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry point

#include "common.cuh"

namespace {

constexpr int CONSUMERS = 9;                     // consumer warps
constexpr int THREADS = (CONSUMERS + 1) * 32;    // and one producer warp
constexpr int TILE = 48;                         // channels of a ci or co tile's products
constexpr int PART_TILE = TILE * TILE;           // floats of one tap's partial tile

// Pixel tile of R image rows x WT columns; the x box adds the halo.
template <int KH, int KW>
struct Geo {
  static constexpr int TAPS = KH * KW;
  static constexpr int NPG = CONSUMERS / TAPS;  // pixel groups per tap
  static constexpr int R = TAPS == 9 ? 8 : 3;
  static constexpr int WT = TAPS == 1 ? 48 : 32;
  static constexpr int STAGES = TAPS == 9 ? 3 : 4;
  static constexpr int XH = R + KH - 1, XW = WT + KW - 1;
  // channels of a TMA box: with taps, 8 past the tile, so a pixel's row is
  // 112 bytes and ldmatrix reads no two rows from one bank group; a 1x1
  // conv, bound by its loads, takes the tile alone (96-byte rows, which
  // TMA moves faster, at two-way bank conflicts)
  static constexpr int CBOX = TAPS == 1 ? TILE : TILE + 8;
  static constexpr int KSTEPS = R * WT / 16;    // 16-pixel k-steps per tile
  static constexpr int NJ = KSTEPS / NPG;       // k-steps per tile and warp
  static constexpr int X_BYTES = CBOX * XW * XH * 2;
  static constexpr int G_BYTES = CBOX * WT * R * 2;
  static constexpr int X_REGION = (X_BYTES + 127) / 128 * 128;
  static constexpr int STAGE = X_REGION + G_BYTES;
  // the pixel groups' tiles meet in shared memory at a segment's end
  static constexpr int RED_BYTES = NPG > 1 ? CONSUMERS * PART_TILE * 4 : 0;
  static constexpr int SMEM = STAGES * STAGE + RED_BYTES + 2 * STAGES * 8;
  static_assert(KSTEPS % NPG == 0, "pixel groups must split the k-steps evenly");
  static_assert(G_BYTES % 128 == 0, "stages stay 128-byte aligned");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

struct Plan {
  float* part;
  long long units;  // (pair, pixel tile) units in all
  int tpp;          // pixel tiles per (ci tile, co tile) pair
  int ctiles;       // pixel tiles across the width
  int bands;        // pixel tiles down the height
  int co_tiles;
  int MT, NT;       // 16-channel sub-tiles of a ci tile and of a co tile (1, 2 or 3)
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
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The consumer warps only (barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory");
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are (channel, column, row, image), innermost
// first; outside the tensor the box is zero.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block that owns unit u when U units are cut into G runs
// [U b / G, U (b + 1) / G): the largest b with U b / G <= u.
__device__ __forceinline__ long long block_of(long long u, long long U, long long G) {
  return ((u + 1) * G - 1) / U;
}

// One warp's operands of one 16-pixel k-step (image row r of the tile,
// columns c0 .. c0 + 15): the x rows shifted by the warp's tap (a_lane) and
// the g rows (b_lane), 48 channels each.
template <int KH, int KW>
__device__ __forceinline__ void load_frags(uint32_t st, int kk, uint32_t a_lane,
                                           uint32_t b_lane, uint32_t (&fa)[3][4],
                                           uint32_t (&fb)[3][4]) {
  using Gm = Geo<KH, KW>;
  const int r = kk / (Gm::WT / 16), c0 = (kk % (Gm::WT / 16)) * 16;
#pragma unroll
  for (int np = 0; np < 3; ++np) {
    ldsm_x4_t(fb[np], st + b_lane + ((r * Gm::WT + c0) * Gm::CBOX + 16 * np) * 2);
  }
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
    ldsm_x4_t(fa[mi], st + a_lane + ((r * Gm::XW + c0) * Gm::CBOX + 16 * mi) * 2);
  }
}

template <int KH, int KW>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wgrad_partial(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmg, const Plan p) {
  using Gm = Geo<KH, KW>;
  constexpr int STAGES = Gm::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + STAGES * Gm::STAGE);
  const uint32_t full0 = base + STAGES * Gm::STAGE + Gm::RED_BYTES;  // `full` barriers
  const uint32_t empty0 = full0 + STAGES * 8;                        // then `empty`
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long G = gridDim.x, blk = blockIdx.x;
  const long long u0 = p.units * blk / G, u1 = p.units * (blk + 1) / G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      constexpr int PH = (KH - 1) / 2, PW = (KW - 1) / 2;
      int s = 0;
      uint32_t ph = 0;
      for (long long u = u0; u < u1; ++u) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const int pair = (int)(u / p.tpp);
        int t = (int)(u - (long long)pair * p.tpp);
        const int ct = t % p.ctiles;
        t /= p.ctiles;
        const int band = t % p.bands, img = t / p.bands;
        const int cit = pair / p.co_tiles, cot = pair - cit * p.co_tiles;
        const uint32_t st = base + s * Gm::STAGE;
        mbar_expect_tx(full0 + 8 * s, Gm::X_BYTES + Gm::G_BYTES);
        tma_load_4d(st, &tmx, full0 + 8 * s, cit * 16 * p.MT, ct * Gm::WT - PW,
                    band * Gm::R - PH, img);
        tma_load_4d(st + Gm::X_REGION, &tmg, full0 + 8 * s, cot * 16 * p.NT, ct * Gm::WT,
                    band * Gm::R, img);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers
  const int tap = warp % Gm::TAPS, pg = warp / Gm::TAPS;
  const int ih = tap / KW, iw = tap % KW;
  const int li = lane >> 3, lj = lane & 7;
  // this lane's ldmatrix row within a stage: A (x, shifted by the tap):
  // matrix li holds pixels 8 (li >> 1) + 0..7 and channels 8 (li & 1) +
  // 0..7 of a 16 x 16 (pixel, ci) block; B (g): pixels 8 (li & 1) + 0..7,
  // channels 8 (li >> 1) + 0..7 of a (pixel, co) block
  const uint32_t a_lane =
      ((ih * Gm::XW + iw + lj + 8 * (li >> 1)) * Gm::CBOX + 8 * (li & 1)) * 2;
  const uint32_t b_lane = Gm::X_REGION + ((lj + 8 * (li & 1)) * Gm::CBOX + 8 * (li >> 1)) * 2;

  // a 48 x 48 (ci, co) tile of the tap, whatever the pair's tile widths
  // (16 MT x 16 NT): the rest of the box is the next tile or zero, and only
  // the pair's own rows and columns are summed by conv_wgrad_reduce
  float acc[3][6][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int ni = 0; ni < 6; ++ni) {
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
    }

  int s = 0;
  uint32_t ph = 0;
  long long seg_end = u0 < u1 ? min(u1, (u0 / p.tpp + 1) * p.tpp) : u1;  // a pair's last unit + 1
  for (long long u = u0; u < u1; ++u) {
    mbar_wait(full0 + 8 * s, ph);
    const uint32_t st = base + s * Gm::STAGE;
    // the next k-step's fragments load while this one's products run
    uint32_t fa[2][3][4], fb[2][3][4];
    load_frags<KH, KW>(st, pg, a_lane, b_lane, fa[0], fb[0]);
#pragma unroll
    for (int j = 0; j < Gm::NJ; ++j) {
      const int cur = j & 1;
      if (j + 1 < Gm::NJ) {
        load_frags<KH, KW>(st, pg + (j + 1) * Gm::NPG, a_lane, b_lane, fa[cur ^ 1], fb[cur ^ 1]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          mma16816(acc[mi][2 * np], fa[cur][mi], fb[cur][np][0], fb[cur][np][1]);
          mma16816(acc[mi][2 * np + 1], fa[cur][mi], fb[cur][np][2], fb[cur][np][3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }

    if (u + 1 == seg_end) {  // the end of a segment: write its partial, one tile per tap
      const long long pair = u / p.tpp;
      seg_end = min(u1, seg_end + p.tpp);
      const int g = lane >> 2, t = lane & 3;
      float* dst = Gm::NPG > 1 ? red + warp * PART_TILE
                               : p.part + ((blk + pair) * Gm::TAPS + tap) * PART_TILE;
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 6; ++ni) {
          float* d = dst + (16 * mi + g) * TILE + 8 * ni + 2 * t;
          *reinterpret_cast<float2*>(d) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(d + 8 * TILE) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
          acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
        }
      }
      if (Gm::NPG > 1) {  // the pixel groups of each tap, summed in order
        consumers_sync();
        float* out = p.part + (blk + pair) * Gm::TAPS * PART_TILE;
        for (int e = threadIdx.x; e < Gm::TAPS * PART_TILE; e += CONSUMERS * 32) {
          const int tp = e / PART_TILE, off = e - tp * PART_TILE;
          float sum = 0.0f;
#pragma unroll
          for (int q = 0; q < Gm::NPG; ++q) sum += red[(q * Gm::TAPS + tp) * PART_TILE + off];
          out[e] = sum;
        }
        consumers_sync();
      }
    }
  }
}

// out[tap][ci][co] = the sum over the blocks that touched the pair of (ci,
// co), in block order, of their partial tiles: the fixed-order second
// pass. Each thread takes 4 neighbouring co; the loads of 8 blocks go out
// together, the additions stay in block order.
__global__ void conv_wgrad_reduce(const float* __restrict__ part, float* __restrict__ out,
                                  int taps, int Ci, int Co, int CT, int COT, int co_tiles,
                                  long long units, int tpp, int G) {
  const long long n4 = (long long)taps * Ci * Co / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const int co = (int)(i % (Co / 4)) * 4;
    const long long rest = i / (Co / 4);
    const int ci = (int)(rest % Ci), tap = (int)(rest / Ci);
    const long long pair = (long long)(ci / CT) * co_tiles + co / COT;
    const long long b0 = block_of(pair * tpp, units, G);
    const long long b1 = block_of((pair + 1) * tpp - 1, units, G);
    const float* src = part + ((b0 + pair) * taps + tap) * PART_TILE + (ci % CT) * TILE + co % COT;
    const long long step = (long long)taps * PART_TILE;  // from one block's slot to the next
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    long long b = b0;
    for (; b + 8 <= b1 + 1; b += 8, src += 8 * step) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = *reinterpret_cast<const float4*>(src + k * step);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sum.x += v[k].x;
        sum.y += v[k].y;
        sum.z += v[k].z;
        sum.w += v[k].w;
      }
    }
    for (; b <= b1; ++b, src += step) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + 4 * i) = sum;
  }
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

// A tensor map over a channels-last (B, H, W, C) bf16 tensor whose boxes
// are cbox channels x box_w columns x box_h rows of one image.
bool make_map(CUtensorMap* map, const void* base, int B, int H, int W, int C, int cbox,
              int box_w, int box_h) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cbox, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KH, int KW>
cudaError_t launch(const void* x, const void* g, int B, int H, int W, int Ci, int Co, int G,
                   const Plan& p, cudaStream_t st) {
  using Gm = Geo<KH, KW>;
  if (p.ctiles != (W + Gm::WT - 1) / Gm::WT || p.bands != (H + Gm::R - 1) / Gm::R) {
    return cudaErrorInvalidValue;  // the host plan's tiles are not this file's
  }
  CUtensorMap tmx, tmg;
  if (!make_map(&tmx, x, B, H, W, Ci, Gm::CBOX, Gm::XW, Gm::XH) ||
      !make_map(&tmg, g, B, H, W, Co, Gm::CBOX, Gm::WT, Gm::R)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(conv_wgrad_partial<KH, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err != cudaSuccess) return err;
  conv_wgrad_partial<KH, KW><<<G, THREADS, Gm::SMEM, st>>>(tmx, tmg, p);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Ci), g: (B, H, W, Co) bf16 contiguous, 16-byte aligned; out:
// (kh, kw, Ci, Co) fp32. kh, kw in {1, 3}; Ci % (16 MT) == 0, Co % (16 NT)
// == 0, MT, NT in {1, 2, 3}. The plan (ops/kernels/conv_wgrad.plan): the
// pixel tiles across the width and down the height, the units (pairs x B
// x bands x ctiles) cut over G blocks; part: (G + pairs) x kh kw x 48 x 48
// fp32 scratch.
ND_EXPORT int nd_conv_wgrad(const void* x, const void* g, void* part, void* out, int B, int H,
                            int W, int Ci, int Co, int kh, int kw, int MT, int NT, int ctiles,
                            int bands, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MT < 1 || MT > 3 || NT < 1 || NT > 3 || Ci % (16 * MT) || Co % (16 * NT) || G < 1 ||
      B < 1 || ctiles < 1 || bands < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  p.part = static_cast<float*>(part);
  p.ctiles = ctiles;
  p.bands = bands;
  p.tpp = B * bands * ctiles;
  p.co_tiles = Co / (16 * NT);
  p.units = (long long)p.tpp * (Ci / (16 * MT)) * p.co_tiles;
  p.MT = MT;
  p.NT = NT;
  // no block may be empty: the reduction reads every slot between a pair's
  // first and last block
  if (G > p.units) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (kh == 3 && kw == 3) {
    err = launch<3, 3>(x, g, B, H, W, Ci, Co, G, p, st);
  } else if (kh == 1 && kw == 1) {
    err = launch<1, 1>(x, g, B, H, W, Ci, Co, G, p, st);
  } else if (kh == 3 && kw == 1) {
    err = launch<3, 1>(x, g, B, H, W, Ci, Co, G, p, st);
  } else if (kh == 1 && kw == 3) {
    err = launch<1, 3>(x, g, B, H, W, Ci, Co, G, p, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n4 = (long long)kh * kw * Ci * Co / 4;
  const int blocks = n4 >= 1024 * 256 ? 1024 : (int)((n4 + 255) / 256);
  conv_wgrad_reduce<<<blocks, 256, 0, st>>>(p.part, static_cast<float*>(out), kh * kw, Ci, Co,
                                            16 * MT, 16 * NT, p.co_tiles, p.units, p.tpp, G);
  return (int)cudaGetLastError();
}
