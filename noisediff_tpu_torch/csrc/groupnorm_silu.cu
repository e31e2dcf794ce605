// [conv bias ->] GroupNorm -> affine -> optional per-sample FiLM -> SiLU,
// for bf16 (B, N, C), in one launch:
//     y = silu(xb * a + bb),  xb = round_bf16(x + round_bf16(conv_bias))
// with a, bb the per-(sample, channel) fp32 coefficients of GroupNorm, its
// affine and the FiLM (blocks._gn_coeffs_primal and _film_fold of the JAX
// model: fp32 sums, biased uncentered variance, eps inside the rsqrt), y
// rounded once to bf16. The conv bias is the bias of the Block conv whose
// output x is (the conv runs without it in evaluation): xb is exactly what
// the conv's own bf16 bias add would store, so the statistics and the
// output see the same pre-norm values as before the fold.
//
// Replaces the TPU kernel noisediff_tpu/ops/pallas/groupnorm_silu.py
// (_forward / fused_groupnorm_film_silu), which keeps one sample's (N, C)
// block resident in VMEM and runs one program per sample.
//
// Bound on this card: memory. The function must read x once and write y
// once: at the canonical 512^2 x 48 x 4 stage 2 x 100.7 MB, 60 us at 3.35
// TB/s. The arithmetic is a handful of fp32 operations per element.
//
// What bound the previous design (three launches, 2.87 ms per evaluation
// on the card's clock against a 1.29 ms bound): a partial-sums pass, a
// coefficients pass and an apply pass that read x from device memory a
// second time, plus the host's three allocations and casts per call.
//
// Design: one persistent cooperative launch (every block co-resident), one
// block of up to 512 threads per SM; x is read from device memory once
// where a sample fits in the blocks' shared memory (132 x 227 KB = 30 MB;
// a 512^2 x 48 sample is 25.2 MB):
//   * Samples go in rounds of `spr` (ops/kernels/groupnorm_silu.plan): in
//     round r, samples r spr .. share the grid, grid / spr blocks each, and
//     each block takes a contiguous slab of its sample's rows (one sample a
//     round at 512^2 x 48, two at 256^2 x 96, the batch at the deep stages).
//   * The slab comes into shared memory by bulk copies (cp.async.bulk, one
//     thread starts them, up to NCH chunks, each counted in bytes on its
//     own mbarrier), so a whole slab is in flight at once. Thread t owns
//     the 16-byte pieces t, t + T, ... of the slab (8 channels, the same 8
//     for all of them since T is a multiple of C / 8) and sums xb and xb^2
//     in fp32 registers as each chunk lands.
//   * The block reduces its threads' sums to its group sums in a fixed
//     order and writes them (16 floats); the sample's blocks meet at an
//     arrival word (epoch | count, 64 bits): every block lifts the word to
//     its call's epoch with an atomic max, then adds one, so the first
//     arrival of a call replaces whatever an earlier call left and nothing
//     depends on a counter being reset. Each block then sums the sample's
//     partials in the same fixed order (every block gets the same bits, and
//     two calls give the same bits: no float atomics) and forms a, bb.
//   * The apply pass writes y chunk by chunk from shared memory; as soon as
//     a chunk is read, the next round's copy into it starts, and the block
//     sums the next round's chunk LAG behind, so round r's writes overlap
//     round r + 1's reads and sums.
//   * Where a slab does not fit (a sample over ~30 MB: 512^2 x 96 at the
//     dim-96 model, 178 x 266 x 384), its rows past `res_rows` are read
//     twice, the second time mostly from L2; still one launch.
//   * SiLU through __expf and __fdividef: two MUFU operations an element,
//     whose fp32 error (~2 ulp) is far below the bf16 rounding of y.
// What it does not hide: the first round's read comes before any write,
// and each round's barrier and coefficients leave the memory idle for a
// few microseconds (PERF.md).
// A barrier's wait is bounded (10 s on the global timer, then a trap), so a
// fault shows as a launch error, not a hung card.
//
// Second entry, nd_groupnorm_silu_apply: y = silu(x * a + bb) from given
// fp32 (B, C) coefficients, the apply phase alone. The spatially sharded
// GroupNorm (models/blocks.GroupNorm under parallel/mesh.activate) takes
// its statistics from gn_stats sums all-reduced over the ranks that hold
// the frame's rows, so the coefficients come from outside this call.
// Bound: memory, x read once and y written once (at a 712 x 2128 x 48
// shard 2 x 145 MB, 87 us at 3.35 TB/s). Design: a grid-stride loop over
// 16-byte pieces (8 channels), a few blocks per SM, each piece's 8
// coefficient pairs read through the read-only cache (B x C x 8 bytes in
// all). The product and the sum are rounded one at a time and SiLU is
// v / (1 + expf(-v)), as the plain version computes them on the card.
#include "common.cuh"

namespace {

constexpr int VEC = 8;        // bf16 values per 16-byte piece
constexpr int MAX_THREADS = 512;
constexpr int NCH = 16;       // bulk-copy chunks (and mbarriers) a slab's resident part takes
constexpr int UNROLL = 4;     // pieces in flight per thread where rows are re-read
constexpr int GP = 16;        // a block's partial: the sums of up to 8 groups, then the squares

struct GnArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  const float* conv_bias;         // (C,) fp32 or null
  const void* film_s;             // (B, C) rows film_ld apart, bf16 or fp32, or null
  const void* film_sh;
  bf16* y;
  float* part;                    // (B, grid, GP) per-block group sums
  unsigned long long* bar;        // (B,) arrival words: epoch << 32 | count
  long long N;
  int B, C, G;
  int film_ld, film_bf16;
  int spr;                        // samples per round
  int res_rows;                   // rows of a slab kept in shared memory
  unsigned epoch;
  float eps;
};

// The slab of block `blk` in round `r`: sample -1 when the block has none.
struct Slab {
  int sample, part, parts;
  long long r0, r1;
};

__device__ __forceinline__ Slab slab_of(const GnArgs& a, int r, int blk, int grid) {
  Slab s{-1, 0, 1, 0, 0};
  const int s0 = r * a.spr;
  if (s0 >= a.B) return s;
  const int ns = min(a.spr, a.B - s0);
  const int bps = grid / ns;
  if (blk >= ns * bps) return s;
  s.sample = s0 + blk / bps;
  s.part = blk % bps;
  s.parts = bps;
  s.r0 = (long long)s.part * a.N / bps;
  s.r1 = (long long)(s.part + 1) * a.N / bps;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The block's arrival at the sample's word for this call's epoch, and the
// wait for n arrivals: the max lifts a word an earlier call left (a smaller
// epoch, any count) to epoch << 32 and leaves one this call already holds
// as it is; the add counts. Neither returns a value, so the arrivals do not
// queue behind each other. The block's partial, written before the block
// barrier, is published by thread 0's fence (cumulative over the barrier).
__device__ void arrive_and_wait(unsigned long long* w, unsigned epoch, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long tag = (unsigned long long)epoch << 32;
    atomicMax(w, tag);
    atomicAdd(w, 1ull);
    const unsigned long long done = tag | n;
    const unsigned long long t0 = global_ns();
    while (ld_acquire(w) != done) {
      if (global_ns() - t0 > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// xb = round_bf16(x + bias) for one piece.
__device__ __forceinline__ void biased(const uint4 raw, const float* bias, float* f) {
  unpack8(raw, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = round_bf16(f[k] + bias[k]);
}

__device__ __forceinline__ void accumulate(const uint4 raw, const float* bias, float* s1,
                                           float* s2) {
  float f[VEC];
  biased(raw, bias, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k] += f[k];
    s2[k] += f[k] * f[k];
  }
}

// silu(xb * a + bb), rounded to bf16. __expf and __fdividef carry ~2 ulp
// of fp32 error into a result rounded to 8 bits.
__device__ __forceinline__ uint4 apply(const uint4 raw, const float* bias, const float* ca,
                                       const float* cb) {
  float f[VEC];
  biased(raw, bias, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float v = f[k] * ca[k] + cb[k];
    f[k] = __fdividef(v, 1.0f + __expf(-v));
  }
  return pack8(f);
}

// A block's view of its slab: the pieces (16 bytes, C / 8 to a row) from
// the slab's first row; the first `res` of them live in shared memory in
// chunks of `chunk` pieces (a multiple of the block's threads, so that
// thread t always meets the pieces t, t + T, ...: the same 8 channels),
// chunk k counted on mbarrier k.
struct Pieces {
  const bf16* x;
  bf16* y;
  int n;        // pieces of the slab, 0 when the block has none this round
  int res;      // of them in shared memory
  int chunks;   // bulk copies that bring them
};

__device__ __forceinline__ Pieces pieces_of(const GnArgs& a, const Slab& s, int res_pieces,
                                            int chunk) {
  Pieces q{a.x, a.y, 0, 0, 0};
  if (s.sample < 0) return q;
  const size_t o = ((size_t)s.sample * a.N + s.r0) * a.C;
  q.x = a.x + o;
  q.y = a.y + o;
  q.n = (int)((s.r1 - s.r0) * (a.C / VEC));
  q.res = min(q.n, res_pieces);
  q.chunks = (q.res + chunk - 1) / chunk;
  return q;
}

// Thread 0: chunk k of a slab's resident pieces, global -> shared, counted
// in bytes on the chunk's mbarrier.
__device__ __forceinline__ void fetch_chunk(const Pieces& q, int k, int chunk, uint4* slots,
                                            uint64_t* mbar) {
  const int p0 = k * chunk;
  const int bytes = (min(q.res, p0 + chunk) - p0) * 16;
  const uint32_t bar = smem_u32(mbar + k);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(slots + p0)), "l"(q.x + (size_t)p0 * VEC), "r"(bytes), "r"(bar)
      : "memory");
}

// The statistics of resident chunk k (once its copy has landed) into s1, s2.
__device__ __forceinline__ void sum_chunk(const Pieces& q, int k, int chunk, const uint4* slots,
                                          uint64_t* mbar, uint32_t& phase, const float* bias,
                                          float* s1, float* s2) {
  mbar_wait(smem_u32(mbar + k), (phase >> k) & 1u);
  phase ^= 1u << k;
  const int end = min(q.res, (k + 1) * chunk);
  for (int p = k * chunk + threadIdx.x; p < end; p += blockDim.x) {
    accumulate(slots[p], bias, s1, s2);
  }
}

// The statistics of a slab's pieces past `res`, from device memory.
__device__ __forceinline__ void sum_streamed(const Pieces& q, const float* bias, float* s1,
                                             float* s2) {
  const int T = blockDim.x;
  for (int p0 = q.res + threadIdx.x; p0 < q.n; p0 += UNROLL * T) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * T;
      if (p < q.n) v[u] = __ldg(reinterpret_cast<const uint4*>(q.x + (size_t)p * VEC));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + u * T < q.n) accumulate(v[u], bias, s1, s2);
    }
  }
}

// y for slab q, chunk by chunk: as soon as the block is done with chunk k,
// thread 0 starts the copy of the next slab's chunk k into it, and the
// block sums the next slab's chunk k - LAG, whose copy has had LAG chunks'
// time to land. Then q's pieces past `res` (read again), and the next
// slab's remaining chunks and pieces past `res` into s1, s2.
constexpr int LAG = 2;

__device__ __forceinline__ void apply_pass(const Pieces& q, const Pieces& nq, int chunk,
                                           uint4* slots, uint64_t* mbar, uint32_t& phase,
                                           const float* bias, const float* ca, const float* cb,
                                           float* s1, float* s2) {
  const int t = threadIdx.x, T = blockDim.x;
  int summed = 0;
  if (nq.chunks == 0) {  // nothing to refill: no barrier per chunk
#pragma unroll 2
    for (int p = t; p < q.res; p += T) {
      *reinterpret_cast<uint4*>(q.y + (size_t)p * VEC) = apply(slots[p], bias, ca, cb);
    }
  }
  for (int k = 0; k < (nq.chunks == 0 ? 0 : q.chunks); ++k) {
    const int end = min(q.res, (k + 1) * chunk);
    for (int p = k * chunk + t; p < end; p += T) {
      *reinterpret_cast<uint4*>(q.y + (size_t)p * VEC) = apply(slots[p], bias, ca, cb);
    }
    __syncthreads();  // chunk k is read: its slots may be refilled
    if (t == 0 && k < nq.chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch_chunk(nq, k, chunk, slots, mbar);
    }
    if (summed + LAG <= k && summed < nq.chunks) {
      sum_chunk(nq, summed++, chunk, slots, mbar, phase, bias, s1, s2);
    }
  }
  if (t == 0) {
    for (int k = q.chunks; k < nq.chunks; ++k) fetch_chunk(nq, k, chunk, slots, mbar);
  }
  for (int p0 = q.res + t; p0 < q.n; p0 += UNROLL * T) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * T;
      if (p < q.n) v[u] = __ldg(reinterpret_cast<const uint4*>(q.x + (size_t)p * VEC));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * T;
      if (p < q.n) *reinterpret_cast<uint4*>(q.y + (size_t)p * VEC) = apply(v[u], bias, ca, cb);
    }
  }
  while (summed < nq.chunks) sum_chunk(nq, summed++, chunk, slots, mbar, phase, bias, s1, s2);
  sum_streamed(nq, bias, s1, s2);
}

// Sums over rows of a [rows][width] fp32 table into `width` totals, four
// columns to a thread and the rows cut into segments of about 8 rows (as
// many segments as the threads allow), each segment's rows in order, then
// the segments in order: `load(row, q)` gives row `row`, columns 4 q ..
// 4 q + 3. The segment sums go through `red` (T * 4 floats at least),
// whose earlier contents the caller has finished with; the totals to `out`.
// Block-wide.
template <typename Load>
__device__ __forceinline__ void sum_rows(int rows, int width, float* red, float* out,
                                         Load load) {
  const int T = blockDim.x, t = threadIdx.x, Q = width / 4;
  const int nseg = max(1, min(T / Q, (rows + 7) / 8));
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const bool mine = t < nseg * Q;
  if (mine) {
    const int q = t % Q, seg = t / Q;
    const int r0 = seg * rows / nseg, r1 = (seg + 1) * rows / nseg;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      const float4 v = load(r, q);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  __syncthreads();  // every row is read before the segment sums overwrite red
  if (mine) reinterpret_cast<float4*>(red)[t] = acc;
  __syncthreads();
  for (int q = t; q < Q; q += T) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int seg = 0; seg < nseg; ++seg) {
      const float4 v = reinterpret_cast<const float4*>(red)[seg * Q + q];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[q] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float film_at(const void* p, int bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Shared memory: the slots (res_rows * C bf16), the NCH mbarriers, then
// fp32 red [rows in flight][2C], tot [2C], gsum [GP], coef [2C], gamma |
// beta [2C], the sample's FiLM scale + 1 | shift [2C].
__global__ void __launch_bounds__(MAX_THREADS, 1) groupnorm_silu_fused(const GnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, C2 = 2 * C, lanes = C / VEC;
  const int T = blockDim.x, t = threadIdx.x;
  const int v = t % lanes, ri = t / lanes, rif = T / lanes;
  const int grid = gridDim.x, blk = blockIdx.x;
  const int res_pieces = a.res_rows * lanes;
  const int chunk = (res_pieces + NCH * T - 1) / (NCH * T) * T;
  uint4* slots = reinterpret_cast<uint4*>(smem);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + (size_t)res_pieces * 16);
  float* red = reinterpret_cast<float*>(mbar + NCH);
  float* tot = red + (size_t)rif * C2;
  float* gsum = tot + C2;
  float* coef = gsum + GP;
  float* gb = coef + C2;
  float* film = gb + C2;
  for (int c = t; c < C; c += T) {
    gb[c] = a.gamma[c];
    gb[C + c] = a.beta[c];
  }
  if (t == 0) {
    for (int k = 0; k < NCH; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(mbar + k)), "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phase = 0;  // bit k: the parity of chunk k's next completion

  float bias[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    bias[k] = a.conv_bias != nullptr ? round_bf16(a.conv_bias[v * VEC + k]) : 0.0f;
  }
  float s1[VEC], s2[VEC], ca[VEC], cb[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = ca[k] = cb[k] = 0.0f;

  const int rounds = (a.B + a.spr - 1) / a.spr;
  const int cg = C / a.G;
  Slab cur = slab_of(a, 0, blk, grid);
  Pieces q = pieces_of(a, cur, res_pieces, chunk);
  if (t == 0) {
    for (int k = 0; k < q.chunks; ++k) fetch_chunk(q, k, chunk, slots, mbar);
  }
  for (int k = 0; k < q.chunks; ++k) sum_chunk(q, k, chunk, slots, mbar, phase, bias, s1, s2);
  sum_streamed(q, bias, s1, s2);

  for (int r = 0; r < rounds; ++r) {
    if (cur.sample >= 0) {  // uniform over the block
      if (a.film_s != nullptr) {  // read now, used after the barrier
        for (int c = t; c < C; c += T) {
          const size_t i = (size_t)cur.sample * a.film_ld + c;
          film[c] = film_at(a.film_s, a.film_bf16, i) + 1.0f;
          film[C + c] = film_at(a.film_sh, a.film_bf16, i);
        }
      }
      // the block's channel sums, its threads' rows in order, then its
      // group sums: the partial (GP floats, groups past G zero)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        red[(size_t)ri * C2 + v * VEC + k] = s1[k];
        red[(size_t)ri * C2 + C + v * VEC + k] = s2[k];
      }
      __syncthreads();
      sum_rows(rif, C2, red, tot, [&](int row, int qq) {
        return reinterpret_cast<const float4*>(red + (size_t)row * C2)[qq];
      });
      float* pb = a.part + (size_t)cur.sample * grid * GP;
      // a whole warp per group sum (T need not be a multiple of 32)
      for (int o = t >> 5; (t >> 5) < (T >> 5) && o < GP; o += T >> 5) {
        const int g = o % 8;
        float acc = 0.0f;
        if (g < a.G) {
          const float* src = tot + (o < 8 ? 0 : C) + g * cg;
          for (int j = t & 31; j < cg; j += 32) acc += src[j];
        }
        acc = warp_sum(acc);
        if ((t & 31) == 0) pb[(size_t)cur.part * GP + o] = acc;
      }
      arrive_and_wait(a.bar + cur.sample, a.epoch, cur.parts);
      // the sample's group sums: its blocks' partials in block order
      sum_rows(cur.parts, GP, red, gsum, [&](int k, int qq) {
        return __ldcg(reinterpret_cast<const float4*>(pb + (size_t)k * GP) + qq);
      });
      const float cnt = (float)a.N * (float)cg;
      for (int c = t; c < C; c += T) {
        const int g = c / cg;
        const float mean = gsum[g] / cnt;
        const float var = gsum[8 + g] / cnt - mean * mean;
        const float inv = rsqrtf(var + a.eps);
        float sa = inv * gb[c];
        float sbb = gb[C + c] - mean * sa;
        if (a.film_s != nullptr) {
          sa *= film[c];
          sbb = sbb * film[c] + film[C + c];
        }
        coef[c] = sa;
        coef[C + c] = sbb;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ca[k] = coef[v * VEC + k];
        cb[k] = coef[C + v * VEC + k];
      }
    }
    const Slab nxt = slab_of(a, r + 1, blk, grid);
    const Pieces nq = pieces_of(a, nxt, res_pieces, chunk);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.0f;
    apply_pass(q, nq, chunk, slots, mbar, phase, bias, ca, cb, s1, s2);
    cur = nxt;
    q = nq;
  }
}

constexpr int APPLY_UNROLL = 2;  // pieces in flight per thread

__device__ __forceinline__ uint4 apply_exact(const uint4 raw, const float* a, const float* bb) {
  float f[VEC];
  unpack8(raw, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float v = __fadd_rn(__fmul_rn(f[k], a[k]), bb[k]);
    f[k] = v / (1.0f + expf(-v));
  }
  return pack8(f);
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// x, y: (B, N, C) bf16 as 16-byte pieces; a, bb: (B, C) fp32. Piece p of
// the whole tensor is sample p / (N C / 8), channels 8 (p % (C / 8)) ..
__global__ void __launch_bounds__(256) groupnorm_silu_apply(const uint4* __restrict__ x,
                                                            const float* __restrict__ a,
                                                            const float* __restrict__ bb,
                                                            uint4* __restrict__ y,
                                                            long long per_sample, int lanes,
                                                            long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; p0 < total;
       p0 += APPLY_UNROLL * stride) {
    uint4 v[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long p = p0 + u * stride;
      if (p < total) v[u] = __ldg(x + p);
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long p = p0 + u * stride;
      if (p < total) {
        const long long c0 = (p / per_sample) * lanes * VEC + (p % lanes) * VEC;
        float ca[VEC], cb[VEC];
        load8(a + c0, ca);
        load8(bb + c0, cb);
        y[p] = apply_exact(v[u], ca, cb);
      }
    }
  }
}

}  // namespace

// y = silu(x * a + bb): x, y (B, N, C) bf16, a, bb (B, C) fp32, all
// 16-byte aligned, C % 8 == 0; `grid` blocks of 256 threads.
ND_EXPORT int nd_groupnorm_silu_apply(const void* x, const void* a, const void* bb, void* y,
                                      int B, long long N, int C, int grid, void* stream) {
  if (C % VEC || B < 1 || N < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  const int lanes = C / VEC;
  groupnorm_silu_apply<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<uint4*>(y), N * lanes, lanes, (long long)B * N * lanes);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory a block may take on the current card
// (the plan's budget).
ND_EXPORT int nd_groupnorm_silu_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

// x, y: (B, N, C) bf16; gamma, beta: (C,) fp32; conv_bias: (C,) fp32 or null;
// film_s, film_sh: (B, C) with rows film_ld elements apart, bf16 (film_bf16)
// or fp32, or null; part: (B, grid, 16) fp32 scratch; bar: (B,) 64-bit
// words, zero when first allocated; epoch: this call's tag, never 0 and
// never that of the previous call on the same scratch. The plan (grid,
// threads, spr, res_rows, smem) comes from ops/kernels/groupnorm_silu.plan.
ND_EXPORT int nd_groupnorm_silu(const void* x, const void* gamma, const void* beta,
                                const void* conv_bias, const void* film_s, const void* film_sh,
                                void* y, void* part, void* bar, int B, long long N, int C, int G,
                                int film_ld, int film_bf16, int grid, int threads, int spr,
                                int res_rows, int smem, unsigned epoch, float eps, void* stream) {
  // the kernel attribute is set per card (the current one: the caller makes
  // the tensors' card current)
  constexpr int MAX_CARDS = 64;
  static int smem_set_of[MAX_CARDS] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_CARDS) {
    return (int)cudaErrorInvalidDevice;
  }
  if (smem > smem_set_of[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        groupnorm_silu_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set_of[dev] = smem;
  }
  if (C % VEC || threads > MAX_THREADS || threads % (C / VEC) || G > 8 || C % G || spr < 1) {
    return (int)cudaErrorInvalidValue;
  }
  GnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.conv_bias = static_cast<const float*>(conv_bias);
  a.film_s = film_s;
  a.film_sh = film_sh;
  a.y = static_cast<bf16*>(y);
  a.part = static_cast<float*>(part);
  a.bar = static_cast<unsigned long long*>(bar);
  a.N = N;
  a.B = B;
  a.C = C;
  a.G = G;
  a.film_ld = film_ld;
  a.film_bf16 = film_bf16;
  a.spr = spr;
  a.res_rows = res_rows;
  a.epoch = epoch;
  a.eps = eps;
  void* args[] = {&a};
  // cooperative: the launch is refused unless every block is co-resident,
  // which the per-sample barriers need
  return (int)cudaLaunchCooperativeKernel((const void*)groupnorm_silu_fused, dim3(grid),
                                          dim3(threads), args, (size_t)smem,
                                          static_cast<cudaStream_t>(stream));
}
