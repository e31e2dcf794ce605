// GroupNorm statistics of the training path, bf16 (B, N, C) in, fp32 out:
//   gn_stats(x)          out[0] = sum_n x,  out[1] = sum_n x^2
//   gn_grad_stats(g, x)  out[0] = sum_n g,  out[1] = sum_n g * x
// out (2, B, C), one launch a call.
//
// Replaces the TPU kernels noisediff_tpu/ops/pallas/gn_stats.py (gn_stats
// and gn_grad_stats), which carry the sums in VMEM across a sequential grid
// over row blocks.
//
// Bound on this card: memory. gn_stats reads x once (100.7 MB at the
// canonical 512^2 x 48 x 4 stage, 30 us at 3.35 TB/s), gn_grad_stats reads
// g and x (twice that); the outputs are a few KB and the arithmetic three
// fp32 operations per element read.
//
// What bound the previous design: a fixed cost per call of 13-20 us above
// the bound at every shape. It ran two launches: the partial sums, then a
// pass of B blocks in which each thread summed one (sample, channel)'s S
// partials one after the other, a chain of L2 loads as long at every shape.
//
// Design: one launch, grid (S, B) of up to 512 threads, S and the rows of a
// slab from ops/kernels/gn_stats.plan (a block per 128 KB of a sample, at
// most two blocks per SM: S 66 at 512^2 x 48, 24 at 64^2 x 384).
//   * Block (s, b) streams rows [s * rows, (s + 1) * rows) of sample b:
//     thread (r, v) owns channels 8v .. 8v + 7 and rows r, r + R, ... (R =
//     threads / (C / 8) rows in flight), 16-byte loads that bypass L1 with
//     256-byte L2 fetches, INFLIGHT of them issued before any is summed;
//     fp32 sums in registers, then the block's rows reduced in shared
//     memory in a fixed order (slices of rows per column over all threads,
//     then the slices) into its (2, C) partial.
//   * The sample's partials are summed inside the same launch by the block
//     that arrives last: after a barrier, thread 0 fences the block's
//     partial and takes a ticket on the sample's counter (atomicInc with the
//     limit S - 1, which puts the counter back to 0 on the last ticket, so
//     nothing is reset between calls and no host state goes with a launch).
//     The last block sums the S partials in float4 columns spread over all
//     its threads (K slices of S each, TAIL loads of a slice in flight, then
//     the K slices in order), so the order of summation is fixed by (S, C,
//     threads) whichever block arrives last: two calls give the same bits,
//     and no float atomics run.
// What it does not hide: the last block's sum (about a microsecond) after
// the slowest slab, and each launch's start and drain, which at the deep
// stages (12.6 MB, read from L2 when the map was just written) are most of
// the call (PERF.md).
#include "common.cuh"

namespace {

constexpr int VEC = 8;     // bf16 values per 16-byte piece
constexpr int INFLIGHT = 8;  // 16-byte loads per thread in flight while streaming
constexpr int TAIL = 8;    // partials per thread in flight in the last block's sum

// A 16-byte streaming load: not kept in L1, the L2 fetching 256-byte lines.
__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

struct GnArgs {
  const bf16* a;           // x (gn_stats) or g (gn_grad_stats), (B, N, C)
  const bf16* b;           // x (gn_grad_stats) or null
  float* part;             // (B, S, 2C) per-block partials
  unsigned* count;         // (B,) arrival counters, 0 between calls
  float* out;              // (2, B, C)
  long long N, rows;       // pixels per sample; rows per slab
  int B, C, S;
};

template <bool GRAD>
__device__ __forceinline__ void gn_sums(const GnArgs& p) {
  const int s = blockIdx.x;
  const int bi = blockIdx.y;
  const int C = p.C;
  const int lanes = C / VEC;
  const int T = blockDim.x;
  const int rif = T / lanes;  // rows in flight
  const int t = threadIdx.x;
  const int r = t / lanes;
  const int v = t - r * lanes;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] = 0.0f;
    s2[i] = 0.0f;
  }
  const long long row0 = (long long)s * p.rows;
  const long long row1 = min(p.N, row0 + p.rows);
  const size_t base = (size_t)bi * p.N * C + (size_t)v * VEC;
  const bf16* a = p.a + base;
  const bf16* b = GRAD ? p.b + base : nullptr;
  auto add = [&](const uint4 ra, const uint4 rb) {
    float fa[VEC], fb[VEC];
    unpack8(ra, fa);
    if (GRAD) unpack8(rb, fb);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += fa[i];
      s2[i] += fa[i] * (GRAD ? fb[i] : fa[i]);
    }
  };
  // whole rounds of UNROLL rows a thread (INFLIGHT loads, of one input or
  // two), issued together, then the rows left one at a time; the order of
  // the sums is fixed by the plan
  constexpr int UNROLL = GRAD ? INFLIGHT / 2 : INFLIGHT;
  long long row = row0 + r;
  const long long step = (long long)rif * UNROLL;
  for (; row + step - rif < row1; row += step) {
    uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ra[u] = ld_stream(a + (row + (long long)u * rif) * C);
      if (GRAD) rb[u] = ld_stream(b + (row + (long long)u * rif) * C);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add(ra[u], GRAD ? rb[u] : ra[u]);
  }
  for (; row < row1; row += rif) {
    const uint4 ra = ld_stream(a + row * C);
    add(ra, GRAD ? ld_stream(b + row * C) : ra);
  }

  // the block's partial: its rows in flight summed in K2 slices of rows
  // per column (K2 = rif / 16, all threads busy), then the slices in order
  extern __shared__ float4 smem4[];
  const int cols = 2 * C;
  float* red = reinterpret_cast<float*>(smem4);  // [rif][2C]
  float* rows_sum = red + (size_t)rif * cols;     // [K2][2C], K2 * 2C <= T
  float* dst = red + (size_t)r * cols + v * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    dst[i] = s1[i];
    dst[C + i] = s2[i];
  }
  __syncthreads();
  float* part = p.part + (size_t)bi * p.S * cols;
  float* mine = part + (size_t)s * cols;
  const int K2 = T >= cols ? T / cols : 1;
  if (K2 == 1) {
    for (int c = t; c < cols; c += T) {
      float acc = 0.0f;
      for (int k = 0; k < rif; ++k) acc += red[(size_t)k * cols + c];
      mine[c] = acc;
    }
  } else {
    const int c = t % cols;
    const int k0 = t / cols;
    if (k0 < K2) {
      float acc = 0.0f;
      for (int k = k0; k < rif; k += K2) acc += red[(size_t)k * cols + c];
      rows_sum[k0 * cols + c] = acc;
    }
    __syncthreads();
    if (t < cols) {
      float acc = rows_sum[t];
      for (int k = 1; k < K2; ++k) acc += rows_sum[k * cols + t];
      mine[t] = acc;
    }
  }

  // arrival: thread 0's fence, after the barrier, publishes the whole
  // block's partial (cumulative) before its ticket
  __syncthreads();
  __shared__ unsigned last;
  if (t == 0) {
    __threadfence();
    last = atomicInc(p.count + bi, (unsigned)(p.S - 1)) == (unsigned)(p.S - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // the last block: the S partials of sample bi, in float4 columns (C / 2 of
  // them), K slices of S per column (TAIL loads of a slice in flight at
  // once, summed in k order), then the K slices in order
  const int q4 = C / 2;
  const int K = T >= q4 ? T / q4 : 1;
  const float4* P = reinterpret_cast<const float4*>(part);
  float4* slice = smem4;  // [K][q4], within red (K * q4 <= T float4s)
  float* out0 = p.out + (size_t)bi * C;
  float* out1 = p.out + ((size_t)p.B + bi) * C;
  auto column = [&](int q, int k0) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = k0; k < p.S; k += K * TAIL) {
      float4 w[TAIL];
#pragma unroll
      for (int u = 0; u < TAIL; ++u) {
        const int kk = k + u * K;
        w[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kk < p.S) w[u] = __ldcg(P + (size_t)kk * q4 + q);
      }
#pragma unroll
      for (int u = 0; u < TAIL; ++u) {
        acc.x += w[u].x;
        acc.y += w[u].y;
        acc.z += w[u].z;
        acc.w += w[u].w;
      }
    }
    return acc;
  };
  auto store = [&](int q, float4 acc) {
    const int c = 4 * q;
    float* o = c < C ? out0 + c : out1 + (c - C);
    *reinterpret_cast<float4*>(o) = acc;
  };
  if (K == 1) {
    for (int q = t; q < q4; q += T) store(q, column(q, 0));
    return;
  }
  const int q = t % q4;
  const int k0 = t / q4;
  if (k0 < K) slice[k0 * q4 + q] = column(q, k0);
  __syncthreads();
  if (t < q4) {
    float4 acc = slice[t];
    for (int k = 1; k < K; ++k) {
      const float4 w = slice[k * q4 + t];
      acc.x += w.x;
      acc.y += w.y;
      acc.z += w.z;
      acc.w += w.w;
    }
    store(t, acc);
  }
}

// Two kernels of their own names, which the profiles read
__global__ void gn_stats_kernel(GnArgs p) { gn_sums<false>(p); }
__global__ void gn_grad_stats_kernel(GnArgs p) { gn_sums<true>(p); }

int launch(bool grad, const void* a, const void* b, void* part, void* count, void* out, int B,
           int N, int C, int S, int rows, int threads, int smem, void* stream) {
  GnArgs p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
           static_cast<float*>(part), static_cast<unsigned*>(count), static_cast<float*>(out),
           N, rows, B, C, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad) {
    gn_grad_stats_kernel<<<dim3(S, B), threads, smem, st>>>(p);
  } else {
    gn_stats_kernel<<<dim3(S, B), threads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, N, C) bf16, C % 8 == 0, 16-byte aligned; part: (B, S, 2C) fp32
// scratch; count: (B,) uint32, zero before the first call (the kernel leaves
// it zero); out: (2, B, C) fp32. S * rows >= N, threads a multiple of C / 8;
// smem: the block's dynamic shared memory in bytes, as the plan sizes it
// ([threads / (C / 8)][2C] fp32 sums, then threads floats).
ND_EXPORT int nd_gn_stats(const void* x, void* part, void* count, void* out, int B, int N, int C,
                          int S, int rows, int threads, int smem, void* stream) {
  return launch(false, x, nullptr, part, count, out, B, N, C, S, rows, threads, smem, stream);
}

// g, x: (B, N, C) bf16; the rest as nd_gn_stats.
ND_EXPORT int nd_gn_grad_stats(const void* g, const void* x, void* part, void* count, void* out,
                               int B, int N, int C, int S, int rows, int threads, int smem,
                               void* stream) {
  return launch(true, g, x, part, count, out, B, N, C, S, rows, threads, smem, stream);
}
