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
// TFLOP/s) and 268 M exponentials (16 per SM per clock on 132 SMs: about
// 70 us at 1.83 GHz), so the exponentials bind. The bytes are 4.2 MB.
//
// Design:
//   * one block of 4 warps per (batch x head, 64-query tile); each warp owns
//     16 query rows, whose q fragments stay in registers for the whole pass;
//   * k and v tiles of 64 keys go through shared memory in two stages
//     loaded with cp.async, the next tile in flight while this one is used;
//     rows are padded by 8 elements so the fragment reads do not collide
//     in banks;
//   * S = q k^T and o += p v run on the tensor cores as mma.sync m16n8k16
//     bf16 products with fp32 accumulators. The probabilities never leave
//     registers: the accumulator layout of two 8-key tiles of S is the
//     operand layout of one 16-key step of p v, and v's operand comes from
//     shared memory transposed by ldmatrix;
//   * the running max and normaliser are fp32 registers, reduced across the
//     four lanes that share a row with shuffles; keys past Nk score -inf
//     and their k / v rows are zero in shared memory.
// Rounding follows the plain version (flash_attention._attention_reference
// of the JAX package): the logits are rounded to bf16 before the fp32
// scale, the probabilities go into the p v product as bf16, and the output
// is rounded to bf16 once, after the division by the normaliser.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per k / v tile
constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 from two floats, the first in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t load32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Whole block: start the copy of keys [k0, k0 + BK) of k and v into one
// stage, rows of ld elements; rows past nk are zero.
template <int D>
__device__ void load_kv(const bf16* __restrict__ k, const bf16* __restrict__ v, int k0, int nk,
                        bf16* ks, bf16* vs) {
  constexpr int LD = D + 8, VEC = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < BK * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    if (k0 + r < nk) {
      cp_async16(ks + r * LD + c, k + (size_t)(k0 + r) * D + c);
      cp_async16(vs + r * LD + c, v + (size_t)(k0 + r) * D + c);
    } else {
      *reinterpret_cast<uint4*>(ks + r * LD + c) = zero;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = zero;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                    float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;  // k-steps of q k^T
  constexpr int NT = BK / 8;  // 8-key tiles of S
  constexpr int DT = D / 8;   // 8-column tiles of o
  __shared__ __align__(16) bf16 ks[2][BK * LD];
  __shared__ __align__(16) bf16 vs[2][BK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  q += bh * nq * D;
  o += bh * nq * D;
  k += bh * nk * D;
  v += bh * nk * D;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;  // this lane's rows

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < nq ? load32(q + (size_t)r0 * D + c) : 0u;
    qf[kk][1] = r1 < nq ? load32(q + (size_t)r1 * D + c) : 0u;
    qf[kk][2] = r0 < nq ? load32(q + (size_t)r0 * D + c + 8) : 0u;
    qf[kk][3] = r1 < nq ? load32(q + (size_t)r1 * D + c + 8) : 0u;
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()};  // running max of rows r0, r1
  float l[2] = {0.0f, 0.0f};            // running normaliser

  const int tiles = (nk + BK - 1) / BK;
  load_kv<D>(k, v, 0, nk, ks[0], vs[0]);
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_kv<D>(k, v, (j + 1) * BK, nk, ks[(j + 1) & 1], vs[(j + 1) & 1]);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const bf16* kt = ks[j & 1];
    const bf16* vt = vs[j & 1];

    // S = q k^T for 64 keys: lane holds rows (r0, r1) x keys 8 n + 2 t + {0, 1}
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kr = kt + (n * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t b[2] = {load32(kr), load32(kr + 8)};
        mma16816(s[n], qf[kk], b);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BK + n * 8 + 2 * t + (e & 1);
        const float val = key < nk ? round_bf16(s[n][e]) * scale : neg_inf();
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // o += p v, 16 keys a step; p's operand is two 8-key tiles of S
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned row =
          static_cast<unsigned>(__cvta_generic_to_shared(vt + (kk * 16 + (lane & 15)) * LD));
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t b[2];
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b[0]), "=r"(b[1])
                     : "r"(row + d * 16));
        mma16816(acc[d], a, b);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t;
    if (r0 < nq) {
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
    }
    if (r1 < nq) {
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r1 * D + c) =
          __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int nq, int nk,
           float scale, cudaStream_t st) {
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  flash_attention_fwd<D><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), nq, nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (BH, nq, D); k, v: (BH, nk, D); bf16 contiguous; D in {32, 64};
// nq, nk >= 1.
ND_EXPORT int nd_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                 int nq, int nk, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, BH, nq, nk, scale, st);
    case 64: return launch<64>(q, k, v, o, BH, nq, nk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
