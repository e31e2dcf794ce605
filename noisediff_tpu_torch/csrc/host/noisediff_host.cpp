// noisediff_host — native host data-plane of the PyTorch port.
//
// The port's own copy of the JAX package's host library (csrc/ at the
// repository's root, bound by noisediff_tpu/data/native.py), so that the
// two packages read the same bytes into the same floats. The reference's
// ingestion hot loop (SURVEY.md §3.1: rawpy decode + numpy pack_raw + crop
// inside every torch DataLoader worker) delegates its heavy lifting to
// LibRaw/torch C++ workers. This library is the equivalent native layer:
// fused Bayer packing / black-level / exposure-ratio / crop loops over
// decoded uint16 mosaics, multithreaded over rows, exposed through a C ABI
// consumed via ctypes (noisediff_tpu_torch/data/native.py).
//
// Channel order matches utils/raw_util.py:30-33 — R, G1, B, G2:
//   out[y][x][0] = bayer[2y  ][2x  ]   out[y][x][1] = bayer[2y  ][2x+1]
//   out[y][x][2] = bayer[2y+1][2x+1]   out[y][x][3] = bayer[2y+1][2x  ]
//
// Build: noisediff_tpu_torch/data/native.py runs g++ at first use into
// noisediff_tpu_torch/build/ (the Makefile beside this file has the same
// rule, for a build by hand).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Parallelise a [0, n) index range over hardware threads.
template <typename F>
void parallel_for(int64_t n, F&& fn, int num_threads = 0) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(n, 1)));
  if (num_threads == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&]() {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Bayer (H, W) uint16 -> packed (H/2, W/2, 4) float32.
// rescale: subtract black level, clamp at 0, divide by (white - black).
void nd_pack_raw(const uint16_t* bayer, float* out, int64_t H, int64_t W,
                 float black, float white, int rescale) {
  const int64_t h = H / 2, w = W / 2;
  const float inv = rescale ? 1.0f / (white - black) : 1.0f;
  parallel_for(h, [&](int64_t y) {
    const uint16_t* r0 = bayer + (2 * y) * W;
    const uint16_t* r1 = bayer + (2 * y + 1) * W;
    float* o = out + y * w * 4;
    for (int64_t x = 0; x < w; ++x) {
      float a = static_cast<float>(r0[2 * x]) - black;
      float b = static_cast<float>(r0[2 * x + 1]) - black;
      float c = static_cast<float>(r1[2 * x + 1]) - black;
      float d = static_cast<float>(r1[2 * x]) - black;
      if (rescale) {
        a = a < 0 ? 0 : a * inv;
        b = b < 0 ? 0 : b * inv;
        c = c < 0 ? 0 : c * inv;
        d = d < 0 ? 0 : d * inv;
      } else {
        a = a < 0 ? 0 : a;
        b = b < 0 ? 0 : b;
        c = c < 0 ? 0 : c;
        d = d < 0 ? 0 : d;
      }
      o[4 * x + 0] = a;
      o[4 * x + 1] = b;
      o[4 * x + 2] = c;
      o[4 * x + 3] = d;
    }
  });
}

// Packed (h, w, 4) float32 (normalised) -> Bayer (2h, 2w) uint16 DN
// (inverse of pack: * (white - black) + black, clipped — raw_util.py:69-84).
void nd_unpack_raw(const float* packed, uint16_t* out, int64_t h, int64_t w,
                   float black, float white) {
  const float scale = white - black;
  parallel_for(h, [&](int64_t y) {
    const float* p = packed + y * w * 4;
    uint16_t* r0 = out + (2 * y) * (2 * w);
    uint16_t* r1 = out + (2 * y + 1) * (2 * w);
    for (int64_t x = 0; x < w; ++x) {
      const float vals[4] = {p[4 * x], p[4 * x + 1], p[4 * x + 2], p[4 * x + 3]};
      uint16_t q[4];
      for (int i = 0; i < 4; ++i) {
        float v = vals[i] * scale + black;
        v = clampf(v, 0.0f, white);
        q[i] = static_cast<uint16_t>(v);
      }
      r0[2 * x] = q[0];
      r0[2 * x + 1] = q[1];
      r1[2 * x + 1] = q[2];
      r1[2 * x] = q[3];
    }
  });
}

// Fused training-sample kernel (the SonyTrainDataset item pipeline,
// dataset.py:119-128, in one pass over the crop only):
//   noisy = clip(pack(bayer_in) * ratio, 0, 1)
//   clean = pack(bayer_gt)
//   noise = noisy - clean
// All three outputs are (ch, cw, 4) crops at packed-domain origin (cy, cx).
void nd_make_noise_pair(const uint16_t* bayer_in, const uint16_t* bayer_gt,
                        float* noisy, float* clean, float* noise, int64_t H,
                        int64_t W, int64_t cy, int64_t cx, int64_t ch,
                        int64_t cw, float ratio, float black, float white) {
  const float inv = 1.0f / (white - black);
  parallel_for(ch, [&](int64_t y) {
    const int64_t by = 2 * (cy + y);
    const uint16_t* i0 = bayer_in + by * W;
    const uint16_t* i1 = bayer_in + (by + 1) * W;
    const uint16_t* g0 = bayer_gt + by * W;
    const uint16_t* g1 = bayer_gt + (by + 1) * W;
    float* no = noisy + y * cw * 4;
    float* cl = clean + y * cw * 4;
    float* nz = noise + y * cw * 4;
    for (int64_t x = 0; x < cw; ++x) {
      const int64_t bx = 2 * (cx + x);
      const uint16_t iv[4] = {i0[bx], i0[bx + 1], i1[bx + 1], i1[bx]};
      const uint16_t gv[4] = {g0[bx], g0[bx + 1], g1[bx + 1], g1[bx]};
      for (int c = 0; c < 4; ++c) {
        float vin = (static_cast<float>(iv[c]) - black);
        vin = vin < 0 ? 0 : vin * inv;
        vin = clampf(vin * ratio, 0.0f, 1.0f);
        float vgt = (static_cast<float>(gv[c]) - black);
        vgt = vgt < 0 ? 0 : vgt * inv;
        no[4 * x + c] = vin;
        cl[4 * x + c] = vgt;
        nz[4 * x + c] = vin - vgt;
      }
    }
  });
}

// Batched pack for cache building: frames are independent rows of work.
void nd_pack_raw_batch(const uint16_t* bayer, float* out, int64_t n, int64_t H,
                       int64_t W, float black, float white, int rescale) {
  const int64_t frame_in = H * W;
  const int64_t frame_out = (H / 2) * (W / 2) * 4;
  parallel_for(n, [&](int64_t i) {
    nd_pack_raw(bayer + i * frame_in, out + i * frame_out, H, W, black, white,
                rescale);
  });
}

int nd_version() { return 1; }

}  // extern "C"
