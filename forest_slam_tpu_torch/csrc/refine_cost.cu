// Per-keypoint 2D SAD template search (match refinement cost volume).
//
// Replaces the TPU kernel frontend/pallas_refine.py:_refine_kernel (wrapper
// refine_cost_volume_pallas). For keypoint k of pair b, with ht = t/2,
// n = 2R+1 and S = n + t - 1:
//
//   tpl[ty, tx] = img0[y0 - ht + ty, x0 - ht + tx]
//   win[wy, wx] = img1[y1 - ht - R + wy, x1 - ht - R + wx]
//   cost[b, k, dy, dx] = sum_{ty, tx} |win[dy + ty, dx + tx] - tpl[ty, tx]|
//
// zero outside the images, taps summed from 0 in (ty, tx) row-major order
// like the XLA path's fori_loop (frontend/refine.py:_cost_volume_xla), so
// kernel and plain version agree bit for bit. Rows k at or past nvalid[b] are
// written as exact zeros without any compute: callers compact the valid
// keypoints to the front, so work scales with the matched fraction.
//
// What bounds it on the H100: bytes. At K=1024, R=12, t=8 a pair's cost
// volume is 2.56 MB of float32 written once (20.5 MB for 8 pairs, 6 us of
// HBM time), beside its live keypoints' windows; the 3 operations a tap
// (subtract, absolute value, add) over 40,000 taps a live keypoint take a
// little less at the float32 rate (chip_smoke.py computes both from its data).
//
// Design, against what held the block-per-keypoint kernel back:
// 1. Register tiling. A lane owns strips of kPX = 5 consecutive dx at one dy
//    (up to kJ = 4 strips a pass). Per template row it holds kTC = 8
//    template values and, per strip, the kPX + kTC - 1 window values those
//    taps need in registers: 8 + 4 x 12 shared loads for 160 taps, where the
//    old kernel made two loads a tap. Where t is a multiple of kTC the taps
//    run with no guard.
// 2. One warp per keypoint, several keypoints a block (as many as fit in
//    48 KB of shared memory, at most 8: 8 at R=12, t=8), no block barrier. At
//    n = 25 the 125 strips fill 4 x 32 lanes but for three; a keypoint's
//    results go back through its window's buffer and out with 16-byte
//    stores, as do a dead keypoint's zeros, with no compute.
// 3. The template and window arrive by cp.async, every copy of a keypoint in
//    flight at once (zero-filled outside the images), where a copy through
//    registers waits on each load before its store.
// Window rows are padded by kPX - 1 zero columns, so a strip that runs past n
// reads only its own window; its extra outputs are dropped. Any t and R the
// wrapper takes (t*t + S*S <= 12288 floats): the template row goes through
// registers kTC columns at a time, and the opt-in shared memory holds a
// window too large for 48 KB. Registers (-Xptxas -v, sm_90a): 74, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "device_setup.cuh"

namespace {

constexpr int kPX = 5;  // consecutive dx per strip
constexpr int kJ = 4;   // strips per lane per pass
constexpr int kTC = 8;  // template columns per register chunk
constexpr int kMaxKeypointsPerBlock = 8;

struct Geometry {
  int t, n, S, Sp, nsx, nstrips;  // template side, offsets a side, window side and padded row, strips a
                                  // row and in all
  __host__ __device__ Geometry(int t_, int R)
      : t(t_), n(2 * R + 1), S(2 * R + t_), Sp(2 * R + t_ + kPX - 1), nsx((2 * R + kPX) / kPX),
        nstrips((2 * R + 1) * ((2 * R + kPX) / kPX)) {}
  // one pass of kJ strips a lane covers every strip: the results can go
  // through the window's buffer
  __host__ __device__ bool one_pass() const { return nstrips <= 32 * kJ; }
  // shared floats of one keypoint: template, padded window, results unless
  // they go through the window's buffer
  __host__ __device__ int floats() const { return t * t + S * Sp + (one_pass() ? 0 : n * n); }
};

// the taps of template row ty, columns tx0 .. tx0 + lim - 1, into the
// strips' sums; kFull: lim == kTC, with no guard
template <bool kFull>
__device__ __forceinline__ void sad_chunk(float (&acc)[kJ][kPX], const int (&at)[kJ], const float* win,
                                          const float* tpl_row, int lim) {
  float tv[kTC];
#pragma unroll
  for (int c = 0; c < kTC; ++c) tv[c] = (kFull || c < lim) ? tpl_row[c] : 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (at[j] < 0) continue;
    const float* row = win + at[j];
    float wv[kPX + kTC - 1];
#pragma unroll
    for (int c = 0; c < kPX + kTC - 1; ++c) wv[c] = (kFull || c < kPX - 1 + lim) ? row[c] : 0.f;
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      if (kFull || c < lim) {
#pragma unroll
        for (int px = 0; px < kPX; ++px) acc[j][px] += fabsf(wv[px + c] - tv[c]);
      }
    }
  }
}

// the warp writes count floats to dst (src: shared memory, or zeros when
// null), 16 bytes a store where dst's address allows
__device__ __forceinline__ void store_run(float* dst, const float* src, int count, int lane) {
  int head = (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) / 4u);
  if (head > count) head = count;
  if (lane < head) dst[lane] = src ? src[lane] : 0.f;
  const int body = (count - head) / 4;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = lane; i < body; i += 32) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src) {
      const float* s = src + head + 4 * i;
      v = make_float4(s[0], s[1], s[2], s[3]);
    }
    d4[i] = v;
  }
  const int tail = head + 4 * body;
  if (tail + lane < count) dst[tail + lane] = src ? src[tail + lane] : 0.f;
}

__global__ void refine_cost_kernel(const float* __restrict__ img0, const float* __restrict__ img1,
                                   const int* __restrict__ xi0, const int* __restrict__ yi0,
                                   const int* __restrict__ xi1, const int* __restrict__ yi1,
                                   const int* __restrict__ nvalid, float* __restrict__ cost, int BK, int K,
                                   int H0, int W0, int H1, int W1, int t, int R) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bk = blockIdx.x * (blockDim.x / 32) + warp;  // b * K + k
  if (bk >= BK) return;
  const Geometry g(t, R);
  const int n = g.n, S = g.S, Sp = g.Sp, nsx = g.nsx, nstrips = g.nstrips;
  const int b = bk / K, k = bk % K;
  float* out = cost + (size_t)bk * n * n;
  if (k >= nvalid[b]) {
    store_run(out, nullptr, n * n, lane);
    return;
  }
  float* tpl = smem + (size_t)warp * g.floats();  // (t, t)
  float* win = tpl + t * t;                        // (S, Sp), columns S.. zero
  float* res = g.one_pass() ? win : win + S * Sp;  // (n, n)
  const float* I0 = img0 + (size_t)b * H0 * W0;
  const float* I1 = img1 + (size_t)b * H1 * W1;
  const int ht = t / 2;
  const int x0 = xi0[bk] - ht, y0 = yi0[bk] - ht;
  const int x1 = xi1[bk] - ht - R, y1 = yi1[bk] - ht - R;
  // template and window through cp.async, every copy in flight at once
  for (int i = lane; i < t * t; i += 32) {
    const int yy = y0 + i / t, xx = x0 + i % t;
    const bool in = yy >= 0 && yy < H0 && xx >= 0 && xx < W0;
    cp_async4(tpl + i, in ? I0 + (size_t)yy * W0 + xx : I0, in);
  }
  for (int c = lane; c < Sp; c += 32) {
    const int xx = x1 + c;
    const bool col = c < S && xx >= 0 && xx < W1;
    for (int r = 0; r < S; ++r) {
      const int yy = y1 + r;
      const bool in = col && yy >= 0 && yy < H1;
      cp_async4(win + r * Sp + c, in ? I1 + (size_t)yy * W1 + xx : I1, in);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  for (int base = 0; base < nstrips; base += 32 * kJ) {
    float acc[kJ][kPX];
    int at[kJ];  // each strip's first window position; -1 past the last strip
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int s = base + lane + 32 * j;
      at[j] = s < nstrips ? (s / nsx) * Sp + (s % nsx) * kPX : -1;
#pragma unroll
      for (int px = 0; px < kPX; ++px) acc[j][px] = 0.f;
    }
    for (int ty = 0; ty < t; ++ty) {
      for (int tx0 = 0; tx0 < t; tx0 += kTC) {
        const int lim = min(kTC, t - tx0);
        if (lim == kTC)
          sad_chunk<true>(acc, at, win + ty * Sp + tx0, tpl + ty * t + tx0, lim);
        else
          sad_chunk<false>(acc, at, win + ty * Sp + tx0, tpl + ty * t + tx0, lim);
      }
    }
    if (g.one_pass()) __syncwarp();  // every lane is done with the window
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int s = base + lane + 32 * j;
      if (s >= nstrips) continue;
      const int dy = s / nsx, dx0 = (s % nsx) * kPX;
#pragma unroll
      for (int px = 0; px < kPX; ++px)
        if (dx0 + px < n) res[dy * n + dx0 + px] = acc[j][px];
    }
  }
  __syncwarp();
  store_run(out, res, n * n, lane);
}

DeviceSetup device_setup;

}  // namespace

// Keypoints a block takes at template t and radius R, one a warp: as many as
// fit in 48 KB of shared memory, at most 8, at least 1.
extern "C" int fs_refine_keypoints_per_block(int t, int R) {
  const int per = (int)sizeof(float) * Geometry(t, R).floats();
  const int kp = 48 * 1024 / per;
  return kp < 1 ? 1 : (kp > kMaxKeypointsPerBlock ? kMaxKeypointsPerBlock : kp);
}

extern "C" int fs_refine_cost(const float* img0, const float* img1, const int* xi0, const int* yi0,
                              const int* xi1, const int* yi1, const int* nvalid, float* cost, int B, int K,
                              int H0, int W0, int H1, int W1, int t, int R, cudaStream_t stream) {
  if (t < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const long long BK = (long long)B * K;
  if (BK == 0) return 0;
  if (BK > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = device_setup.get((const void*)refine_cost_kernel, false, &optin);
  if (err != cudaSuccess) return (int)err;
  const int kp = fs_refine_keypoints_per_block(t, R);
  const size_t smem = (size_t)kp * sizeof(float) * Geometry(t, R).floats();
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((BK + kp - 1) / kp);
  refine_cost_kernel<<<blocks, 32 * kp, smem, stream>>>(img0, img1, xi0, yi0, xi1, yi1, nvalid, cost, (int)BK, K,
                                                        H0, W0, H1, W1, t, R);
  return (int)cudaGetLastError();
}
