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
// zero outside the images, taps summed in (ty, tx) row-major order like the
// XLA path's fori_loop (frontend/refine.py:_cost_volume_xla). Rows k at or
// past nvalid[b] are written as exact zeros without any compute: callers
// compact the valid keypoints to the front, so work scales with the matched
// fraction.
//
// What bounds it on the H100: scalar operations, lightly. At K=1024, R=12,
// t=8 a pair needs 1024*625*64*3 = 123 M operations (about 2 us at the
// 67 TFLOP/s float32 rate) against ~6.6 MB of windows and output (2 us of
// HBM time); the block-per-keypoint design reads each window once into
// shared memory and every thread sums its offsets' taps from there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void refine_cost_kernel(const float* __restrict__ img0,
                                   const float* __restrict__ img1,
                                   const int* __restrict__ xi0,
                                   const int* __restrict__ yi0,
                                   const int* __restrict__ xi1,
                                   const int* __restrict__ yi1,
                                   const int* __restrict__ nvalid,
                                   float* __restrict__ cost, int K, int H0,
                                   int W0, int H1, int W1, int t, int R) {
  extern __shared__ float smem[];
  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  const int k = bk % K;
  const int n = 2 * R + 1;
  const int S = n + t - 1;
  const int ht = t / 2;
  float* out = cost + (size_t)bk * n * n;
  if (k >= nvalid[b]) {
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) out[i] = 0.f;
    return;
  }
  float* tpl = smem;          // (t, t)
  float* win = smem + t * t;  // (S, S)
  const float* I0 = img0 + (size_t)b * H0 * W0;
  const float* I1 = img1 + (size_t)b * H1 * W1;
  const int x0 = xi0[bk] - ht, y0 = yi0[bk] - ht;
  const int x1 = xi1[bk] - ht - R, y1 = yi1[bk] - ht - R;
  for (int i = threadIdx.x; i < t * t; i += blockDim.x) {
    const int yy = y0 + i / t, xx = x0 + i % t;
    tpl[i] = (yy >= 0 && yy < H0 && xx >= 0 && xx < W0) ? I0[yy * W0 + xx] : 0.f;
  }
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int yy = y1 + i / S, xx = x1 + i % S;
    win[i] = (yy >= 0 && yy < H1 && xx >= 0 && xx < W1) ? I1[yy * W1 + xx] : 0.f;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < n * n; o += blockDim.x) {
    const int dy = o / n, dx = o % n;
    float acc = 0.f;
    for (int ty = 0; ty < t; ++ty) {
      const float* wrow = win + (dy + ty) * S + dx;
      const float* trow = tpl + ty * t;
      for (int tx = 0; tx < t; ++tx) acc += fabsf(wrow[tx] - trow[tx]);
    }
    out[o] = acc;
  }
}

}  // namespace

extern "C" int fs_refine_cost(const float* img0, const float* img1,
                              const int* xi0, const int* yi0, const int* xi1,
                              const int* yi1, const int* nvalid, float* cost,
                              int B, int K, int H0, int W0, int H1, int W1,
                              int t, int R, cudaStream_t stream) {
  if (B * K == 0) return 0;
  const int S = 2 * R + t;
  const size_t smem = sizeof(float) * (size_t)(t * t + S * S);
  refine_cost_kernel<<<B * K, kThreads, smem, stream>>>(
      img0, img1, xi0, yi0, xi1, yi1, nvalid, cost, K, H0, W0, H1, W1, t, R);
  return (int)cudaGetLastError();
}
