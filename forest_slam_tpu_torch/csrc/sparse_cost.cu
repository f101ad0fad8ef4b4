// Per-keypoint stereo SAD cost rows.
//
// Replaces the TPU kernel stereo/pallas_sparse.py:_cost_kernel (wrapper
// sparse_cost_rows_pallas). For keypoint k of frame b at integer (x, y):
//
//   cost[b, k, d] = sum_{|dy|,|dx| <= r} |L[y+dy, x+dx] - R[y+dy, x+dx-d]|
//
// over the x-Sobel-prefiltered images, zero outside the image, with the
// keypoint clamped into the image first (the dynamic_slice semantics of the
// gather path, stereo/sparse.py:_cost_rows_gather). The output is indexed by
// disparity d directly (the TPU kernel wrote j = D-1-d and reversed outside).
//
// What bounds it on the H100: neither resource is close. A frame at
// K=1024, D=96, w=7 moves ~3 MB of windows and output (about 1 us of HBM
// time) and does 14 M scalar operations; the kernel is latency-bound on
// its K small blocks. Design: one block per keypoint loads the w x w left
// patch and the w x (D+w-1) right strip into shared memory once, then one
// thread per disparity sums its w*w absolute differences from shared
// memory. No atomics, so results are deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void sparse_cost_kernel(const float* __restrict__ left,
                                   const float* __restrict__ right,
                                   const int* __restrict__ xi,
                                   const int* __restrict__ yi,
                                   float* __restrict__ cost, int K, int H,
                                   int W, int D, int w) {
  extern __shared__ float smem[];
  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  const int r = w / 2;
  const int S = D + w - 1;
  float* patch = smem;         // (w, w)
  float* strip = smem + w * w; // (w, S)
  const int x = min(max(xi[bk], 0), W - 1);
  const int y = min(max(yi[bk], 0), H - 1);
  const float* L = left + (size_t)b * H * W;
  const float* R = right + (size_t)b * H * W;

  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int yy = y - r + i / w;
    const int xx = x - r + i % w;
    patch[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? L[yy * W + xx] : 0.f;
  }
  // strip column j holds right-image column x - (D - 1) - r + j
  for (int i = threadIdx.x; i < w * S; i += blockDim.x) {
    const int yy = y - r + i / S;
    const int xx = x - (D - 1) - r + i % S;
    strip[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? R[yy * W + xx] : 0.f;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int j0 = D - 1 - d;  // the window of disparity d starts here
    float acc = 0.f;
    for (int dy = 0; dy < w; ++dy) {
      const float* prow = patch + dy * w;
      const float* srow = strip + dy * S + j0;
      for (int dx = 0; dx < w; ++dx) acc += fabsf(prow[dx] - srow[dx]);
    }
    cost[(size_t)bk * D + d] = acc;
  }
}

}  // namespace

extern "C" int fs_sparse_cost(const float* left, const float* right,
                              const int* xi, const int* yi, float* cost,
                              int B, int K, int H, int W, int D, int w,
                              cudaStream_t stream) {
  if (B * K == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(w * w + w * (D + w - 1));
  sparse_cost_kernel<<<B * K, kThreads, smem, stream>>>(left, right, xi, yi,
                                                        cost, K, H, W, D, w);
  return (int)cudaGetLastError();
}
