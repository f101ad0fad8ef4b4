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
// Each disparity sums its taps from 0 in (dy, dx) row-major order, so float
// inputs give the same sums as the first form of this kernel, and integer
// images (quarter-integer after the prefilter) are exact.
//
// What bounds it on the H100: bytes. A keypoint needs its w x w left patch
// and the w x (D+w-1) right strip; counted as at most one read of each
// image, with the keypoints and the output, that is 23 MB and 0.0069 ms at 8
// frames of K=1024, D=96, w=7. Its 2 float32 operations a tap (a subtract,
// an add of the absolute value) are 9,400 a keypoint, about 0.0023 ms.
//
// Design (the first form ran one 128-thread block per keypoint, 96 threads
// working, copies through registers with runtime divisions, 49 shared loads
// a disparity in loops that did not unroll):
// 1. A warp per keypoint, up to 8 keypoints a block, no block barrier:
//    8192 keypoints are 1024 blocks, where they were 8192.
// 2. Copies of 16 bytes. Each row of the patch and of the strip is copied
//    from the multiple of 4 columns at or left of its first column, into a
//    shared row that starts on 16 bytes: one cp.async a lane and row for
//    the strip at D = 96 (27 chunks), where 4-byte copies take four and
//    their address arithmetic. With W a multiple of 4 a chunk lies wholly
//    inside or wholly outside the image, so the zero fill stays exact.
//    Images whose rows do not start on 16 bytes take 4-byte copies into the
//    same layout: 0.0204 ms at 8 x 1024 where 16-byte copies take 0.0108
//    (scripts/torch_kernel_variants.py, H100 80GB HBM3).
// 3. Register tiling. A lane sums kPerLane = 3 neighbouring disparities;
//    per window row it reads the kPerLane + w - 1 strip values those taps
//    need from shared memory once (9 loads for 21 taps at w = 7, where the
//    first form made 21) at a stride of 3 floats between lanes, which no two
//    lanes of a warp share a bank at; the patch row is one broadcast read.
//    At D = 96 the 32 lanes cover the 96 disparities in one pass.
// 4. w is a template parameter (1..15, a switch on the host), so the tap
//    loops unroll and the strip values live in registers.
// Any D >= 1: more than 96 disparities take more passes over the same
// strip; the wrapper (sparse_kernel.launch_plan) sizes the shared memory,
// above 48 KB through the opt-in limit, and refuses what does not fit.
// -Xptxas -v (sm_90a): 48 registers at w = 7, no spills; 3,376 bytes of
// shared memory a keypoint at D = 96, 8 keypoints a block. A cap of 40
// registers was no faster, one of 32 spilled and was 6% slower (the same
// script).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "device_setup.cuh"

namespace {

constexpr int kPerLane = 3;               // neighbouring disparities a lane sums
constexpr int kPass = 32 * kPerLane;      // disparities a warp sums in one pass
constexpr int kMaxWindow = 15;
constexpr int kMaxKeypointsPerBlock = 8;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// floats of a shared row of the patch and of the strip: the window's
// columns after a shift of up to 3, to a multiple of 4
__host__ __device__ constexpr int patch_stride(int w) { return pad4(w + 3); }
__host__ __device__ constexpr int strip_stride(int D, int w) { return pad4(D + w - 1 + 3); }

// floats of one keypoint's buffer: w patch rows, w strip rows and 4 floats
// that the last lane of a pass may read past the strip's end (for
// disparities past D, whose sums are dropped)
__host__ __device__ constexpr long long keypoint_floats(int D, int w) {
  return (long long)w * patch_stride(w) + (long long)w * strip_stride(D, w) + 4;
}

// The w x w patch whose top-left pixel is (x0, y0) into rows of
// patch_stride(w) floats, the lanes over (row, chunk) pairs of the whole
// patch; returns the column of x0 in a row. vec: 16-byte copies from
// x0 & ~3 (W a multiple of 4, image rows on 16 bytes); else 4-byte copies.
template <int w>
__device__ __forceinline__ int copy_patch(float* dst, const float* img, int H, int W, int x0, int y0, bool vec,
                                          int lane) {
  constexpr int C = patch_stride(w) / 4;  // chunks a row
  const int xa = x0 & ~3;
  if (vec) {
    for (int i = lane; i < w * C; i += 32) {
      const int yy = y0 + i / C, xx = xa + 4 * (i % C);
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async16(dst + 4 * i, in ? img + (size_t)yy * W + xx : img, in);
    }
  } else {
    for (int i = lane; i < w * w; i += 32) {
      const int yy = y0 + i / w, xx = x0 + i % w;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async4(dst + (i / w) * (4 * C) + x0 - xa + i % w, in ? img + (size_t)yy * W + xx : img, in);
    }
  }
  return x0 - xa;
}

// The w x S strip whose top-left pixel is (x0, y0) into rows of `stride`
// floats, a row at a time; returns the column of x0 in a row; vec as above.
template <int w>
__device__ __forceinline__ int copy_strip(float* dst, int stride, const float* img, int H, int W, int x0, int y0,
                                          int S, bool vec, int lane) {
  const int xa = x0 & ~3, chunks = (x0 - xa + S + 3) / 4;
#pragma unroll
  for (int r = 0; r < w; ++r) {
    const int yy = y0 + r;
    const bool row = yy >= 0 && yy < H;
    const float* src = img + (size_t)(row ? yy : 0) * W;
    if (vec) {
      for (int c = lane; c < chunks; c += 32) {
        const int xx = xa + 4 * c;
        const bool in = row && xx >= 0 && xx < W;
        cp_async16(dst + r * stride + 4 * c, in ? src + xx : img, in);
      }
    } else {
      for (int c = lane; c < S; c += 32) {
        const int xx = x0 + c;
        const bool in = row && xx >= 0 && xx < W;
        cp_async4(dst + r * stride + x0 - xa + c, in ? src + xx : img, in);
      }
    }
  }
  return x0 - xa;
}

template <int w>
__global__ void __launch_bounds__(32 * kMaxKeypointsPerBlock)
sparse_cost_kernel(const float* __restrict__ left, const float* __restrict__ right, const int* __restrict__ xi,
                   const int* __restrict__ yi, float* __restrict__ cost, int BK, int K, int H, int W, int D, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int r = w / 2, Pp = patch_stride(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bk = blockIdx.x * (blockDim.x >> 5) + warp;  // b * K + k
  if (bk >= BK) return;
  const int S = D + w - 1, Sp = strip_stride(D, w);
  float* patch = smem + (size_t)warp * keypoint_floats(D, w);  // (w, Pp)
  float* strip = patch + w * Pp;                               // (w, Sp)
  const int b = bk / K;
  const int x = min(max(xi[bk], 0), W - 1), y = min(max(yi[bk], 0), H - 1);
  const int ps = copy_patch<w>(patch, left + (size_t)b * H * W, H, W, x - r, y - r, vec, lane);
  // strip column ss + j holds right-image column x - (D - 1) - r + j
  const int ss = copy_strip<w>(strip, Sp, right + (size_t)b * H * W, H, W, x - (D - 1) - r, y - r, S, vec, lane);
  cp_async_wait_all();
  __syncwarp();

  float* out = cost + (size_t)bk * D;
  for (int base = 0; base < D; base += kPass) {
    const int j0 = base + kPerLane * lane;  // the lane's first window offset j = D-1-d
    if (j0 >= D) continue;
    float acc[kPerLane];
#pragma unroll
    for (int jj = 0; jj < kPerLane; ++jj) acc[jj] = 0.f;
#pragma unroll
    for (int dy = 0; dy < w; ++dy) {
      const float* prow = patch + dy * Pp + ps;
      const float* srow = strip + dy * Sp + ss + j0;
      float sv[kPerLane + w - 1];
#pragma unroll
      for (int c = 0; c < kPerLane + w - 1; ++c) sv[c] = srow[c];
#pragma unroll
      for (int dx = 0; dx < w; ++dx) {
        const float p = prow[dx];
#pragma unroll
        for (int jj = 0; jj < kPerLane; ++jj) acc[jj] += fabsf(p - sv[jj + dx]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kPerLane; ++jj)
      if (j0 + jj < D) out[D - 1 - j0 - jj] = acc[jj];
  }
}

using Kernel = void (*)(const float*, const float*, const int*, const int*, float*, int, int, int, int, int, bool);

struct Instance {
  Kernel kernel;
  DeviceSetup* setup;  // its shared-memory attribute, set once per device
};

template <int w>
Instance instance() {
  static DeviceSetup setup;
  return {sparse_cost_kernel<w>, &setup};
}

Instance instance_for(int w) {
  switch (w) {
    case 1: return instance<1>();
    case 2: return instance<2>();
    case 3: return instance<3>();
    case 4: return instance<4>();
    case 5: return instance<5>();
    case 6: return instance<6>();
    case 7: return instance<7>();
    case 8: return instance<8>();
    case 9: return instance<9>();
    case 10: return instance<10>();
    case 11: return instance<11>();
    case 12: return instance<12>();
    case 13: return instance<13>();
    case 14: return instance<14>();
    case kMaxWindow: return instance<kMaxWindow>();
    default: return {nullptr, nullptr};
  }
}

}  // namespace

// keypoints_per_block and smem_bytes: the wrapper's launch plan
// (sparse_kernel.launch_plan); checked against this kernel's layout and the
// device's opt-in shared memory.
extern "C" int fs_sparse_cost(const float* left, const float* right, const int* xi, const int* yi, float* cost,
                              int B, int K, int H, int W, int D, int w, int keypoints_per_block, int smem_bytes,
                              cudaStream_t stream) {
  const Instance inst = instance_for(w);
  if (!inst.kernel || D < 1 || keypoints_per_block < 1 || keypoints_per_block > kMaxKeypointsPerBlock)
    return (int)cudaErrorInvalidValue;
  if ((long long)smem_bytes < keypoints_per_block * keypoint_floats(D, w) * (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const long long BK = (long long)B * K;
  if (BK == 0) return 0;
  if (BK < 0 || BK > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = inst.setup->get((const void*)inst.kernel, false, &optin);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes > optin) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((BK + keypoints_per_block - 1) / keypoints_per_block);
  int bk = (int)BK;
  // 16-byte copies where every image row starts on 16 bytes
  bool vec = W % 4 == 0 && ((uintptr_t)left & 15) == 0 && ((uintptr_t)right & 15) == 0;
  void* args[] = {&left, &right, &xi, &yi, &cost, &bk, &K, &H, &W, &D, &vec};
  err = cudaLaunchKernel((const void*)inst.kernel, dim3(blocks), dim3(32 * keypoints_per_block), args,
                         (size_t)smem_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
