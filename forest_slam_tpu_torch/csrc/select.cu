// SuperPoint keypoint selection: 9x9 NMS, threshold and border, pooled per
// 4x4 block.
//
// Replaces the TPU kernel frontend/pallas_select.py:_select_kernel (wrapper
// nms_pooled_batched). For a (B, H, W) float32 heat map, H and W multiples
// of 4:
//
//   kept(y, x) = heat   if heat >= max of its (2R+1)^2 window (ties survive),
//                          heat > threshold and the pixel lies outside the
//                          border strip
//              = 0      otherwise
//   vals[b, by, bx] = max of kept over the 4x4 block
//   idx[b, by, bx]  = y * W + x of the first maximum in row-major order
//                     (smallest y, then smallest x; the top-left pixel of an
//                     empty block)
//
// The Pallas kernel emitted per-4-row maxima and left the column pooling to
// XLA; this kernel finishes the 4x4 pooling itself. Pixels outside the image
// read -inf, so they never win a window maximum.
//
// What bounds it on the H100: bytes. It reads the heat once (4 bytes a
// pixel) and writes 8 bytes per 16 pixels; the comparisons are a few dozen
// a pixel. Each block copies a 32x64 tile and its R-pixel halo into shared
// memory once, takes the window maximum separably (rows, then columns) out
// of shared memory, and pools its 8x16 blocks with one thread each, so the
// heat is read from device memory once plus the halo. Only comparisons:
// agrees with the plain version bit for bit.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int TH = 32;  // tile rows
constexpr int TW = 64;  // tile columns
constexpr int PB = 4;   // pooled block edge
constexpr int kMaxR = 8;

__global__ void __launch_bounds__(256)
select_kernel(const float* __restrict__ heat, float* __restrict__ vals,
              int* __restrict__ idx, int H, int W, int R, float threshold,
              int border) {
  extern __shared__ float sm[];
  const int SH = TH + 2 * R, SW = TW + 2 * R;
  float* tile = sm;                // (SH, SW): the heat with its halo
  float* hmax = tile + SH * SW;    // (SH, TW): maxima over rows of the window
  float* kept = hmax + SH * TW;    // (TH, TW)
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float* hb = heat + (size_t)b * H * W;

  for (int i = threadIdx.x; i < SH * SW; i += blockDim.x) {
    const int y = y0 - R + i / SW, x = x0 - R + i % SW;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? hb[(size_t)y * W + x]
                                                   : -INFINITY;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SH * TW; i += blockDim.x) {
    const float* t = tile + (i / TW) * SW + i % TW;
    float m = t[0];
    for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, t[d]);
    hmax[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int r = i / TW, c = i % TW;
    const int y = y0 + r, x = x0 + c;
    float m = hmax[r * TW + c];
    for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, hmax[(r + d) * TW + c]);
    const float h = tile[(r + R) * SW + c + R];
    const bool inside = y >= border && y < H - border && x >= border &&
                        x < W - border;
    kept[i] = (inside && h >= m && h > threshold) ? h : 0.f;
  }
  __syncthreads();
  const int Hb = H / PB, Wb = W / PB;
  for (int i = threadIdx.x; i < (TH / PB) * (TW / PB); i += blockDim.x) {
    const int br = i / (TW / PB), bc = i % (TW / PB);
    const int y = y0 + br * PB, x = x0 + bc * PB;
    if (y >= H || x >= W) continue;
    const float* kb = kept + (br * PB) * TW + bc * PB;
    float best = kb[0];
    int bi = 0;
    for (int t = 1; t < PB * PB; ++t) {
      const float v = kb[(t / PB) * TW + t % PB];
      if (v > best) {
        best = v;
        bi = t;
      }
    }
    const size_t o = ((size_t)b * Hb + y / PB) * Wb + x / PB;
    vals[o] = best;
    idx[o] = (y + bi / PB) * W + x + bi % PB;
  }
}

}  // namespace

// heat (B, H, W) float32, H and W multiples of 4; vals (B, H/4, W/4)
// float32 and idx (B, H/4, W/4) int32 are written.
extern "C" int fs_nms_block_max(const float* heat, float* vals, int* idx,
                                int B, int H, int W, int radius,
                                float threshold, int border,
                                cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (H % PB || W % PB || radius < 0 || radius > kMaxR)
    return (int)cudaErrorInvalidValue;
  const int SH = TH + 2 * radius, SW = TW + 2 * radius;
  const size_t smem = sizeof(float) * (size_t)(SH * SW + SH * TW + TH * TW);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  select_kernel<<<grid, 256, smem, stream>>>(heat, vals, idx, H, W, radius,
                                             threshold, border);
  return (int)cudaGetLastError();
}
