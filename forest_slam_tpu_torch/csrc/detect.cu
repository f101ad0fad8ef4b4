// ORB detection of one pyramid level, pooled per 8x8 cell.
//
// Replaces the TPU kernel frontend/pallas_detect.py:_detect_kernel (wrapper
// detect_pooled_batched, with the column pooling it finished in XLA). For
// each pixel (y, x) of image b:
//
//   fast  = FAST-9 arc score over the 16-pixel ring, kept where > threshold
//           and at least 3 px inside the image (else 0)
//   rank  = Harris response where fast > 0 and the pixel lies inside the
//           edge margin, -inf elsewhere
//   kept  = rank where rank >= max of its 3x3 neighbourhood (ties survive)
//
// and per 8x8 cell the largest kept rank with its flat index y * W + x.
// Out-of-image taps read zeros and out-of-image pixels rank -inf, as the XLA
// path's zero padding and padding to a cell multiple do. Ties inside a cell
// go to the first pixel in row-major order (smallest y, then smallest x):
// the XLA path's argmax over the flattened cell, not the Pallas kernel's
// column argmax of row maxima.
//
// Harris sums its taps in the plain version's order (utils/filters.py:
// Sobel rows then columns, the box sum rows then columns, each tap in turn)
// with __fadd_rn / __fmul_rn, which nvcc never contracts into FMAs, so the
// kernel and the plain PyTorch version agree bit for bit. FAST uses only
// differences, minima and maxima, which are exact in any order.
//
// What bounds it on the H100: operations. A 960x600 frame's eight levels are
// 1.78 Mpx, 7.1 MB of float32 read once (2.1 us of HBM time), against 32
// float32 operations per pixel (Sobel, products, box row sums), 180 more
// inside the edge margin (FAST's differences and min/max trees) and 34 per
// FAST corner (box column sums, Harris, NMS): about 5 us a frame at
// 67 TFLOP/s (chip_smoke.py counts them from its data). Design, simple
// first: one block per (image, 32x32 output tile) copies the tile and a
// 5-pixel halo (NMS 1 + max(ring 3, Sobel 1 + box 3)) into shared memory,
// computes the gradient products, the box row sums, then FAST and Harris
// per rank pixel (Harris only where FAST fires), and each warp reduces two
// of the tile's sixteen cells with shuffles. No atomics: deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;                // output pixels per block side
constexpr int kCell = 8;
constexpr int kCellsPerSide = kTile / kCell;
constexpr int kHalo = 5;
constexpr int kImg = kTile + 2 * kHalo;  // image tile side (42)
constexpr int kRank = kTile + 2;         // rank region side: tile + NMS ring
constexpr int kBoxMax = 3;               // largest box radius the halo covers
constexpr int kProd = kRank + 2 * kBoxMax;  // gradient products side (40)
constexpr int kThreads = 256;

// FAST-16 Bresenham ring of radius 3, clockwise from 12 o'clock
// (frontend/fast.py:FAST_OFFSETS)
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// one separable 3-tap pass, taps summed left to right (utils/filters.py)
__device__ __forceinline__ float taps3(float a, float b, float c, float k0, float k1, float k2) {
  return add(add(mul(a, k0), mul(b, k1)), mul(c, k2));
}

__global__ void __launch_bounds__(kThreads)
detect_kernel(const float* __restrict__ images, float* __restrict__ vals,
              int* __restrict__ idx, int H, int W, int box_r, int margin,
              float threshold, float scale, float harris_k) {
  __shared__ float img[kImg][kImg];
  __shared__ float prod[3][kProd][kProd];  // gx*gx, gy*gy, gx*gy; then the rank map
  __shared__ float rows[3][kRank][kProd];  // box sums over rows
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const float* I = images + (size_t)b * H * W;
  const int tid = threadIdx.x;
  const float neg_inf = -CUDART_INF_F;

  // image tile: img[i][j] is pixel (y0 - kHalo + i, x0 - kHalo + j)
  for (int e = tid; e < kImg * kImg; e += kThreads) {
    const int i = e / kImg, j = e % kImg;
    const int y = y0 - kHalo + i, x = x0 - kHalo + j;
    img[i][j] = (y >= 0 && y < H && x >= 0 && x < W) ? I[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  // gradient products: prod[.][p][q] is pixel (y0 - 4 + p, x0 - 4 + q),
  // image-tile position (p + 1, q + 1); zero outside the image, as the box
  // filter's zero padding of the product maps
  for (int e = tid; e < kProd * kProd; e += kThreads) {
    const int p = e / kProd, q = e % kProd;
    const int y = y0 - 4 + p, x = x0 - 4 + q;
    float xx = 0.f, yy = 0.f, xy = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int i = p + 1, j = q + 1;
      float s[3], d[3];  // row passes at columns j-1, j, j+1
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float a0 = img[i - 1][j - 1 + c], a1 = img[i][j - 1 + c], a2 = img[i + 1][j - 1 + c];
        s[c] = taps3(a0, a1, a2, 1.f, 2.f, 1.f);   // gx: smooth over rows
        d[c] = taps3(a0, a1, a2, -1.f, 0.f, 1.f);  // gy: derivative over rows
      }
      const float gx = mul(taps3(s[0], s[1], s[2], -1.f, 0.f, 1.f), scale);
      const float gy = mul(taps3(d[0], d[1], d[2], 1.f, 2.f, 1.f), scale);
      xx = mul(gx, gx);
      yy = mul(gy, gy);
      xy = mul(gx, gy);
    }
    prod[0][p][q] = xx;
    prod[1][p][q] = yy;
    prod[2][p][q] = xy;
  }
  __syncthreads();

  // box sums over rows: rows[.][r][q] for rank row r (product row r + 3)
  const int n = 2 * box_r + 1;
  for (int e = tid; e < kRank * kProd; e += kThreads) {
    const int r = e / kProd, q = e % kProd;
    const int p0 = r + kBoxMax - box_r;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = prod[c][p0][q];
      for (int t = 1; t < n; ++t) acc = add(acc, prod[c][p0 + t][q]);
      rows[c][r][q] = acc;
    }
  }
  __syncthreads();

  // rank map over the tile and its NMS ring: rank[r][c] is pixel
  // (y0 - 1 + r, x0 - 1 + c), image-tile position (r + 4, c + 4); it reuses
  // the product buffer, which nothing reads any more
  float* rank = &prod[0][0][0];
  for (int e = tid; e < kRank * kRank; e += kThreads) {
    const int r = e / kRank, c = e % kRank;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float v = neg_inf;
    const bool inside = y >= 3 && y < H - 3 && x >= 3 && x < W - 3 && y >= margin &&
                        y < H - margin && x >= margin && x < W - margin;
    if (inside) {
      const float center = img[r + 4][c + 4];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = img[r + 4 + kRingDy[k]][c + 4 + kRingDx[k]] - center;
      // minima and maxima over circular windows of 2, 4, 8, then 9
      float lo[16], hi[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        lo[k] = fminf(d[k], d[(k + 1) & 15]);
        hi[k] = fmaxf(d[k], d[(k + 1) & 15]);
      }
      float lo4[16], hi4[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        lo4[k] = fminf(lo[k], lo[(k + 2) & 15]);
        hi4[k] = fmaxf(hi[k], hi[(k + 2) & 15]);
      }
      float bright = neg_inf, dark_max = CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float lo8 = fminf(lo4[k], lo4[(k + 4) & 15]);
        const float hi8 = fmaxf(hi4[k], hi4[(k + 4) & 15]);
        bright = fmaxf(bright, fminf(lo8, d[(k + 8) & 15]));
        dark_max = fminf(dark_max, fmaxf(hi8, d[(k + 8) & 15]));
      }
      const float score = fmaxf(bright, -dark_max);
      if (score > threshold && score > 0.f) {
        const int q0 = c + kBoxMax - box_r;
        float bxx = rows[0][r][q0], byy = rows[1][r][q0], bxy = rows[2][r][q0];
        for (int t = 1; t < n; ++t) {
          bxx = add(bxx, rows[0][r][q0 + t]);
          byy = add(byy, rows[1][r][q0 + t]);
          bxy = add(bxy, rows[2][r][q0 + t]);
        }
        const float det = __fsub_rn(mul(bxx, byy), mul(bxy, bxy));
        const float tr = add(bxx, byy);
        v = __fsub_rn(det, mul(mul(harris_k, tr), tr));
      }
    }
    rank[r * kRank + c] = v;
  }
  __syncthreads();

  // 3x3 NMS and the cell argmax: each warp reduces whole cells, each lane
  // two of a cell's 64 pixels (row-major p), then shuffles keep the larger
  // value and, on a tie, the smaller p
  const int ncy = (H + kCell - 1) / kCell, ncx = (W + kCell - 1) / kCell;
  const int warp = tid / 32, lane = tid % 32;
  for (int cell = warp; cell < kCellsPerSide * kCellsPerSide; cell += kThreads / 32) {
    const int cyl = cell / kCellsPerSide, cxl = cell % kCellsPerSide;
    float best = neg_inf;
    int bestp = kCell * kCell;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const int ry = cyl * kCell + p / kCell + 1, rx = cxl * kCell + p % kCell + 1;
      const float v = rank[ry * kRank + rx];
      float kept = neg_inf;
      if (isfinite(v)) {
        float m = v;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, rank[(ry + dy) * kRank + rx + dx]);
        if (v >= m) kept = v;
      }
      if (kept > best || (kept == best && p < bestp)) {
        best = kept;
        bestp = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int op = __shfl_xor_sync(0xffffffffu, bestp, off);
      if (ov > best || (ov == best && op < bestp)) {
        best = ov;
        bestp = op;
      }
    }
    const int cy = blockIdx.y * kCellsPerSide + cyl, cx = blockIdx.x * kCellsPerSide + cxl;
    if (lane == 0 && cy < ncy && cx < ncx) {
      const size_t o = ((size_t)b * ncy + cy) * ncx + cx;
      vals[o] = best;
      idx[o] = (cy * kCell + bestp / kCell) * W + cx * kCell + bestp % kCell;
    }
  }
}

}  // namespace

extern "C" int fs_detect_pooled(const float* images, float* vals, int* idx, int B,
                                int H, int W, int harris_block, int margin,
                                float threshold, float scale, float harris_k,
                                cudaStream_t stream) {
  if (B == 0) return 0;
  const int box_r = harris_block / 2;
  if (box_r > kBoxMax || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  detect_kernel<<<grid, kThreads, 0, stream>>>(images, vals, idx, H, W, box_r, margin,
                                               threshold, scale, harris_k);
  return (int)cudaGetLastError();
}
