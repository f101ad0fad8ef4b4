// ORB detection pooled per 8x8 cell, every pyramid level of a batch in one
// launch.
//
// Replaces the TPU kernel frontend/pallas_detect.py:_detect_kernel (wrapper
// detect_pooled_batched, with the column pooling it finished in XLA), which
// ran once per level. For each pixel (y, x) of image b of level l:
//
//   fast  = FAST-9 segment test over the 16-pixel ring, true where 9
//           contiguous ring pixels are all brighter than centre + t or all
//           darker than centre - t, t = max(threshold, 0), and the pixel is
//           at least 3 px inside the image
//   rank  = Harris response where fast holds and the pixel lies inside the
//           edge margin, -inf elsewhere
//   kept  = rank where rank >= max of its 3x3 neighbourhood (ties survive)
//
// and per 8x8 cell the largest kept rank with its flat index y * W + x in the
// level's own width. Out-of-image taps read zeros and out-of-image pixels rank
// -inf, as the XLA path's zero padding and padding to a cell multiple do. Ties
// inside a cell go to the first pixel in row-major order; an empty cell holds
// -inf and the index of its top-left pixel.
//
// The FAST gate is the plain version's `score > threshold && score > 0`
// (frontend/fast.py:fast_score_map): the best 9-arc's smallest difference
// exceeds t exactly when all nine differences do. The differences are the
// same float subtractions, so the gate is bit-identical. Harris sums its taps
// in the plain version's order (utils/filters.py: Sobel rows then columns, the
// box sum rows then columns, each tap in turn) with __fadd_rn / __fmul_rn,
// which nvcc never contracts into FMAs, so kernel and plain version agree bit
// for bit. A box sum starts from -0, which adds to any x as x, so it equals
// the plain sum that starts from its first tap.
//
// What bounds it on the H100. A 960x600 frame's eight levels are 1.78 Mpx,
// 7.1 MB of float32 read once (2.1 us of HBM time). The operations, as the
// data gates them (chip_smoke.py counts them): every pixel inside the margin
// pays the exact early reject (4 differences, 8 compares: every 9-arc holds
// at least two of ring points 0, 4, 8 and 12); a pixel past it the other 12
// differences, 24 compares and two run-of-9 tests on 16-bit masks (52);
// Harris only the rows that hold a corner (Sobel, products and box row sums,
// 31 a pixel) and each corner (box column sums, response, NMS: 34). On
// random levels that is about 1.3 G operations a batch of 8 frames, 0.0195 ms
// at the float32 rate, against 0.017 ms for the bytes. The kernel is bound by
// neither: by the issue of its integer, compare and shared-memory
// instructions around those operations (PERF.md has the phase times).
//
// Design, against what held the one-level kernel back:
// 1. One launch per batch: the level table (pointers, sizes, first block of
//    each level) goes to the kernel by value; the 1D grid runs over (level,
//    tile, image), largest level first, so the small levels fill in behind the
//    big one instead of each paying a launch and a drain.
// 2. FAST as two 16-bit masks (bright: d > t, dark: d < -t) and a circular
//    run-of-9 test of shifts and ands; no float arrays stay live. The early
//    reject runs at every pixel, and its survivors are compacted into a list
//    (a ballot and one shared atomic a warp), so the segment test runs 32
//    candidates to a warp instead of idling the lanes whose pixel was
//    rejected; its corners are compacted the same way.
// 3. Harris only where it is needed: a tile with no corner skips it; else one
//    thread per (product column, segment of kSeg rank rows) walks down its
//    column keeping three image rows and the last seven gradient products in
//    registers, and writes box row sums only for rank rows that hold a corner
//    (segments without one skip the walk); the column sums, the response and
//    3x3 NMS run once per listed corner, and each kept response takes its
//    cell by a 64-bit atomicMax of (value, in-cell index) keys, which gives
//    the same answer in any order. The products never touch shared memory:
//    a block of 32x32 outputs holds the image tile, the box row sums, the
//    rank map and a corner list, 30.5 KB (42.6 KB before), with five
//    barriers after the tile load, two of them after the corners.
// The tile is 32x32 pixels with 256 threads: on the card 16-row tiles were
// 4-8% slower, and 64-row tiles 7-17% slower in an earlier form of the
// kernel (PERF.md). Registers (-Xptxas -v, sm_90a): 47, no spills; so 5
// blocks of 256 threads an SM.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCell = 8;
constexpr int kTileH = 32;                  // output rows per block
constexpr int kTileW = 32;                  // output columns per block
constexpr int kThreads = 8 * kTileH;
constexpr int kHalo = 5;                    // NMS 1 + max(ring 3, Sobel 1 + box 3)
constexpr int kBoxMax = 3;                  // largest box radius the halo covers
constexpr int kImgW = kTileW + 2 * kHalo;   // image tile width (42)
constexpr int kRankW = kTileW + 2;          // rank region width: tile + NMS ring (34)
constexpr int kProdW = kRankW + 2 * kBoxMax;  // gradient product columns (40)
constexpr int kSeg = 6;                     // rank rows per thread in the box-row phase
constexpr int kMaxLevels = 16;
constexpr int kImgH = kTileH + 2 * kHalo;
constexpr int kRankH = kTileH + 2;
constexpr int kSegs = (kRankH + kSeg - 1) / kSeg;
constexpr int kCellsX = kTileW / kCell;
constexpr int kCells = (kTileH / kCell) * kCellsX;
constexpr int kLoads = (kImgH * kImgW + kThreads - 1) / kThreads;  // image loads a thread
static_assert(kSegs * kProdW <= kThreads, "one thread per (product column, segment)");
static_assert(kRankH * kRankW <= 65536, "rank pixel indices fit 16 bits");

// The levels of one launch, passed by value. Level l's blocks are
// [start[l], start[l + 1]), tile-major with the image inner.
struct Levels {
  const float* img[kMaxLevels];
  float* vals[kMaxLevels];
  int* idx[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels], tiles_x[kMaxLevels];
  int start[kMaxLevels + 1];
  int n, B;
};

// FAST-16 Bresenham ring of radius 3, clockwise from 12 o'clock
// (frontend/fast.py:FAST_OFFSETS), as offsets in the image tile
#define RING(dy, dx) ((dy) * kImgW + (dx))
__constant__ int kRing[16] = {RING(-3, 0), RING(-3, 1), RING(-2, 2),  RING(-1, 3),
                              RING(0, 3),  RING(1, 3),  RING(2, 2),   RING(3, 1),
                              RING(3, 0),  RING(3, -1), RING(2, -2),  RING(1, -3),
                              RING(0, -3), RING(-1, -3), RING(-2, -2), RING(-3, -1)};
#undef RING

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// one separable 3-tap pass, taps summed left to right (utils/filters.py)
__device__ __forceinline__ float taps3(float a, float b, float c, float k0, float k1, float k2) {
  return add(add(mul(a, k0), mul(b, k1)), mul(c, k2));
}

// some 9 circularly contiguous bits of a 16-bit mask are all set
__device__ __forceinline__ bool run_of_9(unsigned m) {
  m |= m << 16;                // bits 16..31 repeat 0..15
  unsigned r = m & (m >> 1);   // bit s: bits s..s+1 set
  r &= r >> 2;                 // s..s+3
  r &= r >> 4;                 // s..s+7
  r &= m >> 8;                 // s..s+8
  return (r & 0xffffu) != 0u;
}

// the exact early reject of the FAST-9 test at p (a pointer into the image
// tile): every 9-arc holds at least two of ring points 0, 4, 8 and 12
__device__ __forceinline__ bool maybe_corner(const float* p, float t) {
  const float c = p[0];
  const float d0 = p[kRing[0]] - c, d4 = p[kRing[4]] - c, d8 = p[kRing[8]] - c, d12 = p[kRing[12]] - c;
  const int nb = (d0 > t) + (d4 > t) + (d8 > t) + (d12 > t);
  const int nd = (d0 < -t) + (d4 < -t) + (d8 < -t) + (d12 < -t);
  return nb >= 2 || nd >= 2;
}

// the FAST-9 segment test at p
__device__ __forceinline__ bool segment_test(const float* p, float t) {
  const float c = p[0];
  unsigned bright = 0u, dark = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = p[kRing[k]] - c;
    bright |= (unsigned)(d > t) << k;
    dark |= (unsigned)(d < -t) << k;
  }
  return run_of_9(bright) || run_of_9(dark);
}

// the warp appends the e of its lanes where pred holds to list (one shared
// atomic a warp); the order across warps varies, and nothing depends on it
__device__ __forceinline__ void append(unsigned short* list, int* count, bool pred, int e, int lane) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (m == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (pred) list[base + __popc(m & ((1u << lane) - 1u))] = (unsigned short)e;
}

// a kept response's key in its cell: the larger value first, then the
// smaller in-cell index p (row-major); 0 is an empty cell. -0 counts as +0,
// so equal values tie as the plain version's compares make them.
__device__ __forceinline__ unsigned long long cell_key(float v, int p) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned)(kCell * kCell - 1 - p);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__global__ void __launch_bounds__(kThreads)
detect_levels_kernel(const __grid_constant__ Levels L, int box_r, int margin, float t, float scale,
                     float harris_k) {
  constexpr int kRankN = kRankH * kRankW;
  __shared__ float img[kImgH * kImgW];
  // the early reject's survivors (phases 1-2), then the rank map: Harris at
  // each corner, -inf elsewhere (phases 3-5)
  __shared__ float rank[kRankN];
  __shared__ float rows[3][kRankH][kProdW];  // box sums over rows, for rank rows with a corner
  __shared__ unsigned short corners[kRankN];
  __shared__ unsigned long long keys[kCells];
  __shared__ unsigned char row_any[kRankH];  // the rank row holds a corner
  __shared__ int n_cand, n_corner;
  unsigned short* cand = reinterpret_cast<unsigned short*>(rank);

  // which level, tile and image: the largest level holds the first blocks
  const int bid = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n && bid >= L.start[l + 1]) ++l;
  const int local = bid - L.start[l];
  const int tile = local / L.B, b = local % L.B;
  const int H = L.h[l], W = L.w[l];
  const int y0 = (tile / L.tiles_x[l]) * kTileH, x0 = (tile % L.tiles_x[l]) * kTileW;
  const float* I = L.img[l] + (size_t)b * H * W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // image tile: img[i * kImgW + j] is pixel (y0 - kHalo + i, x0 - kHalo + j);
  // every load is in flight before the first store waits on one
  {
    float v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int e = tid + k * kThreads;
      const int i = e / kImgW, j = e % kImgW;
      const int y = y0 - kHalo + i, x = x0 - kHalo + j;
      v[k] = (e < kImgH * kImgW && y >= 0 && y < H && x >= 0 && x < W) ? I[(size_t)y * W + x] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (tid + k * kThreads < kImgH * kImgW) img[tid + k * kThreads] = v[k];
  }
  if (tid < kCells) keys[tid] = 0ull;
  if (tid < kRankH) row_any[tid] = 0;
  if (tid == 0) n_cand = n_corner = 0;
  __syncthreads();

  // rank pixel (r, c) is pixel (y0 - 1 + r, x0 - 1 + c), image-tile position
  // (r + 4, c + 4), index e = r * kRankW + c. FAST's 3-pixel border and the
  // edge margin leave the rank pixels r_lo <= r < r_hi, c_lo <= c < c_hi.
  const int edge = max(3, margin);
  const int r_lo = edge - (y0 - 1), r_hi = H - edge - (y0 - 1);
  const int c_lo = edge - (x0 - 1), c_hi = W - edge - (x0 - 1);

  // 1. the early reject at every rank pixel; the survivors become candidates
  for (int e0 = warp * 32; e0 < kRankN; e0 += kThreads) {
    const int e = e0 + lane, r = e / kRankW, c = e % kRankW;
    const bool pass = e < kRankN && r >= r_lo && r < r_hi && c >= c_lo && c < c_hi &&
                      maybe_corner(&img[(r + 4) * kImgW + c + 4], t);
    append(cand, &n_cand, pass, e, lane);
  }
  __syncthreads();

  // 2. the segment test at the candidates, 32 to a warp whatever their place
  const int nc = n_cand;
  for (int i0 = warp * 32; i0 < nc; i0 += kThreads) {
    const int i = i0 + lane;
    const int e = i < nc ? cand[i] : 0;
    const bool hit = i < nc && segment_test(&img[(e / kRankW + 4) * kImgW + e % kRankW + 4], t);
    if (hit) row_any[e / kRankW] = 1;
    append(corners, &n_corner, hit, e, lane);
  }
  __syncthreads();

  const int ncy = (H + kCell - 1) / kCell, ncx = (W + kCell - 1) / kCell;
  const int nk = n_corner;
  if (nk > 0) {
    for (int e = tid; e < kRankN; e += kThreads) rank[e] = -CUDART_INF_F;

    // 3. box sums over rows. Thread (seg, q) walks product column q (pixel
    // x0 - 4 + q) down product rows p = r0 .. r0 + kSeg + 5 (pixel
    // y0 - 4 + p, image-tile row p + 1), r0 = seg * kSeg; rank row r sums
    // product rows r + 3 - box_r .. r + 3 + box_r, the window's middle
    // 2 box_r + 1 of seven.
    if (tid < kSegs * kProdW) {
      const int q = tid % kProdW, r0 = (tid / kProdW) * kSeg;
      unsigned seg = 0u;  // the segment's rank rows that hold a corner
#pragma unroll
      for (int i = 0; i < kSeg; ++i)
        if (r0 + i < kRankH && row_any[r0 + i]) seg |= 1u << i;
      if (seg != 0u) {
        const int x = x0 - 4 + q;
        const bool x_in = x >= 0 && x < W;
        float a[3][3];    // image rows p, p + 1, p + 2 at tile columns q, q + 1, q + 2
        float win[7][3];  // products of product rows p - 6 .. p: gx*gx, gy*gy, gx*gy
#pragma unroll
        for (int k = 0; k < 7; ++k) win[k][0] = win[k][1] = win[k][2] = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a[1][c] = img[r0 * kImgW + q + c];
          a[2][c] = img[(r0 + 1) * kImgW + q + c];
        }
#pragma unroll
        for (int i = 0; i < kSeg + 6; ++i) {
          const int p = r0 + i;
          if (p > kRankH + 5) break;  // only rank rows past the region need more
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            a[0][c] = a[1][c];
            a[1][c] = a[2][c];
            a[2][c] = img[(p + 2) * kImgW + q + c];
          }
          float xx = 0.f, yy = 0.f, xy = 0.f;  // zero outside the image
          const int y = y0 - 4 + p;
          if (x_in && y >= 0 && y < H) {
            float s[3], d[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              s[c] = taps3(a[0][c], a[1][c], a[2][c], 1.f, 2.f, 1.f);   // gx: smooth over rows
              d[c] = taps3(a[0][c], a[1][c], a[2][c], -1.f, 0.f, 1.f);  // gy: derivative over rows
            }
            const float gx = mul(taps3(s[0], s[1], s[2], -1.f, 0.f, 1.f), scale);
            const float gy = mul(taps3(d[0], d[1], d[2], 1.f, 2.f, 1.f), scale);
            xx = mul(gx, gx);
            yy = mul(gy, gy);
            xy = mul(gx, gy);
          }
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            win[k][0] = win[k + 1][0];
            win[k][1] = win[k + 1][1];
            win[k][2] = win[k + 1][2];
          }
          win[6][0] = xx;
          win[6][1] = yy;
          win[6][2] = xy;
          if (i >= 6 && ((seg >> (i - 6)) & 1u)) {
            const int r = p - 6;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              float acc = -0.f;
#pragma unroll
              for (int k = 0; k < 7; ++k)
                if (k >= kBoxMax - box_r && k <= kBoxMax + box_r) acc = add(acc, win[k][ch]);
              rows[ch][r][q] = acc;
            }
          }
        }
      }
    }
    __syncthreads();

    // 4. Harris at each corner
    for (int i = tid; i < nk; i += kThreads) {
      const int e = corners[i], r = e / kRankW, c = e % kRankW;
      float bxx = -0.f, byy = -0.f, bxy = -0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        if (k >= kBoxMax - box_r && k <= kBoxMax + box_r) {
          bxx = add(bxx, rows[0][r][c + k]);
          byy = add(byy, rows[1][r][c + k]);
          bxy = add(bxy, rows[2][r][c + k]);
        }
      }
      const float det = __fsub_rn(mul(bxx, byy), mul(bxy, bxy));
      const float tr = add(bxx, byy);
      rank[e] = __fsub_rn(det, mul(mul(harris_k, tr), tr));
    }
    __syncthreads();

    // 5. 3x3 NMS at each corner of the tile (ties survive), and its cell's
    // largest key
    for (int i = tid; i < nk; i += kThreads) {
      const int e = corners[i], r = e / kRankW, c = e % kRankW;
      if (r < 1 || r > kTileH || c < 1 || c > kTileW) continue;  // the NMS ring
      const float v = rank[e];
      if (!isfinite(v)) continue;
      float m = v;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, rank[e + dy * kRankW + dx]);
      if (v >= m) {
        const int cell = ((r - 1) / kCell) * kCellsX + (c - 1) / kCell;
        atomicMax(&keys[cell], cell_key(v, ((r - 1) % kCell) * kCell + (c - 1) % kCell));
      }
    }
    __syncthreads();
  }

  // 6. per cell: the largest kept response and its index y * W + x; an
  // empty cell holds -inf and its top-left pixel
  if (tid < kCells) {
    const int cy = y0 / kCell + tid / kCellsX, cx = x0 / kCell + tid % kCellsX;
    if (cy < ncy && cx < ncx) {
      const unsigned long long key = keys[tid];
      const int p = key ? kCell * kCell - 1 - (int)(key & 0xffffffffull) : 0;
      const size_t o = ((size_t)b * ncy + cy) * ncx + cx;
      L.vals[l][o] = key ? key_value(key) : -CUDART_INF_F;
      L.idx[l][o] = (cy * kCell + p / kCell) * W + cx * kCell + p % kCell;
    }
  }
}

}  // namespace

// One launch over n_levels (B, hs[l], ws[l]) float32 levels: vals[l] and
// idx[l] are (B, ceil(h/8), ceil(w/8)). block_start[l] is the first block of
// level l (32x32 tiles times B blocks each), block_start[n_levels]
// the grid; the caller orders the levels, largest first.
extern "C" int fs_detect_levels(const float* const* images, float* const* vals, int* const* idx, const int* hs,
                                const int* ws, const int* block_start, int n_levels, int B,
                                int harris_block, int margin, float threshold, float scale, float harris_k,
                                cudaStream_t stream) {
  const int box_r = harris_block / 2;
  if (n_levels < 1 || n_levels > kMaxLevels || B < 1 || box_r > kBoxMax || harris_block % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.n = n_levels;
  L.B = B;
  L.start[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    L.img[l] = images[l];
    L.vals[l] = vals[l];
    L.idx[l] = idx[l];
    L.h[l] = hs[l];
    L.w[l] = ws[l];
    L.tiles_x[l] = (ws[l] + kTileW - 1) / kTileW;
    const long long blocks = (long long)((hs[l] + kTileH - 1) / kTileH) * L.tiles_x[l] * B;
    if (block_start[l] != L.start[l] || (long long)block_start[l + 1] - block_start[l] != blocks)
      return (int)cudaErrorInvalidValue;
    L.start[l + 1] = block_start[l + 1];
  }
  const float t = fmaxf(threshold, 0.f);
  detect_levels_kernel<<<L.start[L.n], kThreads, 0, stream>>>(L, box_r, margin, t, scale, harris_k);
  return (int)cudaGetLastError();
}
