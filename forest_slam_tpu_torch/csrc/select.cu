// SuperPoint keypoint selection: (2R+1)^2 NMS, threshold and border, pooled
// per 4x4 block.
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
// Pixels outside the image read -inf, so they never win a window maximum.
// Only comparisons: agrees with the plain version bit for bit.
//
// What bounds it on the H100: bytes, and close behind them the comparisons.
// It must read the heat once (4 bytes a pixel) and write 8 bytes per 16
// pixels: 0.0062 ms at (8, 600, 960). A window maximum done plainly costs
// 2 x 2R = 16 fmax a pixel at R = 4, and fmax issues at half the float32
// rate, so the plain count alone would take longer than the bytes.
//
// Design (the first form staged 32x64 tiles through shared memory in three
// barrier-separated phases, 30 KB a block, half the threads idle while
// pooling). The heat never touches shared memory:
// 1. A lane owns one aligned float4, the 4 columns of one pooled block, and
//    a band of kBandRows = 8 output rows. The band's rows and its 4*HL halo
//    rows a side (HL = ceil(R/4)) are loaded into registers up front with
//    16-byte loads, so each warp has 16 loads in flight at R = 4. On an
//    H100 80GB HBM3 (scripts/torch_kernel_variants.py) 8-row bands took
//    0.0097-0.0098 ms at (8, 600, 960) and 0.0054 ms at (24, 256, 352),
//    16-row ones 0.0104 and 0.0067, 32-row ones 0.0125 and 0.0086, 12 rows
//    fell between: more, smaller warps fill the card better than reading
//    fewer halo rows saves.
// 2. Window maxima are separable: over rows in each lane's registers, then
//    over columns from the neighbouring lanes' float4s by __shfl_up/down;
//    the HL lanes at each edge of a warp are halo and write nothing. Both
//    use one split (span_max): a window is the suffix of its first group of
//    4, whole groups, and the prefix of its last group, built in a fixed
//    order so that the windows of neighbouring rows and columns share them.
//    At R = 4 that is 17 fmax per 4 outputs where the plain chain takes 32.
// 3. After every 4 rows a lane holds a whole 4x4 block in registers: the
//    three tests and the row-major argmax run there, no barrier at all.
// R is a template parameter (0..8, one instantiation each, chosen by a
// switch on the host), so every loop unrolls and every array is registers.
// The launch plan (warps across a row, bands, blocks) is computed by the
// wrapper (select_kernel.launch_plan) and checked here. -Xptxas -v (sm_90a):
// 92 registers at R = 4, no spills, no shared memory (R = 5 spills 4 bytes);
// capping registers for more blocks an SM (__launch_bounds__ minimum 4 or
// 6, the same script) was no faster.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlock = 4;      // pooled block edge = the columns a lane owns
constexpr int kBandRows = 8;   // output rows a warp computes
constexpr int kWarps = 4;      // warps a block
constexpr int kMaxR = 8;

__host__ __device__ constexpr int halo_lanes(int R) { return (R + 3) / 4; }

// max of a[lo..hi]; lo and hi are constants once the caller's loops are
// unrolled, so every test below folds away. The window is cut at multiples
// of 4: the suffix of lo's group (built from its end), the whole groups
// between (each built from its start), the prefix of hi's group (from its
// start). Equal pieces of neighbouring windows are equal expressions, which
// the compiler computes once.
template <int N>
__device__ __forceinline__ float span_max(const float (&a)[N], int lo, int hi) {
  const int glo = lo & ~3, ghi = hi & ~3;
  if (glo == ghi) {
    float m = a[lo];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (lo + j <= hi) m = fmaxf(m, a[lo + j]);
    return m;
  }
  float s = a[glo + 3];
#pragma unroll
  for (int j = 2; j >= 0; --j)
    if (glo + j >= lo) s = fmaxf(a[glo + j], s);
  float p = a[ghi];
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (ghi + j <= hi) p = fmaxf(p, a[ghi + j]);
  float f = 0.f;
  bool whole = false;
#pragma unroll
  for (int g = 4; g < N; g += 4) {
    if (glo + g < ghi) {
      const int o = glo + g;
      const float m = fmaxf(fmaxf(fmaxf(a[o], a[o + 1]), a[o + 2]), a[o + 3]);
      f = whole ? fmaxf(f, m) : m;
      whole = true;
    }
  }
  return whole ? fmaxf(fmaxf(s, f), p) : fmaxf(s, p);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
select_kernel(const float* __restrict__ heat, float* __restrict__ vals, int* __restrict__ idx, int H, int W,
              int col_warps, int bands, int warps, float threshold, int border) {
  constexpr int HL = halo_lanes(R);
  constexpr int NR = kBandRows + 8 * HL;  // rows a lane loads
  constexpr int NH = 4 * (2 * HL + 1);    // columns a lane sees after the shuffles
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wid >= warps) return;
  const int cw = wid % col_warps, rest = wid / col_warps;
  const int band = rest % bands, b = rest / bands;
  const int W4 = W / kBlock;
  const int c4 = cw * (32 - 2 * HL) + lane - HL;  // the float4 column this lane owns
  const bool col_in = c4 >= 0 && c4 < W4;
  const int y0 = band * kBandRows;  // the band's first output row
  const int yl = y0 - 4 * HL;       // its first loaded row
  const float4* src = reinterpret_cast<const float4*>(heat + (size_t)b * H * W) + (col_in ? c4 : 0);

  float v[4][NR];  // v[column][row]
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int y = yl + r;
    float4 f = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    if (col_in && y >= 0 && y < H) f = __ldg(src + (size_t)y * W4);
    v[0][r] = f.x;
    v[1][r] = f.y;
    v[2][r] = f.z;
    v[3][r] = f.w;
  }
  bool col_ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int x = kBlock * c4 + q;
    col_ok[q] = x >= border && x < W - border;
  }
  const bool writes = col_in && lane >= HL && lane < 32 - HL;

#pragma unroll
  for (int k = 0; k < kBandRows / kBlock; ++k) {
    const int yb = y0 + kBlock * k;  // the block row's first image row
    if (yb >= H) break;
    float kept[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * (k + HL) + i;  // its row in v
      float hr[NH];                     // vertical maxima of lanes lane-HL .. lane+HL
#pragma unroll
      for (int q = 0; q < 4; ++q) hr[4 * HL + q] = span_max(v[q], rr - R, rr + R);
#pragma unroll
      for (int l = 1; l <= HL; ++l) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hr[4 * (HL - l) + q] = __shfl_up_sync(0xffffffffu, hr[4 * HL + q], l);
          hr[4 * (HL + l) + q] = __shfl_down_sync(0xffffffffu, hr[4 * HL + q], l);
        }
      }
      const int y = yb + i;
      const bool row_ok = y >= border && y < H - border;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m = span_max(hr, 4 * HL + q - R, 4 * HL + q + R);
        const float h = v[q][rr];
        kept[4 * i + q] = (row_ok && col_ok[q] && h >= m && h > threshold) ? h : 0.f;
      }
    }
    float best = kept[0];
    int bi = 0;
#pragma unroll
    for (int t = 1; t < 16; ++t) {
      if (kept[t] > best) {
        best = kept[t];
        bi = t;
      }
    }
    if (writes) {
      const size_t o = ((size_t)b * (H / kBlock) + yb / kBlock) * W4 + c4;
      vals[o] = best;
      idx[o] = (yb + bi / 4) * W + kBlock * c4 + bi % 4;
    }
  }
}

template <int R>
cudaError_t launch(const float* heat, float* vals, int* idx, int B, int H, int W, int col_warps, int bands,
                   float threshold, int border, cudaStream_t stream) {
  const int W4 = W / kBlock, lanes = 32 - 2 * halo_lanes(R);
  // the wrapper's plan must cover the image with no warp wholly outside it
  if (col_warps < 1 || bands < 1 || (long long)col_warps * lanes < W4 || (long long)(col_warps - 1) * lanes >= W4 ||
      (long long)bands * kBandRows < H || (long long)(bands - 1) * kBandRows >= H)
    return cudaErrorInvalidValue;
  const long long warps = (long long)B * bands * col_warps;
  if (warps > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  select_kernel<R><<<blocks, 32 * kWarps, 0, stream>>>(heat, vals, idx, H, W, col_warps, bands, (int)warps,
                                                        threshold, border);
  return cudaGetLastError();
}

}  // namespace

// heat (B, H, W) float32, 16-byte aligned, H and W multiples of 4; vals
// (B, H/4, W/4) float32 and idx (B, H/4, W/4) int32 are written. col_warps
// and bands: the wrapper's launch plan (select_kernel.launch_plan).
extern "C" int fs_nms_block_max(const float* heat, float* vals, int* idx, int B, int H, int W, int radius,
                                float threshold, int border, int col_warps, int bands, cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B < 0 || H % kBlock || W % kBlock || ((size_t)heat & 15)) return (int)cudaErrorInvalidValue;
  switch (radius) {
    case 0: return (int)launch<0>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 1: return (int)launch<1>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 2: return (int)launch<2>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 3: return (int)launch<3>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 4: return (int)launch<4>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 5: return (int)launch<5>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 6: return (int)launch<6>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case 7: return (int)launch<7>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    case kMaxR: return (int)launch<kMaxR>(heat, vals, idx, B, H, W, col_warps, bands, threshold, border, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
