// Exp-domain Sinkhorn with a dustbin, then the row and column argmax decode.
//
// Replaces the TPU kernel frontend/pallas_sinkhorn.py:_sinkhorn_kernel
// (wrapper sinkhorn_decode). Per pair, with s masked to NEG where either
// keypoint is invalid, r_i = max(rowmax_j s_ij, alpha) and
// khat_ij = exp(s_ij - r_i) (exactly 0 where masked), the iteration is
//
//   A_i  = v0_i / max(sum_j khat_ij V_j + binc_i Vbin, tiny)
//   Abin = n1   / max(sum_j v1_j V_j + Vbin, tiny)
//   V_j  = v1_j / max(sum_i khat_ij A_i + v1_j Abin, tiny)
//   Vbin = n0   / max(sum_i binc_i A_i + Abin, tiny)
//
// with binc_i = v0_i exp(alpha - r_i), starting from V = Vbin = 1. The
// decode takes best1_i = first argmax_j khat_ij V_j, sc0_i = A_i * max,
// best0_j = first argmax_i khat_ij A_i, sc1_j = V_j * max.
//
// What bounds it on the H100: memory, through L2. Each half-step sweeps the
// pair's (K0, K1) score table once (4 MB at K=1024, 40 sweeps per pair plus
// the decode); the table of a pair batch stays in the 50 MB L2. The TPU
// kernel held the table in VMEM; a block's 227 KB of shared memory cannot,
// and a grid-wide barrier is not needed: every half-step is its own launch
// (a row kernel and a column kernel), and khat is recomputed from the
// scores in each sweep, so the couplings never reach memory. Row sweeps
// give each row one warp; column sweeps give each block 32 columns and
// 8 row groups reduced in shared memory. No atomics: results are
// deterministic.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// first-index argmax combine: larger value wins, ties go to the lower index
__device__ __forceinline__ void argmax_combine(float& v, int& i, float v2,
                                               int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_combine(v, i, v2, i2);
  }
}

// r_i and binc_i; one warp per row
__global__ void sk_prep(const float* __restrict__ scores,
                        const float* __restrict__ valid0,
                        const float* __restrict__ valid1,
                        const float* __restrict__ alpha, float* __restrict__ r,
                        float* __restrict__ binc, int K0, int K1) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= K0) return;
  const float v0 = valid0[b * K0 + i];
  const float* srow = scores + ((size_t)b * K0 + i) * K1;
  const float* v1 = valid1 + (size_t)b * K1;
  float m = -3.402823466e38f;
  for (int j = lane; j < K1; j += 32) {
    const float s = (v0 * v1[j] > 0.f) ? srow[j] : kNeg;
    m = fmaxf(m, s);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) {
    const float ri = fmaxf(m, alpha[0]);
    r[b * K0 + i] = ri;
    binc[b * K0 + i] = v0 * expf(alpha[0] - ri);
  }
}

// Row half-step (decode == 0) or row decode (decode == 1); one warp per row.
__global__ void sk_rows(const float* __restrict__ scores,
                        const float* __restrict__ valid0,
                        const float* __restrict__ valid1,
                        const float* __restrict__ r,
                        const float* __restrict__ binc,
                        const float* __restrict__ n1,
                        const float* __restrict__ V,
                        const float* __restrict__ Vbin, float* __restrict__ A,
                        float* __restrict__ Abin, int* __restrict__ best1,
                        float* __restrict__ sc0, int K0, int K1, int decode) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (blockDim.x / 32) + warp;
  const float* v1 = valid1 + (size_t)b * K1;
  const float* Vb = V + (size_t)b * K1;
  if (!decode && blockIdx.x == 0 && warp == 0) {
    float acc = 0.f;
    for (int j = lane; j < K1; j += 32) acc += v1[j] * Vb[j];
    acc = warp_sum(acc);
    if (lane == 0) Abin[b] = n1[b] / fmaxf(acc + Vbin[b], kTiny);
  }
  if (i >= K0) return;
  const float v0 = valid0[b * K0 + i];
  const float ri = r[b * K0 + i];
  const float* srow = scores + ((size_t)b * K0 + i) * K1;
  if (!decode) {
    float acc = 0.f;
    for (int j = lane; j < K1; j += 32)
      acc += ((v0 * v1[j] > 0.f) ? expf(srow[j] - ri) : 0.f) * Vb[j];
    acc = warp_sum(acc);
    if (lane == 0)
      A[b * K0 + i] = v0 / fmaxf(acc + binc[b * K0 + i] * Vbin[b], kTiny);
  } else {
    float best = -1.f;
    int bi = K1;
    for (int j = lane; j < K1; j += 32) {
      const float m = ((v0 * v1[j] > 0.f) ? expf(srow[j] - ri) : 0.f) * Vb[j];
      argmax_combine(best, bi, m, j);
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      best1[b * K0 + i] = bi;
      sc0[b * K0 + i] = A[b * K0 + i] * best;
    }
  }
}

constexpr int kColW = 32;  // columns per block
constexpr int kColG = 8;   // row groups per block

// Column half-step (decode == 0) or column decode (decode == 1).
__global__ void sk_cols(const float* __restrict__ scores,
                        const float* __restrict__ valid0,
                        const float* __restrict__ valid1,
                        const float* __restrict__ r,
                        const float* __restrict__ binc,
                        const float* __restrict__ n0,
                        const float* __restrict__ A,
                        const float* __restrict__ Abin, float* __restrict__ V,
                        float* __restrict__ Vbin, int* __restrict__ best0,
                        float* __restrict__ sc1, int K0, int K1, int decode) {
  __shared__ float red_v[kColG][kColW];
  __shared__ int red_i[kColG][kColW];
  const int b = blockIdx.y;
  const int tx = threadIdx.x % kColW;
  const int ty = threadIdx.x / kColW;
  const int j = blockIdx.x * kColW + tx;
  const float* v0 = valid0 + (size_t)b * K0;
  const float* rb = r + (size_t)b * K0;
  const float* Ab = A + (size_t)b * K0;
  const float* sb = scores + (size_t)b * K0 * K1;
  const float v1 = (j < K1) ? valid1[b * K1 + j] : 0.f;

  if (!decode && blockIdx.x == 0) {
    // Vbin from the new A: block 0 of the pair, reduced like a column
    float acc = 0.f;
    for (int i = threadIdx.x; i < K0; i += blockDim.x)
      acc += binc[b * K0 + i] * Ab[i];
    red_v[ty][tx] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
      for (int g = 0; g < kColG; ++g)
        for (int c = 0; c < kColW; ++c) tot += red_v[g][c];
      Vbin[b] = n0[b] / fmaxf(tot + Abin[b], kTiny);
    }
    __syncthreads();
  }

  if (!decode) {
    float acc = 0.f;
    if (j < K1)
      for (int i = ty; i < K0; i += kColG)
        acc += ((v0[i] * v1 > 0.f) ? expf(sb[(size_t)i * K1 + j] - rb[i]) : 0.f) *
               Ab[i];
    red_v[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && j < K1) {
      float tot = 0.f;
      for (int g = 0; g < kColG; ++g) tot += red_v[g][tx];
      V[b * K1 + j] = v1 / fmaxf(tot + v1 * Abin[b], kTiny);
    }
  } else {
    float best = -1.f;
    int bi = K0;
    if (j < K1)
      for (int i = ty; i < K0; i += kColG) {
        const float m =
            ((v0[i] * v1 > 0.f) ? expf(sb[(size_t)i * K1 + j] - rb[i]) : 0.f) *
            Ab[i];
        argmax_combine(best, bi, m, i);
      }
    red_v[ty][tx] = best;
    red_i[ty][tx] = bi;
    __syncthreads();
    if (ty == 0 && j < K1) {
      for (int g = 1; g < kColG; ++g)
        argmax_combine(best, bi, red_v[g][tx], red_i[g][tx]);
      best0[b * K1 + j] = bi;
      sc1[b * K1 + j] = V[b * K1 + j] * best;
    }
  }
}

}  // namespace

// scores (B, K0, K1) f32; valid0 (B, K0), valid1 (B, K1) f32 0/1; alpha (1,);
// n0, n1 (B,) valid counts. Scratch r, binc, A (B, K0); V (B, K1) and
// Vbin, Abin (B,) must hold ones in V and Vbin on entry.
extern "C" int fs_sinkhorn_decode(const float* scores, const float* valid0,
                                  const float* valid1, const float* alpha,
                                  const float* n0, const float* n1, float* r,
                                  float* binc, float* A, float* Abin, float* V,
                                  float* Vbin, int* best1, float* sc0,
                                  int* best0, float* sc1, int B, int K0,
                                  int K1, int iters, cudaStream_t stream) {
  if (B == 0 || K0 == 0 || K1 == 0) return 0;
  const int rows_per_block = 8;
  const dim3 row_grid((K0 + rows_per_block - 1) / rows_per_block, B);
  const dim3 col_grid((K1 + kColW - 1) / kColW, B);
  sk_prep<<<row_grid, 32 * rows_per_block, 0, stream>>>(scores, valid0, valid1,
                                                        alpha, r, binc, K0, K1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < iters; ++it) {
    sk_rows<<<row_grid, 32 * rows_per_block, 0, stream>>>(
        scores, valid0, valid1, r, binc, n1, V, Vbin, A, Abin, nullptr,
        nullptr, K0, K1, 0);
    sk_cols<<<col_grid, kColW * kColG, 0, stream>>>(
        scores, valid0, valid1, r, binc, n0, A, Abin, V, Vbin, nullptr,
        nullptr, K0, K1, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sk_rows<<<row_grid, 32 * rows_per_block, 0, stream>>>(
      scores, valid0, valid1, r, binc, n1, V, Vbin, A, Abin, best1, sc0, K0,
      K1, 1);
  sk_cols<<<col_grid, kColW * kColG, 0, stream>>>(
      scores, valid0, valid1, r, binc, n0, A, Abin, V, Vbin, best0, sc1, K0,
      K1, 1);
  return (int)cudaGetLastError();
}
