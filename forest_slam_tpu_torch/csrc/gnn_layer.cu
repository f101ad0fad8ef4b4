// One whole SuperGlue GNN layer for inference (bf16 activations).
//
// Replaces the TPU kernel frontend/pallas_gnn.py:_layer_kernel (wrapper
// fused_gnn_layer). For x (N, K, D), src (N, S, D), a source mask and the
// per-head split weights of split_layer_params:
//
//   q, k, v = bf16(bf16(x|src @ W) + b)                  per head, f32 sums
//   p       = bf16(softmax_f32(mask ? q.k * scale : NEG))
//   o_h     = bf16(p @ v_h)
//   merged  = bf16(bf16(sum_h o_h @ Wm_h) + bm)
//   y       = bf16(bf16(x @ W0a + merged @ W0b) + b0)
//   yr      = bf16(relu(LayerNorm_f32(y) * scale + bias))  eps 1e-6
//   out     = bf16(x + bf16(bf16(yr @ W1) + b1))
//
// casting to bf16 exactly where the TPU kernel does (pallas_gnn.py:103-152).
//
// What bounds it on the H100: operations. A layer call at N = 16 sequences
// of K = S = 1024 does ~21 GFLOP of projections and MLP and ~13 GFLOP of
// attention products against ~40 MB of traffic, far above the card's
// ridge point. This first version is correct and simple, not fast: the
// products run on the CUDA cores as shared-memory tiled float32 FMAs over
// exact bf16 inputs (no tensor cores yet), in six launches per layer:
//   1. q, k, v projections (one tiled GEMM launch each),
//   2. attention: per (sequence, head, 64 queries) block, a first sweep over
//      the sources for the row max and sum (online), a second for the
//      normalised bf16 probabilities and their product with v,
//   3. merge projection, 4. MLP0 over [x, merged] without the concat,
//   5. LayerNorm + ReLU (one warp per row), 6. MLP1 + residual.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e9f;
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------- GEMM ---
// C[m, n] = epilogue(sum_k A[m, k] W[k, n]) with
//   A[m, k] = k < Ka ? A1[m, k] : A2[m, k - Ka]       (row-major, bf16)
//   W[k, n] = k < Ka ? W1[k, n] : W2[k - Ka, n]       (head-split, bf16)
// where a head-split weight (h, Kpart, dh) holds column n = h*dh + j at
// [n / dh][k][n % dh] (dh = N for a plain row-major weight), and
//   epilogue(acc) = bf16(res + bf16(bf16(acc) + bias))   (res optional).
constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(256)
gemm_kernel(const bf16* __restrict__ A1, const bf16* __restrict__ A2,
            const bf16* __restrict__ W1, const bf16* __restrict__ W2, int Ka,
            int dh, const bf16* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ C, int M, int N, int Kd) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Kb = Kd - Ka;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kd; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += blockDim.x) {
      const int mm = idx / BK, kk = idx % BK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < Kd)
        v = k < Ka ? to_f(A1[(size_t)m * Ka + k])
                   : to_f(A2[(size_t)m * Kb + (k - Ka)]);
      As[kk][mm] = v;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += blockDim.x) {
      const int kk = idx / BN, nn = idx % BN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < Kd && n < N) {
        const int h = n / dh, j = n % dh;
        v = k < Ka ? to_f(W1[((size_t)h * Ka + k) * dh + j])
                   : to_f(W2[((size_t)h * Kb + (k - Ka)) * dh + j]);
      }
      Ws[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = round_bf(round_bf(acc[i][j]) + to_f(bias[n]));
      if (res) v = to_f(res[(size_t)m * N + n]) + v;
      C[(size_t)m * N + n] = __float2bfloat16(v);
    }
  }
}

// ----------------------------------------------------------- attention ---
constexpr int AQ = 64;   // queries per block
constexpr int AS = 64;   // sources per tile
constexpr int DH = 64;   // head width
constexpr int LD = DH + 1;

// grid (ceil(K / AQ), heads, N); 256 threads: thread t owns query row
// t / 4 and tile columns (t % 4) + 4 j, j < 16.
__global__ void __launch_bounds__(256)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 bf16* __restrict__ o, int K, int S, int D, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;               // (AQ, LD)
  float* Ks = Qs + AQ * LD;     // (AS, LD)
  float* Vs = Ks + AS * LD;     // (AS, LD)
  float* Ps = Vs + AS * LD;     // (AQ, AS + 1)
  float* Ms = Ps + AQ * (AS + 1);  // (AS,)
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AQ;
  const int tid = threadIdx.x;
  const int row = tid / 4, cq = tid % 4;
  const bf16* qb = q + (size_t)n * K * D + h * DH;
  const bf16* kb = k + (size_t)n * S * D + h * DH;
  const bf16* vb = v + (size_t)n * S * D + h * DH;
  const float* mb = mask + (size_t)n * S;

  for (int idx = tid; idx < AQ * DH; idx += blockDim.x) {
    const int rr = idx / DH, d = idx % DH;
    Qs[rr * LD + d] = (q0 + rr < K) ? to_f(qb[(size_t)(q0 + rr) * D + d]) : 0.f;
  }

  // sweep 1: row max and sum of exp (online, per thread, then merged)
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < S; s0 += AS) {
    __syncthreads();
    for (int idx = tid; idx < AS * DH; idx += blockDim.x) {
      const int rr = idx / DH, d = idx % DH;
      Ks[rr * LD + d] = (s0 + rr < S) ? to_f(kb[(size_t)(s0 + rr) * D + d]) : 0.f;
    }
    for (int idx = tid; idx < AS; idx += blockDim.x)
      Ms[idx] = (s0 + idx < S) ? mb[s0 + idx] : 0.f;
    __syncthreads();
    float lg[16];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = cq + 4 * j;
      float dot = 0.f;
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[row * LD + d], Ks[c * LD + d], dot);
      lg[j] = (Ms[c] > 0.5f) ? dot * scale : kNeg;
      if (s0 + c < S) mt = fmaxf(mt, lg[j]);
    }
    if (mt > -INFINITY) {
      const float mn = fmaxf(m, mt);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (s0 + cq + 4 * j < S) add += expf(lg[j] - mn);
      l = l * expf(m - mn) + add;
      m = mn;
    }
  }
  // merge the four threads of a row
  float M = m;
  M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 1));
  M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
  float L = (m > -INFINITY) ? l * expf(m - M) : 0.f;
  L += __shfl_xor_sync(0xffffffffu, L, 1);
  L += __shfl_xor_sync(0xffffffffu, L, 2);
  const float denom = fmaxf(L, 1e-30f);

  // sweep 2: p = bf16(exp(logit - M) / denom), o += p @ v
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += AS) {
    __syncthreads();
    for (int idx = tid; idx < AS * DH; idx += blockDim.x) {
      const int rr = idx / DH, d = idx % DH;
      const bool in = s0 + rr < S;
      Ks[rr * LD + d] = in ? to_f(kb[(size_t)(s0 + rr) * D + d]) : 0.f;
      Vs[rr * LD + d] = in ? to_f(vb[(size_t)(s0 + rr) * D + d]) : 0.f;
    }
    for (int idx = tid; idx < AS; idx += blockDim.x)
      Ms[idx] = (s0 + idx < S) ? mb[s0 + idx] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = cq + 4 * j;
      float p = 0.f;
      if (s0 + c < S) {
        float dot = 0.f;
        for (int d = 0; d < DH; ++d) dot = fmaf(Qs[row * LD + d], Ks[c * LD + d], dot);
        const float lgt = (Ms[c] > 0.5f) ? dot * scale : kNeg;
        p = round_bf(expf(lgt - M) / denom);
      }
      Ps[row * (AS + 1) + c] = p;
    }
    __syncthreads();
    for (int s = 0; s < AS; ++s) {
      const float p = Ps[row * (AS + 1) + s];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(p, Vs[s * LD + cq + 4 * j], acc[j]);
    }
  }
  if (q0 + row < K) {
    bf16* ob = o + ((size_t)n * K + q0 + row) * D + h * DH;
#pragma unroll
    for (int j = 0; j < 16; ++j) ob[cq + 4 * j] = __float2bfloat16(acc[j]);
  }
}

// ----------------------------------------------------- LayerNorm + ReLU ---
// one warp per row of width C; f32 statistics
__global__ void layernorm_relu_kernel(const bf16* __restrict__ y,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      bf16* __restrict__ out, int rows, int C) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* yr = y + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(yr[c]);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(yr[c]) - mu;
    ss += d * d;
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = 1.f / sqrtf(ss / C + kLnEps);
  bf16* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float yn = (to_f(yr[c]) - mu) * inv * gamma[c] + beta[c];
    orow[c] = __float2bfloat16(fmaxf(yn, 0.f));
  }
}

int gemm(const bf16* A1, const bf16* A2, const bf16* W1, const bf16* W2,
         int Ka, int dh, const bf16* bias, const bf16* res, bf16* C, int M,
         int N, int Kd, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<<<grid, 256, 0, stream>>>(A1, A2, W1, W2, Ka, dh, bias, res, C,
                                        M, N, Kd);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, K, D), src (N, S, D) bf16; mask (N, S) f32 0/1. Weights as
// split_layer_params lays them out: wq/wk/wv (h, D, dh), bq/bk/bv (h*dh),
// wm (h*dh, D), bm (D), w0a/w0b (D, 2D), b0 (2D), ln_scale/ln_bias (2D) f32,
// w1 (2D, D), b1 (D). Scratch: qs (N*K, D), ks/vs (N*S, D), os/ms (N*K, D),
// ys/yr (N*K, 2D), all bf16. out (N, K, D) bf16.
extern "C" int fs_gnn_layer(const bf16* x, const bf16* src, const float* mask,
                            const bf16* wq, const bf16* bq, const bf16* wk,
                            const bf16* bk, const bf16* wv, const bf16* bv,
                            const bf16* wm, const bf16* bm, const bf16* w0a,
                            const bf16* w0b, const bf16* b0,
                            const float* ln_scale, const float* ln_bias,
                            const bf16* w1, const bf16* b1, bf16* qs,
                            bf16* ks, bf16* vs, bf16* os, bf16* ms, bf16* ys,
                            bf16* yr, bf16* out, int N, int K, int S, int D,
                            int heads, cudaStream_t stream) {
  if (N == 0 || K == 0) return 0;
  const int dh = D / heads;
  if (dh != DH || dh * heads != D) return (int)cudaErrorInvalidValue;
  const int MK = N * K, MS = N * S;
  int err;
  if ((err = gemm(x, nullptr, wq, nullptr, D, dh, bq, nullptr, qs, MK, D, D, stream))) return err;
  if ((err = gemm(src, nullptr, wk, nullptr, D, dh, bk, nullptr, ks, MS, D, D, stream))) return err;
  if ((err = gemm(src, nullptr, wv, nullptr, D, dh, bv, nullptr, vs, MS, D, D, stream))) return err;

  const size_t smem = sizeof(float) * (size_t)(AQ * LD + 2 * AS * LD + AQ * (AS + 1) + AS);
  cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 agrid((K + AQ - 1) / AQ, heads, N);
  attention_kernel<<<agrid, 256, smem, stream>>>(qs, ks, vs, mask, os, K, S, D,
                                                 1.f / sqrtf((float)dh));
  if ((err = (int)cudaGetLastError())) return err;

  if ((err = gemm(os, nullptr, wm, nullptr, D, D, bm, nullptr, ms, MK, D, D, stream))) return err;
  if ((err = gemm(x, ms, w0a, w0b, D, 2 * D, b0, nullptr, ys, MK, 2 * D, 2 * D, stream))) return err;
  const int rows_per_block = 8;
  layernorm_relu_kernel<<<(MK + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, stream>>>(
      ys, ln_scale, ln_bias, yr, MK, 2 * D);
  if ((err = (int)cudaGetLastError())) return err;
  return gemm(yr, nullptr, w1, nullptr, 2 * D, D, b1, x, out, MK, D, 2 * D, stream);
}
