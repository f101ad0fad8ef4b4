// Masked multi-head attention for SuperGlue's unfused GNN layer (bf16).
//
// Replaces the TPU kernel frontend/pallas_attention.py:_attn_kernel
// (wrapper fused_attention). For q (B, h, K, 64), k and v (B, h, S, 64) bf16
// and a (B, S) bool source mask, per (batch, head) and query row:
//
//   logit_s = (q . k_s) * scale                      float32
//   logit_s = NEG (-1e9) where source s is masked
//   p_s     = exp(logit_s - max_s logit) / max(sum_s exp(...), 1e-30)
//   out     = bf16(sum_s bf16(p_s) v_s)               float32 sums
//
// The probabilities are normalised before their bf16 cast, as the
// reference does; a row whose sources are all masked averages v over S.
//
// What bounds it on the H100: operations. At B*h = 64 sequences of
// K = S = 1024 the two products are 17.2 GFLOP of bf16 against 33.6 MB of
// traffic, above the card's ridge point. This first version puts both
// products on the tensor cores through WMMA (mma.sync, bf16 operands,
// float32 accumulators). One block of four warps takes 64 queries of one
// (batch, head), each warp 16 of them, and keeps its q fragments in
// registers. It sweeps the sources twice in tiles of 64, copied to shared
// memory: the first sweep finds each row's maximum and sum (online), the
// second recomputes the logits, writes the normalised bf16 probabilities to
// shared memory and multiplies them by the v tile into accumulators that
// stay in registers. The logits are computed twice (three products instead
// of two) so that the division comes before the bf16 cast without keeping
// a whole row of logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kNeg = -1e9f;
constexpr int DH = 64;      // head width
constexpr int QT = 64;      // queries per block
constexpr int ST = 64;      // sources per tile
constexpr int WARPS = 4;    // 16 query rows each
constexpr int LDB = DH + 8; // bf16 row stride in shared memory (elements)
constexpr int LDF = ST + 4; // float row stride of the logits tile

// shared memory, in bytes; every region starts on a 32-byte boundary as
// WMMA requires
constexpr int kTileBytes = ST * LDB * 2;                 // 9216
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kTileBytes;                // also holds q at the start
constexpr int kOffL = kOffV + kTileBytes;
constexpr int kOffP = kOffL + WARPS * 16 * LDF * 4;
constexpr int kOffM = kOffP + WARPS * 16 * LDB * 2;
constexpr int kSmemBytes = kOffM + ST * 4;               // 45,312

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int nrows) {
  // a (64 x 64) bf16 tile of rows row0.. of src into dst (stride LDB),
  // zero past nrows; 16 bytes a thread per step
  for (int i = threadIdx.x; i < 64 * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DH)[c];
    *reinterpret_cast<uint4*>(dst + r * LDB + c * 8) = val;
  }
}

// logits of this warp's 16 queries against the 64 sources of the tile in
// Ks, unscaled, into Lw (16 x LDF floats)
__device__ __forceinline__ void tile_logits(
    float* Lw, const bf16* Ks,
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* qf) {
#pragma unroll
  for (int j = 0; j < ST / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + (j * 16) * LDB + kk * 16, LDB);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(Lw + j * 16, acc, LDF, wmma::mem_row_major);
  }
}

// grid (ceil(K / QT), B * h); 128 threads. Lane l of a warp owns row l / 2
// of the warp's 16 and tile columns (l % 2) * 32 .. + 31 for the softmax.
__global__ void __launch_bounds__(WARPS * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const unsigned char* __restrict__ mask, bf16* __restrict__ o,
                 int heads, int K, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kOffV);
  float* Ls = reinterpret_cast<float*>(smem + kOffL);
  bf16* Ps = reinterpret_cast<bf16*>(smem + kOffP);
  int* Ms = reinterpret_cast<int*>(smem + kOffM);  // 1 valid, 0 masked, -1 past S

  const int bh = blockIdx.y, q0 = blockIdx.x * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane / 2, col0 = (lane % 2) * 32;
  const bf16* qb = q + (size_t)bh * K * DH;
  const bf16* kb = k + (size_t)bh * S * DH;
  const bf16* vb = v + (size_t)bh * S * DH;
  const unsigned char* mb = mask + (size_t)(bh / heads) * S;
  float* Lw = Ls + warp * 16 * LDF;
  bf16* Pw = Ps + warp * 16 * LDB;

  // q of this block, through the v buffer, into fragments kept in registers
  load_rows(Vs, qb, q0, K);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Vs + (warp * 16) * LDB + kk * 16, LDB);

  // sweep 1: row maximum and sum of exponentials (online)
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < S; s0 += ST) {
    __syncthreads();
    load_rows(Ks, kb, s0, S);
    for (int i = threadIdx.x; i < ST; i += blockDim.x)
      Ms[i] = s0 + i < S ? (mb[s0 + i] ? 1 : 0) : -1;
    __syncthreads();
    tile_logits(Lw, Ks, qf);
    __syncwarp();
    float mt = -INFINITY;
    for (int c = col0; c < col0 + 32; ++c) {
      if (Ms[c] < 0) continue;
      const float lg = Ms[c] ? Lw[row * LDF + c] * scale : kNeg;
      mt = fmaxf(mt, lg);
    }
    if (mt > -INFINITY) {
      const float mn = fmaxf(m, mt);
      float add = 0.f;
      for (int c = col0; c < col0 + 32; ++c) {
        if (Ms[c] < 0) continue;
        const float lg = Ms[c] ? Lw[row * LDF + c] * scale : kNeg;
        add += expf(lg - mn);
      }
      l = l * expf(m - mn) + add;
      m = mn;
    }
    __syncwarp();
  }
  const float M = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float L = m > -INFINITY ? l * expf(m - M) : 0.f;
  L += __shfl_xor_sync(0xffffffffu, L, 1);
  const float denom = fmaxf(L, 1e-30f);

  // sweep 2: p = bf16(exp(logit - M) / denom), out += p @ v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(of[j], 0.f);
  for (int s0 = 0; s0 < S; s0 += ST) {
    __syncthreads();
    load_rows(Ks, kb, s0, S);
    load_rows(Vs, vb, s0, S);
    for (int i = threadIdx.x; i < ST; i += blockDim.x)
      Ms[i] = s0 + i < S ? (mb[s0 + i] ? 1 : 0) : -1;
    __syncthreads();
    tile_logits(Lw, Ks, qf);
    __syncwarp();
    for (int c = col0; c < col0 + 32; ++c) {
      float p = 0.f;
      if (Ms[c] >= 0) {
        const float lg = Ms[c] ? Lw[row * LDF + c] * scale : kNeg;
        p = expf(lg - M) / denom;
      }
      Pw[row * LDB + c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < ST / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, LDB);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + (kk * 16) * LDB + j * 16, LDB);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Lw + j * 16, of[j], LDF, wmma::mem_row_major);
  __syncwarp();
  const int qi = q0 + warp * 16 + row;
  if (qi < K) {
    bf16* ob = o + ((size_t)bh * K + qi) * DH;
    for (int c = col0; c < col0 + 32; ++c) ob[c] = __float2bfloat16(Lw[row * LDF + c]);
  }
}

}  // namespace

// q, o (B, h, K, 64), k, v (B, h, S, 64) bf16, contiguous and 16-byte
// aligned; mask (B, S) bool (one byte each).
extern "C" int fs_masked_attention(const bf16* q, const bf16* k, const bf16* v,
                                   const unsigned char* mask, bf16* o, int B,
                                   int heads, int K, int S, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || heads == 0 || K == 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + QT - 1) / QT, B * heads);
  attention_kernel<<<grid, WARPS * 32, kSmemBytes, stream>>>(q, k, v, mask, o,
                                                             heads, K, S, scale);
  return (int)cudaGetLastError();
}
