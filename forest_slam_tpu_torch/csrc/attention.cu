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
// K = S = 1024 the two products of the reference are 17.2 GFLOP of bf16
// (0.0174 ms at 989 TFLOP/s) against 33.6 MB of traffic (0.0100 ms at
// 3.35 TB/s). The kernel is the shared core of attention_core.cuh: all
// products on the tensor cores through mma.sync with ldmatrix operands, the
// logits and the bf16 probabilities kept in registers, k and v through a
// two-stage cp.async ring. To divide before the bf16 cast it sweeps the
// sources twice and does three products (25.8 GFLOP), not two. One block of
// four warps per 64 queries of one (batch, head): a grid of
// (ceil(K / 64), B * h) blocks.

#include "attention_core.cuh"

namespace {

using attn_core::bf16;

__global__ void __launch_bounds__(attn_core::THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const unsigned char* __restrict__ mask, bf16* __restrict__ o, int heads, int K, int S,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.y;
  const size_t qo = (size_t)bh * K * attn_core::DH, kv = (size_t)bh * S * attn_core::DH;
  attn_core::attend(q + qo, k + kv, v + kv, attn_core::DH, attn_core::DH, mask + (size_t)(bh / heads) * S,
                    o + qo, attn_core::DH, K, S, scale, blockIdx.x * attn_core::QT, smem);
}

attn_core::SmemReservation attention_smem;

}  // namespace

// q, o (B, h, K, 64), k, v (B, h, S, 64) bf16, contiguous and 16-byte
// aligned; mask (B, S) bool (one byte each).
extern "C" int fs_masked_attention(const bf16* q, const bf16* k, const bf16* v,
                                   const unsigned char* mask, bf16* o, int B,
                                   int heads, int K, int S, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || heads == 0 || K == 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const int smem = attn_core::smem_bytes(S);
  const cudaError_t err = attention_smem.allow((const void*)attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + attn_core::QT - 1) / attn_core::QT, B * heads);
  attention_kernel<<<grid, attn_core::THREADS, smem, stream>>>(q, k, v, mask, o, heads, K, S, scale);
  return (int)cudaGetLastError();
}
