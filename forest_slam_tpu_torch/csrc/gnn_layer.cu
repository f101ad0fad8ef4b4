// One whole SuperGlue or LightGlue GNN layer for inference (bf16 activations).
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
//   yr      = bf16(relu(LayerNorm_f32(y) * scale + bias))  eps 1e-6 (SuperGlue)
//   out     = bf16(x + bf16(bf16(yr @ W1) + b1))
//
// casting to bf16 exactly where the TPU kernel does (pallas_gnn.py:103-152).
//
// Two compile-time variants serve LightGlue's layers (frontend/lightglue.py),
// which have the same shape: a rotary q/k, applied in the projection GEMM's
// epilogue to the bf16 q and k of a self layer (each thread's accumulator
// already holds the column pair (2i, 2i+1) that one rotation mixes):
//
//   q[2i]   = bf16(q[2i] c_i - q[2i+1] s_i)    float32 products and sum,
//   q[2i+1] = bf16(q[2i+1] c_i + q[2i] s_i)    no FMA (the plain version's
//                                               rounding)
//
// with (c_i, s_i) = (cos u_i, sin u_i) of the token, read from a float32
// table (tokens, 32, 2); and GELU (erf) in place of ReLU after the
// LayerNorm. The LayerNorm's eps is an argument (SuperGlue 1e-6, Flax's
// default; LightGlue 1e-5, torch's). SuperGlue's layer takes neither
// variant and runs the arithmetic it ran before they existed. LightGlue's
// cross layer is the plain layer with q and k from one projection.
//
// What bounds it on the H100: operations. A layer call at N = 16 sequences
// of K = S = 1024, D = 256 does 21.5 GFLOP of projections and MLP and 17.2
// GFLOP of attention products against about 27 MB of traffic, far above
// the card's ridge point: 0.0391 ms at 989 TFLOP/s. Every product runs on
// the tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums), in six
// launches per layer:
//   1. q, k and v projections: one GEMM launch, blockIdx.z picks the
//      projection (k and v both read src),
//   2. attention: the shared core of attention_core.cuh on the (N*K, D)
//      projections, token stride D, head h at column h*64,
//   3. merge projection, 4. MLP0 over [x, merged] as two K-ranges of one
//      GEMM (no concat), 5. LayerNorm + ReLU or GELU (one warp per row; it moves
//      2 x 16 MB at the main shape, near the memory rate and a few percent
//      of the layer, so it stays its own launch: fusing it into MLP0's
//      epilogue would need whole 512-wide rows in one block), 6. MLP1 +
//      residual.
// The GEMM takes 128 x 128 output tiles (eight warps of 32 x 64) with a
// three-stage cp.async ring of 128 x 32 A and 32 x 128 W tiles, ldmatrix
// operands (W with .trans, since both weight layouts are row-major in k)
// and the epilogue bf16(res + bf16(bf16(acc) + bias)). Every 64 columns of
// a tile are one head of the head-split q/k/v weights, so no weight is
// repacked. Tiles of 128 x 64 (four warps), of 128 x 128 and 128 x 256 with
// warps of 64 x 64, and four stages were within 7% of this one on the H100
// (scripts/torch_kernel_ab.py).

#include "attention_core.cuh"

namespace {

using attn_core::bf16;
using attn_core::cp_async16;
using attn_core::cp_async_commit;
using attn_core::cp_async_wait;
using attn_core::ldmatrix_x4;
using attn_core::ldmatrix_x4_trans;
using attn_core::mma_bf16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------- GEMM ---
// C[m, n] = epilogue(sum_k A[m, k] W[k, n]) with
//   A[m, k] = k < ka ? a1[m, k] : a2[m, k - ka]       (row-major, bf16)
//   W[k, n] = k < ka ? w1[k, n] : w2[k - ka, n]
// where column n of a weight lies at w[(n / 64) * head_stride + k * ldw +
// n % 64]: head_stride = kpart * 64, ldw = 64 for a head-split (h, kpart,
// 64) weight, head_stride = 64, ldw = N for a row-major one; and
//   epilogue(acc) = bf16(res + bf16(bf16(acc) + bias))   (res optional),
// in gemm_kernel<true> rotated first where rope is set (a (m, 32, 2)
// float32 table of (cos, sin) by row and column pair; N a multiple of 64).
struct Gemm {
  const bf16* a1;
  const bf16* a2;
  int ka;
  const bf16* w1;
  const bf16* w2;
  long long head_stride;
  int ldw;
  const bf16* bias;
  const bf16* res;
  bf16* c;
  int m, n, kd;
  const float* rope;  // read by gemm_kernel<true> only; nullptr: no rotation
};

struct GemmBatch {
  Gemm g[3];
};

// each warp computes a (16 MT) x 64 tile; WARPS_M x WARPS_N warps per block
constexpr int MT = 2, WARPS_M = 4, WARPS_N = 2, GSTAGES = 3, BK = 32;
constexpr int BM = 16 * MT * WARPS_M, BN = 64 * WARPS_N, GTHREADS = 32 * WARPS_M * WARPS_N;
constexpr int LDA = BK + 8;  // 80-byte rows: ldmatrix's eight rows on distinct banks
constexpr int LDW = BN + 8;  // 144-byte rows (and multiples)
constexpr int kAStage = BM * LDA, kWStage = BK * LDW;
constexpr int kGemmSmem = 2 * GSTAGES * (kAStage + kWStage);  // 56,832 bytes

// grid (ceil(max N / BN), ceil(max M / BM), number of GEMMs)
template <bool kRope>
__global__ void __launch_bounds__(GTHREADS) gemm_kernel(const __grid_constant__ GemmBatch batch) {
  const Gemm& p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.m || n0 >= p.n) return;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + GSTAGES * kAStage;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp % WARPS_M) * 16 * MT, wn = (warp / WARPS_M) * 64;  // this warp's tile in the block's
  const int g = lane >> 2, t4 = lane & 3;
  const int ktiles = p.kd / BK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    const bool first = k0 < p.ka;
    const int lda = first ? p.ka : p.kd - p.ka;
    const bf16* a = first ? p.a1 + k0 : p.a2 + (k0 - p.ka);
    bf16* as = As + st * kAStage;
#pragma unroll
    for (int it = 0; it < BM * BK / 8 / GTHREADS; ++it) {
      const int i = tid + it * GTHREADS, r = i >> 2, c = (i & 3) * 8;
      const bool in = m0 + r < p.m;
      cp_async16(as + r * LDA + c, a + (size_t)(in ? m0 + r : 0) * lda + c, in);
    }
    const bf16* w = first ? p.w1 + (size_t)k0 * p.ldw : p.w2 + (size_t)(k0 - p.ka) * p.ldw;
    bf16* ws = Ws + st * kWStage;
#pragma unroll
    for (int it = 0; it < BK * BN / 8 / GTHREADS; ++it) {
      const int i = tid + it * GTHREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8, n = n0 + c;
      const bool in = n < p.n;
      cp_async16(ws + r * LDW + c, w + (in ? (size_t)(n / 64) * p.head_stride + (size_t)r * p.ldw + n % 64 : 0), in);
    }
  };

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // tile kt visible; every warp is done with tile kt - 1's stage
    if (kt + GSTAGES - 1 < ktiles) load(kt + GSTAGES - 1, (kt + GSTAGES - 1) % GSTAGES);
    cp_async_commit();
    const bf16* as = As + (kt % GSTAGES) * kAStage;
    const bf16* ws = Ws + (kt % GSTAGES) * kWStage;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], as + (wm + 16 * mt + (lane & 15)) * LDA + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (16 * kk + (lane & 15)) * LDW + wn + 16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (n0 + wn >= p.n) return;  // N is a multiple of 64: a warp's columns are all in or all out

  float2 bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bias[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + n0 + wn + 8 * j + 2 * t4));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + 16 * mt + g + 8 * r;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t4;
        float v0 = round_bf(round_bf(acc[mt][j][2 * r]) + bias[j].x);
        float v1 = round_bf(round_bf(acc[mt][j][2 * r + 1]) + bias[j].y);
        if constexpr (kRope) {
          if (p.rope) {
            const float2 cs = *reinterpret_cast<const float2*>(p.rope + (size_t)row * 64 + (col & 63));
            const float r0 = __fadd_rn(__fmul_rn(v0, cs.x), __fmul_rn(-v1, cs.y));
            const float r1 = __fadd_rn(__fmul_rn(v1, cs.x), __fmul_rn(v0, cs.y));
            v0 = r0;
            v1 = r1;
          }
        }
        const size_t at = (size_t)row * p.n + col;
        if (p.res) {
          v0 += to_f(p.res[at]);
          v1 += to_f(p.res[at + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.c + at) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

attn_core::SmemReservation gemm_smem, gemm_rope_smem, attention_smem;

template <bool kRope>
int run_gemms(const GemmBatch& batch, int count, cudaStream_t stream) {
  int n = 0, m = 0;
  for (int i = 0; i < count; ++i) {
    n = batch.g[i].n > n ? batch.g[i].n : n;
    m = batch.g[i].m > m ? batch.g[i].m : m;
  }
  const cudaError_t err = (kRope ? gemm_rope_smem : gemm_smem).allow((const void*)gemm_kernel<kRope>, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, count);
  gemm_kernel<kRope><<<grid, GTHREADS, kGemmSmem, stream>>>(batch);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- attention ---
// grid (ceil(K / 64), heads, N); the shared core on head h of sequence n
__global__ void __launch_bounds__(attn_core::THREADS)
gnn_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const unsigned char* __restrict__ mask, bf16* __restrict__ o, int K, int S, int D,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.z, h = blockIdx.y;
  const size_t qo = (size_t)n * K * D + h * attn_core::DH, kv = (size_t)n * S * D + h * attn_core::DH;
  attn_core::attend(q + qo, k + kv, v + kv, D, D, mask + (size_t)n * S, o + qo, D, K, S, scale,
                    blockIdx.x * attn_core::QT, smem);
}

// ------------------------------------------- LayerNorm + ReLU or GELU ---
// one warp per row of width C; f32 statistics
template <bool kGelu>
__device__ __forceinline__ void layernorm_act(const bf16* __restrict__ y, const float* __restrict__ gamma,
                                              const float* __restrict__ beta, bf16* __restrict__ out, int rows,
                                              int C, float eps) {
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
  const float inv = 1.f / sqrtf(ss / C + eps);
  bf16* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float yn = (to_f(yr[c]) - mu) * inv * gamma[c] + beta[c];
    if constexpr (kGelu) {
      // torch's exact GELU, in its order: x * 0.5 * (1 + erf(x / sqrt 2))
      orow[c] = __float2bfloat16(yn * 0.5f * (1.f + erff(yn * 0.70710678118654752f)));
    } else {
      orow[c] = __float2bfloat16(fmaxf(yn, 0.f));
    }
  }
}

__global__ void layernorm_relu_kernel(const bf16* __restrict__ y, const float* __restrict__ gamma,
                                      const float* __restrict__ beta, bf16* __restrict__ out, int rows, int C,
                                      float eps) {
  layernorm_act<false>(y, gamma, beta, out, rows, C, eps);
}

__global__ void layernorm_gelu_kernel(const bf16* __restrict__ y, const float* __restrict__ gamma,
                                      const float* __restrict__ beta, bf16* __restrict__ out, int rows, int C,
                                      float eps) {
  layernorm_act<true>(y, gamma, beta, out, rows, C, eps);
}

}  // namespace

// x (N, K, D), src (N, S, D) bf16; mask (N, S) bool (one byte each).
// Weights as split_layer_params lays them out: wq/wk/wv (h, D, 64),
// bq/bk/bv (h*64), wm (h*64, D), bm (D), w0a/w0b (D, 2D), b0 (2D),
// ln_scale/ln_bias (2D) f32, w1 (2D, D), b1 (D). Scratch: qs (N*K, D),
// ks/vs (N*S, D), os/ms (N*K, D), ys/yr (N*K, 2D), all bf16. out (N, K, D)
// bf16. Every array contiguous and 16-byte aligned. rope: nullptr, or a
// (N*K, 32, 2) float32 table of (cos, sin) per token that rotates q and k
// (a self layer: src holds x's tokens, S == K); gelu: GELU after the
// LayerNorm in place of ReLU; ln_eps: the LayerNorm's eps.
extern "C" int fs_gnn_layer(const bf16* x, const bf16* src, const unsigned char* mask,
                            const bf16* wq, const bf16* bq, const bf16* wk,
                            const bf16* bk, const bf16* wv, const bf16* bv,
                            const bf16* wm, const bf16* bm, const bf16* w0a,
                            const bf16* w0b, const bf16* b0,
                            const float* ln_scale, const float* ln_bias,
                            const bf16* w1, const bf16* b1, bf16* qs,
                            bf16* ks, bf16* vs, bf16* os, bf16* ms, bf16* ys,
                            bf16* yr, bf16* out, int N, int K, int S, int D,
                            int heads, const float* rope, float ln_eps, int gelu,
                            cudaStream_t stream) {
  if (N == 0 || K == 0) return 0;
  const int dh = D / heads;
  if (S <= 0 || dh != attn_core::DH || dh * heads != D) return (int)cudaErrorInvalidValue;
  if (rope && S != K) return (int)cudaErrorInvalidValue;
  const int MK = N * K, MS = N * S;
  const long long split = (long long)D * dh;  // head stride of wq, wk, wv
  int err;
  GemmBatch qkv{{Gemm{x, nullptr, D, wq, nullptr, split, dh, bq, nullptr, qs, MK, D, D, rope},
                 Gemm{src, nullptr, D, wk, nullptr, split, dh, bk, nullptr, ks, MS, D, D, rope},
                 Gemm{src, nullptr, D, wv, nullptr, split, dh, bv, nullptr, vs, MS, D, D}}};
  if ((err = rope ? run_gemms<true>(qkv, 3, stream) : run_gemms<false>(qkv, 3, stream))) return err;

  const int smem = attn_core::smem_bytes(S);
  if ((err = (int)attention_smem.allow((const void*)gnn_attention_kernel, smem))) return err;
  const dim3 agrid((K + attn_core::QT - 1) / attn_core::QT, heads, N);
  gnn_attention_kernel<<<agrid, attn_core::THREADS, smem, stream>>>(qs, ks, vs, mask, os, K, S, D,
                                                                    1.f / sqrtf((float)dh));
  if ((err = (int)cudaGetLastError())) return err;

  GemmBatch merge{{Gemm{os, nullptr, D, wm, nullptr, 64, D, bm, nullptr, ms, MK, D, D}}};
  if ((err = run_gemms<false>(merge, 1, stream))) return err;
  GemmBatch mlp0{{Gemm{x, ms, D, w0a, w0b, 64, 2 * D, b0, nullptr, ys, MK, 2 * D, 2 * D}}};
  if ((err = run_gemms<false>(mlp0, 1, stream))) return err;
  const int rows_per_block = 8;
  const dim3 ln_grid((MK + rows_per_block - 1) / rows_per_block), ln_block(32 * rows_per_block);
  if (gelu)
    layernorm_gelu_kernel<<<ln_grid, ln_block, 0, stream>>>(ys, ln_scale, ln_bias, yr, MK, 2 * D, ln_eps);
  else
    layernorm_relu_kernel<<<ln_grid, ln_block, 0, stream>>>(ys, ln_scale, ln_bias, yr, MK, 2 * D, ln_eps);
  if ((err = (int)cudaGetLastError())) return err;
  GemmBatch mlp1{{Gemm{yr, nullptr, 2 * D, w1, nullptr, 64, D, b1, x, out, MK, D, 2 * D}}};
  return run_gemms<false>(mlp1, 1, stream);
}
