// One masked attention for 64-wide heads, on Hopper's tensor cores, shared
// by csrc/attention.cu (q, k, v as (B, h, tokens, 64)) and csrc/gnn_layer.cu
// (projections as (N * tokens, h * 64)). Each layout hands the core one
// base pointer per (sequence, head) and a token stride: 64 for the first,
// h * 64 for the second. Per query row:
//
//   logit_s = (q . k_s) * scale                      float32
//   logit_s = NEG (-1e9) where source s is masked
//   p_s     = bf16(exp(logit_s - max) / max(sum, 1e-30))
//   out     = bf16(sum_s p_s v_s)                     float32 sums
//
// the numerics of frontend/pallas_attention.py:51-65 and of the head loop of
// frontend/pallas_gnn.py:114-125. A row whose sources are all masked
// averages v over S (the NEG is finite).
//
// Design. A block of four warps takes 64 queries of one (sequence, head);
// each warp owns 16 of them and keeps their q fragments in registers. Every
// product is mma.sync.m16n8k16 (bf16 operands, float32 accumulators) fed by
// ldmatrix: q and k without transposition, v with .trans. The logits of a
// 16 x 64 tile stay in the accumulator registers: each thread holds two rows
// and sixteen columns of them, and the row statistics are merged across the
// four threads of a quad by shuffles. The accumulator layout of two n8 tiles
// is the A-fragment layout of one k16 slice, so the bf16 probabilities go
// from the logits' registers straight into the P.V product, never through
// shared memory.
//
// The reference divides by the row sum before the bf16 cast, and a softmax
// that divides at the end rounds otherwise, so the sources are swept twice:
// the first sweep computes Q.K^T and each row's running maximum and sum,
// the second recomputes Q.K^T, forms bf16(expf(l - M) / L) and accumulates
// P.V. That is three products where two would do. expf is the accurate one
// (no --use_fast_math), and the quotient is correctly rounded (see prob).
//
// Sources move in tiles of 64 through a two-stage ring in shared memory with
// cp.async.cg 16-byte copies: the tile of step t + 1 (k alone in the first
// sweep, k and v in the second) is in flight while the block computes step
// t, one __syncthreads per step. Rows are padded to 144 bytes, so the eight
// rows an ldmatrix reads fall on distinct banks. Rows past K or S are
// zero-filled by the copy (no NaN can enter a product), and the ragged
// tile's columns past S are left out of the statistics and get p = 0. The
// source mask is packed once per block into one bit per source
// (__ballot_sync), so a tile's mask is two words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace attn_core {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e9f;
constexpr int DH = 64;       // head width
constexpr int WARPS = 4;     // 16 query rows each
constexpr int QT = 16 * WARPS;  // queries per block
constexpr int ST = 64;       // sources per tile
constexpr int THREADS = WARPS * 32;
constexpr int LDS = DH + 8;  // row stride in shared memory (elements): 144 bytes
constexpr int kTileElems = ST * LDS;
constexpr int kStages = 2;

// shared memory: q tile, then the ring of (k, v) tiles, then the mask bits
constexpr int kMaskOffset = 2 * (QT * LDS + kStages * 2 * kTileElems);  // 46,080 bytes

__host__ __device__ inline int smem_bytes(int S) {
  return kMaskOffset + 4 * ((S + 127) / 128) * 4;  // whole 16-byte groups of mask words
}

// Allows a kernel more than the default 48 KB of dynamic shared memory on
// the current device, with one cudaFuncSetAttribute per kernel and device
// rather than one per launch (a runtime call on the launch path, which the
// host-bound paths feel). One instance per kernel.
struct SmemReservation {
  static constexpr int kDevices = 64;
  int bytes[kDevices] = {};

  cudaError_t allow(const void* kernel, int need) {
    if (need <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && bytes[dev] >= need) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err == cudaSuccess && dev < kDevices) bytes[dev] = need;
    return err;
  }
};

// ---------------------------------------------------------------- PTX ---
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a normalised probability: exp(l - M) / L, rounded as the reference's
// division rounds. r = RN(1 / L) and q = RN(e r) are within half an ulp and
// one ulp; one correction q + RN(e - q L) r (the residual exact through the
// FMA) is then the correctly rounded quotient (Markstein's theorem) for any
// quotient that does not underflow, as the card's div.rn.f32 is. The
// compiler's div.rn.f32 call with its slow-path check took half the kernel's
// time; 1 / L is computed once per row and hoisted out of the loops.
__device__ __forceinline__ float prob(float l, float M, float L) {
  const float e = expf(l - M), r = __frcp_rn(L), q = e * r;
  return fmaf(fmaf(-q, L, e), r, q);
}

// rows row0 .. row0 + ROWS - 1 of a (rows, 64) bf16 matrix with row stride
// ld (elements) into a padded shared tile; rows at or past nrows read zeros
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld, int row0, int nrows) {
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i >> 3, c = (i & 7) * 8;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LDS + c, src + (size_t)(in ? row0 + r : 0) * ld + c, in);
  }
}

// ------------------------------------------------------------- the core ---
// One block: queries q0 .. q0 + 63 of one (sequence, head). q, k, v and o
// point at token 0, column 0 of the head; ldq, ldkv and ldo are token
// strides in elements; mask holds one byte per source (nonzero = valid).
// Needs smem_bytes(S) of dynamic shared memory, THREADS threads, K, S >= 1,
// 16-byte aligned rows.
__device__ __forceinline__ void attend(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v, int ldq, int ldkv,
                                       const unsigned char* __restrict__ mask, bf16* __restrict__ o,
                                       int ldo, int K, int S, float scale, int q0,
                                       unsigned char* smem) {
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + QT * LDS;  // stage st: k at ring + 2 st tile, v after it
  uint32_t* Mbits = reinterpret_cast<uint32_t*>(smem + kMaskOffset);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row (and row + 8), column pair
  const int ntiles = (S + ST - 1) / ST, nsteps = 2 * ntiles;

  // the mask, one bit per source
  for (int w = warp; w < (S + 31) / 32; w += WARPS) {
    const int s = 32 * w + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, s < S && mask[s] != 0);
    if (lane == 0) Mbits[w] = bits;
  }

  // q and the first step's k tile in flight together
  load_tile<QT>(Qs, q, ldq, q0, K);
  load_tile<ST>(ring, k, ldkv, 0, S);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float acc_o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc_o[j][0] = acc_o[j][1] = acc_o[j][2] = acc_o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // this thread's columns of rows g, g + 8
  float M[2] = {0.f, 0.f}, denom[2] = {1.f, 1.f};  // set when the first sweep ends

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();  // with two stages, the one group in flight is this step's
    __syncthreads();  // step's tiles visible; every warp is done with the other stage
    if (step + 1 < nsteps) {
      const int nxt = step + 1, t = nxt < ntiles ? nxt : nxt - ntiles;
      bf16* Kn = ring + (nxt % kStages) * 2 * kTileElems;
      load_tile<ST>(Kn, k, ldkv, t * ST, S);
      if (nxt >= ntiles) load_tile<ST>(Kn + kTileElems, v, ldkv, t * ST, S);
    }
    cp_async_commit();

    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (16 * warp + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
    }
    const bool second = step >= ntiles;
    const int s0 = (second ? step - ntiles : step) * ST;
    const bf16* Ks = ring + (step % kStages) * 2 * kTileElems;
    const bf16* Vs = Ks + kTileElems;

    if (step == ntiles) {  // end of the first sweep: merge the quad's statistics
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = m[r] > -INFINITY ? l[r] * expf(m[r] - mx) : 0.f;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        M[r] = mx;
        denom[r] = fmaxf(sum, 1e-30f);
      }
    }

    // logits of this warp's 16 queries against the tile's 64 sources
    float sc[ST / 8][4];
#pragma unroll
    for (int j = 0; j < ST / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < DH / 32; ++kk2) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (8 * j + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8);
        mma_bf16(sc[j], qf[2 * kk2], b[0], b[1]);
        mma_bf16(sc[j], qf[2 * kk2 + 1], b[2], b[3]);
      }
    }
    // scale and mask in place: bit 8 j + e of `mine` is the mask bit of this
    // thread's column 8 j + 2 t4 + e; a masked source gets NEG, and a column
    // past S (in the ragged last tile only) -inf
    const uint64_t mine =
        ((uint64_t)Mbits[s0 / 32] | (s0 + 32 < S ? (uint64_t)Mbits[s0 / 32 + 1] << 32 : 0ull)) >> (2 * t4);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = (mine >> (8 * j + (e & 1))) & 1ull ? sc[j][e] * scale : kNeg;
    if (s0 + ST > S) {
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) >= S - s0) sc[j][e] = -INFINITY;
    }

    if (!second) {  // sweep 1: running maximum and sum of this thread's columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < ST / 8; ++j) mt = fmaxf(mt, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        if (mt > -INFINITY) {
          const float mn = fmaxf(m[r], mt);
          float add = 0.f;
#pragma unroll
          for (int j = 0; j < ST / 8; ++j) add += expf(sc[j][2 * r] - mn) + expf(sc[j][2 * r + 1] - mn);
          l[r] = l[r] * expf(m[r] - mn) + add;
          m[r] = mn;
        }
      }
    } else {  // sweep 2: p = bf16(exp(l - M) / L) in registers, o += p . v
#pragma unroll
      for (int t16 = 0; t16 < ST / 16; ++t16) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* c = sc[2 * t16 + h];
          a[2 * h] = pack_bf16(prob(c[0], M[0], denom[0]), prob(c[1], M[0], denom[0]));
          a[2 * h + 1] = pack_bf16(prob(c[2], M[1], denom[1]), prob(c[3], M[1], denom[1]));
        }
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + (16 * t16 + (lane & 15)) * LDS + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc_o[2 * np], a, b[0], b[1]);
          mma_bf16(acc_o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    if (qi >= K) continue;
    bf16* orow = o + (size_t)qi * ldo;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc_o[j][2 * r], acc_o[j][2 * r + 1]);
  }
}

}  // namespace attn_core
