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
// with binc_i = v0_i exp(alpha - r_i), starting from A = V = Vbin = 1. The
// decode takes best1_i = first argmax_j khat_ij V_j, sc0_i = A_i * max,
// best0_j = first argmax_i khat_ij A_i, sc1_j = V_j * max, from the A of
// the last row half-step (A = 1 when iters = 0).
//
// What bounds it on the H100: operations. Per table entry the function
// needs a compare for the row max, a subtract and an exp for khat, two
// multiply-adds an iteration (the row and the column sums) and a multiply
// and a compare for each of the two decodes: 4 * iters + 7 float32
// operations, a multiply-add as 2. At (8, 1024, 1024) and 20 iterations
// that is 0.73 G operations, 0.0109 ms at 67 TFLOP/s, against 32 MB of
// scores read once (0.0100 ms at 3.35 TB/s). The kernel sweeps the table
// 23 times: the khat phase, one sweep an iteration, and one each for the
// row and the column decode.
//
// Design. One launch per call; one thread-block cluster per pair, whose C
// CTAs (up to 16, non-portable above 8) each own R = ceil(K0 / C)
// consecutive rows. Clusters never wait on each other: those that do not
// fit on the card at once run later. No grid-wide barrier, no float
// atomics: results are deterministic.
//
// 1. A first phase reads the pair's scores once (16-byte loads where
//    K1 % 4 == 0, a warp per row, two rows at a time, the next two rows'
//    loads issued before this pair's work) and builds r, binc and khat with
//    the accurate expf. After it no sweep calls expf, tests a mask
//    or reads the scores. A CTA keeps its first Rs khat rows in shared memory
//    (row stride K1 rounded up to 4, zero-padded) and the other R - Rs in an
//    L2-resident float32 scratch the wrapper allocates.
// 2. One sweep per iteration (rows of K1 <= 1024): a warp reads a row once
//    (16-byte reads, V in registers), forms A_i from the row's dot with V,
//    and folds the row times A_i into its column partials in registers. The
//    warps' partials are summed in order; wider rows take a row sweep, then
//    a column sweep. Every CTA holds its own copy of V and forms Abin from
//    it in the same order, so the copies agree bit for bit.
// 3. Exchange through distributed shared memory: a CTA pushes its column
//    partials for slice o into CTA o's stage (at its own rank) and its
//    dustbin partial into every CTA; cluster barrier; CTA o sums its slice
//    over the ranks in order, forms V_j and writes it into every peer's
//    copy, and every CTA sums the dustbin partials in rank order to Vbin;
//    cluster barrier.
// 4. The decode in the same launch: the row argmax is local; the column
//    argmax merges the CTAs' (max, first index) in rank order.
//
// Against the four-kernel design this replaces (one launch per half-step):
// 1 launch instead of 3 + 2 * iters; 1 expf per table entry instead of one
// per entry and sweep; 1 sweep of a shared-memory (or L2) table per
// iteration instead of 2 of the scores, the column half of it in registers
// instead of 128 dependent strided global loads per thread; and 16-byte
// loads instead of 4-byte ones.
//
// The launcher takes the largest cluster size in 1..16 whose B clusters
// run in the fewest waves that cudaOccupancyMaxActiveClusters allows (one
// wave where any size gives one), or the size asked for; see
// fs_sinkhorn_plan. On the H100 at most 7 clusters of 10-16 CTAs are active
// at once (one per GPC), 9 of 9 and 15 of 8.
//
// -Xptxas -v (sm_90a, CUDA 12.8): 219 registers, no spills (0-byte stack
// frame), no static shared memory; 256 threads and one CTA an SM. Dynamic
// shared memory per CTA, from the plan: 232,248 bytes at (8, 1024, 1024)
// (9-CTA clusters, 46 of 114 rows in shared memory), 231,904 at the lowres
// gate's (23, 512, 512) (4-CTA clusters, 102 of 128 rows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_setup.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kVRegQuads = 8;  // V quads a lane keeps in registers (K1 <= 1024)
constexpr int kRows = 2;       // rows a warp takes at a time, so their latencies overlap
constexpr int kScalars = 56;   // Vbin, dustbin partials, warp partials, counts
constexpr float kNeg = -1e9f;
constexpr float kTiny = 1e-30f;
constexpr float kFloatMax = 3.402823466e38f;

struct Layout {
  int C;     // CTAs per pair (cluster size)
  int R;     // rows per CTA
  int Rs;    // of them in shared memory
  int Rg;    // of them in the L2 scratch
  int K1p;   // row stride: K1 rounded up to 4
  int Q;     // quads (float4) per row
  int G;     // row groups of the column decode (and of the column sweep of wide rows)
  int Qc;    // quads of V each CTA forms
  int red;   // floats of the partials buffer
  int smem;  // dynamic shared memory, bytes
};

// Rows of up to kVRegQuads quads a lane take the one-sweep iteration.
__host__ __device__ inline bool one_sweep(int Q) { return Q <= 32 * kVRegQuads; }

// Shared memory, in this order: khat[Rs][K1p], V[K1p], red (the warps'
// column partials [kWarps][K1p] of a one-sweep iteration, or [G][K1p]
// column partials of wide rows, then the decode's [G][K1p] argmax values
// and [G][K1p] indices), stage[(Q + kMaxCluster) * 4] (the peers' partials
// of this CTA's columns), A[R], binc[R], v0[R], scalars[kScalars], v1
// bytes[K1p]. False if all but the khat rows do not fit in `cap` bytes.
bool make_layout(int K0, int K1, int C, int cap, Layout* L) {
  L->C = C;
  L->R = (K0 + C - 1) / C;
  L->K1p = (K1 + 3) & ~3;
  L->Q = L->K1p / 4;
  L->G = L->Q >= kThreads ? 1 : kThreads / L->Q;
  L->Qc = (L->Q + C - 1) / C;
  L->red = (one_sweep(L->Q) && kWarps > 2 * L->G ? kWarps : 2 * L->G) * L->K1p;
  const long fixed =
      4L * ((long)L->K1p + L->red + 4L * (L->Q + kMaxCluster) + 3L * L->R + kScalars) + L->K1p;
  if (fixed > cap) return false;
  const long row = 4L * L->K1p;
  L->Rs = (int)(((long)cap - fixed) / row < L->R ? ((long)cap - fixed) / row : L->R);
  L->Rg = L->R - L->Rs;
  L->smem = (int)(fixed + row * L->Rs);
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// first-index argmax combine: larger value wins, ties go to the lower index
__device__ __forceinline__ void argmax_combine(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void argmax_combine4(float4& v, int4& i, const float4 v2, const int4 i2) {
  argmax_combine(v.x, i.x, v2.x, i2.x);
  argmax_combine(v.y, i.y, v2.y, i2.y);
  argmax_combine(v.z, i.z, v2.z, i2.z);
  argmax_combine(v.w, i.w, v2.w, i2.w);
}

__device__ __forceinline__ void fma4(float4& acc, const float4 x, const float a) {
  acc.x = fmaf(x.x, a, acc.x);
  acc.y = fmaf(x.y, a, acc.y);
  acc.z = fmaf(x.z, a, acc.z);
  acc.w = fmaf(x.w, a, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

__device__ __forceinline__ float dot4(const float4 x, const float4 v, float acc) {
  return fmaf(x.w, v.w, fmaf(x.z, v.z, fmaf(x.y, v.y, fmaf(x.x, v.x, acc))));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Quad q of a score row read a float at a time (rows not 16-byte aligned);
// kNeg past K1.
__device__ __forceinline__ float4 scalar_quad(const float* srow, int q, int K1) {
  float e[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) e[c] = 4 * q + c < K1 ? srow[4 * q + c] : kNeg;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// kNeg where bit c of `valid` is clear (a masked pair, or a column past K1).
__device__ __forceinline__ float4 mask_quad(const float4 s, uint32_t valid) {
  return make_float4(valid & 1u ? s.x : kNeg, valid & 2u ? s.y : kNeg, valid & 4u ? s.z : kNeg,
                     valid & 8u ? s.w : kNeg);
}

__device__ __forceinline__ float max4(const float4 x) { return fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)); }

__device__ __forceinline__ float4 exp_shifted(const float4 s, float r) {
  return make_float4(expf(s.x - r), expf(s.y - r), expf(s.z - r), expf(s.w - r));
}

// This lane's share of sum_j row_j V_j: quads lane + 32 k, the first
// kVRegQuads of them against V in registers.
__device__ __forceinline__ float row_dot(const float4* row, const float4 (&vr)[kVRegQuads], const float4* V4,
                                         int Q, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kVRegQuads; ++k)
    if (lane + 32 * k < Q) acc = dot4(row[lane + 32 * k], vr[k], acc);
  for (int q = lane + 32 * kVRegQuads; q < Q; q += 32) acc = dot4(row[q], V4[q], acc);
  return acc;
}

__device__ __forceinline__ void quad_argmax(const float4 x, const float4 v, int q, int K1, float& best, int& bi) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = comp(x, c) * comp(v, c);
    if (4 * q + c < K1 && m > best) {
      best = m;
      bi = 4 * q + c;
    }
  }
}

// This lane's first argmax_j of row_j V_j over j < K1, folded into (best,
// bi); the quads in registers each on their own, then merged, so the
// compare chains are short.
__device__ __forceinline__ void row_argmax(const float4* row, const float4 (&vr)[kVRegQuads], const float4* V4,
                                           int Q, int K1, int lane, float& best, int& bi) {
  float bk[kVRegQuads];
  int ik[kVRegQuads];
#pragma unroll
  for (int k = 0; k < kVRegQuads; ++k) {
    bk[k] = -1.f;
    ik[k] = K1;
    if (lane + 32 * k < Q) quad_argmax(row[lane + 32 * k], vr[k], lane + 32 * k, K1, bk[k], ik[k]);
  }
  for (int q = lane + 32 * kVRegQuads; q < Q; q += 32) quad_argmax(row[q], V4[q], q, K1, best, bi);
#pragma unroll
  for (int k = 0; k < kVRegQuads; ++k) argmax_combine(best, bi, bk[k], ik[k]);
}

// Folds row i's entries x * a of four columns into their (max, first index).
__device__ __forceinline__ void col_argmax(const float4 x, float a, int i, float4& bv, int4& bx) {
  argmax_combine4(bv, bx, make_float4(x.x * a, x.y * a, x.z * a, x.w * a), make_int4(i, i, i, i));
}

// One cluster of L.C CTAs per pair; grid B * L.C. spill holds the rows past
// L.Rs of every CTA: (B * L.C, L.Rg, L.K1p) float32.
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_cluster_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ valid0,
                        const uint8_t* __restrict__ valid1, const float* __restrict__ alpha_p,
                        float* __restrict__ spill, int* __restrict__ best1, float* __restrict__ sc0,
                        int* __restrict__ best0, float* __restrict__ sc1, int K0, int K1, int iters,
                        const Layout L) {
  extern __shared__ float4 sk_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = L.C, Q = L.Q, G = L.G, K1p = L.K1p, Rs = L.Rs, Qc = L.Qc;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rank * L.R;
  const int n = K0 - r0 < L.R ? (K0 - r0 > 0 ? K0 - r0 : 0) : L.R;  // rows of this CTA
  const int ns = n < Rs ? n : Rs;                                      // of them in shared memory
  const bool fused = one_sweep(Q);

  float* sm = reinterpret_cast<float*>(sk_smem);
  float4* ks4 = sk_smem;  // khat rows 0..Rs-1
  float* V = sm + (size_t)Rs * K1p;
  float4* V4 = reinterpret_cast<float4*>(V);
  float* red = V + K1p;
  float4* red4 = reinterpret_cast<float4*>(red);                     // column partials; decode values
  int4* redi4 = reinterpret_cast<int4*>(red + (size_t)G * K1p);      // decode indices
  float4* stage4 = reinterpret_cast<float4*>(red + L.red);           // [C][Qc] peers' partials
  float* A = red + L.red + 4 * (Q + kMaxCluster);
  float* binc = A + L.R;
  float* v0f = binc + L.R;
  // [0] Vbin, [8..16) Abin warp partials, [16..32) valid counts, [32..40)
  // dustbin warp partials, [40..56) the peers' dustbin partials by rank
  float* scal = v0f + L.R;
  int* icnt = reinterpret_cast<int*>(scal + 16);
  uint8_t* v1b = reinterpret_cast<uint8_t*>(scal + kScalars);
  float4* kg4 = reinterpret_cast<float4*>(spill + (size_t)blockIdx.x * L.Rg * K1p);  // rows Rs..R-1
  auto row4 = [&](int i) -> float4* { return i < Rs ? ks4 + (size_t)i * Q : kg4 + (size_t)(i - Rs) * Q; };
  const float alpha = alpha_p[0];

  // set-up: v1, V = 1, A = 1, v0, the valid counts
  int c0 = 0, c1 = 0;
  for (int j = tid; j < K1p; j += kThreads) {
    const int v = j < K1 ? (valid1[(size_t)b * K1 + j] != 0) : 0;
    v1b[j] = (uint8_t)v;
    V[j] = j < K1 ? 1.f : 0.f;
    c1 += v;
  }
  for (int i = tid; i < K0; i += kThreads) c0 += valid0[(size_t)b * K0 + i] != 0;
  for (int i = tid; i < n; i += kThreads) {
    v0f[i] = valid0[(size_t)b * K0 + r0 + i] != 0 ? 1.f : 0.f;
    A[i] = 1.f;
  }
  c0 = warp_sum_int(c0);
  c1 = warp_sum_int(c1);
  if (lane == 0) {
    icnt[warp] = c0;
    icnt[kWarps + warp] = c1;
  }
  if (tid == 0) scal[0] = 1.f;
  __syncthreads();
  int n0i = 0, n1i = 0;
  for (int w = 0; w < kWarps; ++w) {
    n0i += icnt[w];
    n1i += icnt[kWarps + w];
  }
  const float n0 = (float)n0i, n1 = (float)n1i;

  // khat: one warp per row, kRows rows at a time so their loads overlap
  const bool vec = (K1 & 3) == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  if (fused) {
    uint32_t vm = 0;  // this lane's valid columns: bit 4 k + c for column 4 (lane + 32 k) + c
#pragma unroll
    for (int k = 0; k < kVRegQuads; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * (lane + 32 * k) + c;
        if (j < K1 && v1b[j]) vm |= 1u << (4 * k + c);
      }
    // the rows of batch i0 (past n: row i0 again), all loads issued at once
    auto load_scores = [&](int i0, float4 (&x)[kRows][kVRegQuads]) {
      const float* srow[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        srow[u] = scores + ((size_t)b * K0 + r0 + (i0 + u * kWarps < n ? i0 + u * kWarps : i0)) * K1;
      if (vec) {
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int k = 0; k < kVRegQuads; ++k)
            if (lane + 32 * k < Q) x[u][k] = reinterpret_cast<const float4*>(srow[u])[lane + 32 * k];
      } else {
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int k = 0; k < kVRegQuads; ++k)
            if (lane + 32 * k < Q) x[u][k] = scalar_quad(srow[u], lane + 32 * k, K1);
      }
    };
    float4 xn[kRows][kVRegQuads];
    if (warp < n) load_scores(warp, xn);
    for (int i0 = warp; i0 < n; i0 += kRows * kWarps) {
      float4 x[kRows][kVRegQuads];
      float m[kRows];
      int iu[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int k = 0; k < kVRegQuads; ++k) x[u][k] = xn[u][k];
      if (i0 + kRows * kWarps < n) load_scores(i0 + kRows * kWarps, xn);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        iu[u] = i0 + u * kWarps < n ? i0 + u * kWarps : i0;
        const uint32_t rm = v0f[iu[u]] > 0.f ? vm : 0u;
        m[u] = -kFloatMax;
#pragma unroll
        for (int k = 0; k < kVRegQuads; ++k)
          if (lane + 32 * k < Q) {
            x[u][k] = mask_quad(x[u][k], rm >> (4 * k));
            m[u] = fmaxf(m[u], max4(x[u][k]));
          }
      }
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u) m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float ri = fmaxf(m[u], alpha);
        float4* d = row4(iu[u]);
#pragma unroll
        for (int k = 0; k < kVRegQuads; ++k)
          if (lane + 32 * k < Q) d[lane + 32 * k] = exp_shifted(x[u][k], ri);
        if (lane == 0) binc[iu[u]] = v0f[iu[u]] * expf(alpha - ri);
      }
    }
  } else {
    for (int i = warp; i < n; i += kWarps) {
      const float* srow = scores + ((size_t)b * K0 + r0 + i) * K1;
      float4* d = row4(i);
      float m = -kFloatMax;
      for (int q = lane; q < Q; q += 32) {
        uint32_t valid = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (v0f[i] > 0.f && 4 * q + c < K1 && v1b[4 * q + c]) valid |= 1u << c;
        const float4 x = mask_quad(vec ? reinterpret_cast<const float4*>(srow)[q] : scalar_quad(srow, q, K1), valid);
        m = fmaxf(m, max4(x));
        d[q] = x;
      }
      const float ri = fmaxf(warp_max(m), alpha);
      for (int q = lane; q < Q; q += 32) d[q] = exp_shifted(d[q], ri);
      if (lane == 0) binc[i] = v0f[i] * expf(alpha - ri);
    }
  }
  // every CTA of the cluster runs before any reaches into a peer's shared memory
  cluster.sync();

  const int qa = rank * Qc;
  const int qb = qa + Qc < Q ? qa + Qc : Q;
  float4 vr[kVRegQuads];
  for (int it = 0; it < iters; ++it) {
    const float Vbin = scal[0];
    // Abin's sum over this CTA's copy of V: warp partials, summed in order below
    float acc = 0.f;
    for (int j = tid; j < K1p; j += kThreads) acc += (float)v1b[j] * V[j];
    acc = warp_sum(acc);
    if (lane == 0) scal[8 + warp] = acc;
#pragma unroll
    for (int k = 0; k < kVRegQuads; ++k) {
      const int q = lane + 32 * k;
      vr[k] = q < Q ? V4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    if (fused) {
      // one sweep: each row's A_i from its dot with V, then the row folded
      // into this warp's column partials with that A_i; kRows rows at a time
      float4 cp[kVRegQuads];
#pragma unroll
      for (int k = 0; k < kVRegQuads; ++k) cp[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      float pb = 0.f;
      for (int i0 = warp; i0 < n; i0 += kRows * kWarps) {
        float4 x[kRows][kVRegQuads];
        float d[kRows];
        int iu[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          iu[u] = i0 + u * kWarps < n ? i0 + u * kWarps : -1;
          const float4* p = row4(iu[u] < 0 ? i0 : iu[u]);
#pragma unroll
          for (int k = 0; k < kVRegQuads; ++k)
            x[u][k] = lane + 32 * k < Q ? p[lane + 32 * k] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          d[u] = 0.f;
#pragma unroll
          for (int k = 0; k < kVRegQuads; ++k) d[u] = dot4(x[u][k], vr[k], d[u]);
        }
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < kRows; ++u) d[u] += __shfl_xor_sync(0xffffffffu, d[u], o);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          float a = 0.f;  // rows past n add nothing
          if (iu[u] >= 0) {
            a = v0f[iu[u]] / fmaxf(d[u] + binc[iu[u]] * Vbin, kTiny);
            pb = fmaf(binc[iu[u]], a, pb);
            if (lane == 0) A[iu[u]] = a;
          }
#pragma unroll
          for (int k = 0; k < kVRegQuads; ++k) fma4(cp[k], x[u][k], a);
        }
      }
#pragma unroll
      for (int k = 0; k < kVRegQuads; ++k)
        if (lane + 32 * k < Q) red4[warp * Q + lane + 32 * k] = cp[k];
      if (lane == 0) scal[32 + warp] = pb;
    } else {
      // wide rows: a row sweep, then a column sweep (rows i = g, g + G, ...)
      for (int i = warp; i < n; i += kWarps) {
        const float d = warp_sum(row_dot(row4(i), vr, V4, Q, lane));
        if (lane == 0) A[i] = v0f[i] / fmaxf(d + binc[i] * Vbin, kTiny);
      }
      __syncthreads();
      for (int e = tid; e < G * Q; e += kThreads) {
        const int g = e / Q, q = e - g * Q;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        int i = g;
#pragma unroll 8
        for (; i < ns; i += G) fma4(s, ks4[(size_t)i * Q + q], A[i]);
#pragma unroll 8
        for (; i < n; i += G) fma4(s, kg4[(size_t)(i - Rs) * Q + q], A[i]);
        red4[e] = s;
      }
      if (warp == 0) {
        float pb = 0.f;
        for (int i = lane; i < n; i += 32) pb += binc[i] * A[i];
        pb = warp_sum(pb);
        if (lane == 0) scal[32] = pb;
      }
    }
    // this CTA's column partials (the warps' summed in order) and dustbin
    // partial, pushed into the owners' stage: slice o of the columns to CTA
    // o, at this CTA's rank; the dustbin partial to every CTA
    const int parts = fused ? kWarps : 1;
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads) {
      float4 s = red4[q];
      for (int w = 1; w < parts; ++w) add4(s, red4[w * Q + q]);
      const int o = q / Qc;
      cluster.map_shared_rank(stage4, o)[rank * Qc + q - o * Qc] = s;
    }
    if (tid < C) {
      float s = scal[32];
      for (int w = 1; w < parts; ++w) s += scal[32 + w];
      *cluster.map_shared_rank(scal + 40 + rank, tid) = s;
    }
    cluster.sync();

    float rsbin = 0.f;
    for (int w = 0; w < kWarps; ++w) rsbin += scal[8 + w];
    const float Abin = n1 / fmaxf(rsbin + Vbin, kTiny);
    // V over this CTA's slice, the peers' partials summed in rank order,
    // written into every peer's copy
    for (int qq = tid; qq < qb - qa; qq += kThreads) {
      float4 s = stage4[qq];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < C) add4(s, stage4[r * Qc + qq]);
      const int q = qa + qq;
      float vv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v1 = (float)v1b[4 * q + c];
        vv[c] = v1 / fmaxf(comp(s, c) + v1 * Abin, kTiny);
      }
      const float4 v = make_float4(vv[0], vv[1], vv[2], vv[3]);
      for (int p = 0; p < C; ++p) cluster.map_shared_rank(V4, p)[q] = v;
    }
    if (tid == 0) {
      float cs = scal[40];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < C) cs += scal[40 + r];
      scal[0] = n0 / fmaxf(cs + Abin, kTiny);
    }
    cluster.sync();
  }

  // row decode: first argmax_j of khat_ij V_j, local
#pragma unroll
  for (int k = 0; k < kVRegQuads; ++k) {
    const int q = lane + 32 * k;
    vr[k] = q < Q ? V4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i0 = warp; i0 < n; i0 += kRows * kWarps) {
    float best[kRows];
    int bi[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      best[u] = -1.f;
      bi[u] = K1;
      if (i0 + u * kWarps < n) row_argmax(row4(i0 + u * kWarps), vr, V4, Q, K1, lane, best[u], bi[u]);
    }
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float v2 = __shfl_xor_sync(0xffffffffu, best[u], o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi[u], o);
        argmax_combine(best[u], bi[u], v2, i2);
      }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = i0 + u * kWarps;
      if (lane == 0 && i < n) {
        best1[(size_t)b * K0 + r0 + i] = bi[u];
        sc0[(size_t)b * K0 + r0 + i] = A[i] * best[u];
      }
    }
  }

  // column decode: this CTA's (max, first index) of khat_ij A_i per column
  for (int e = tid; e < G * Q; e += kThreads) {
    const int g = e / Q, q = e - g * Q;
    float4 bv = make_float4(-1.f, -1.f, -1.f, -1.f);
    int4 bx = make_int4(K0, K0, K0, K0);
    int i = g;
#pragma unroll 16
    for (; i < ns; i += G) col_argmax(ks4[(size_t)i * Q + q], A[i], r0 + i, bv, bx);
#pragma unroll 16
    for (; i < n; i += G) col_argmax(kg4[(size_t)(i - Rs) * Q + q], A[i], r0 + i, bv, bx);
    red4[e] = bv;
    redi4[e] = bx;
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads) {
    float4 v = red4[q];
    int4 x = redi4[q];
    for (int g = 1; g < G; ++g) argmax_combine4(v, x, red4[g * Q + q], redi4[g * Q + q]);
    red4[q] = v;
    redi4[q] = x;
  }
  cluster.sync();
  for (int q = qa + tid; q < qb; q += kThreads) {
    float4 v = make_float4(-1.f, -1.f, -1.f, -1.f);
    int4 x = make_int4(K0, K0, K0, K0);
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      if (p < C) argmax_combine4(v, x, cluster.map_shared_rank(red4, p)[q], cluster.map_shared_rank(redi4, p)[q]);
    const int xi[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * q + c;
      if (j < K1) {
        best0[(size_t)b * K1 + j] = xi[c];
        sc1[(size_t)b * K1 + j] = V[j] * comp(v, c);
      }
    }
  }
  // the peers read this CTA's shared memory until here
  cluster.sync();
}

DeviceSetup device_setup;

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, const Layout& L,
                    cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = L.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(B * L.C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = L.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// The launch plan for (B, K0, K1): the cluster size `cluster` if it is > 0,
// else the largest size in 1..16 (at most K0) of those whose B clusters run
// in the fewest waves: more CTAs a pair hold more of its table in shared
// memory, and a second wave doubles the time. out[8]:
// cluster size (CTAs per pair), rows per CTA, rows in shared memory, rows in
// the L2 scratch, shared memory bytes per CTA, clusters that can be active
// at once, waves, threads per CTA. Returns 0, -1 if K1 is too wide for V and
// the partials to fit in shared memory, -2 if no cluster size can run, or a
// CUDA error.
extern "C" int fs_sinkhorn_plan(int B, int K0, int K1, int cluster, int* out) {
  if (B < 1 || K0 < 1 || K1 < 1 || cluster < 0 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = device_setup.get((const void*)sinkhorn_cluster_kernel, true, &cap);
  if (err != cudaSuccess) return (int)err;
  bool any_layout = false, found = false;
  int best_waves = 0;
  const int lo = cluster > 0 ? cluster : 1;
  const int hi = cluster > 0 ? cluster : (K0 < kMaxCluster ? K0 : kMaxCluster);
  for (int C = lo; C <= hi; ++C) {
    Layout L;
    if (!make_layout(K0, K1, C, cap, &L)) continue;
    any_layout = true;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, B, L, 0);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, (const void*)sinkhorn_cluster_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size this device cannot run: clear it, try the next
      continue;
    }
    if (active < 1) continue;
    const int waves = (B + active - 1) / active;
    if (!found || waves <= best_waves) {  // C rises: a tie takes the larger size
      found = true;
      best_waves = waves;
      out[0] = C;
      out[1] = L.R;
      out[2] = L.Rs;
      out[3] = L.Rg;
      out[4] = L.smem;
      out[5] = active;
      out[6] = waves;
      out[7] = kThreads;
    }
  }
  if (!any_layout) return -1;
  return found ? 0 : -2;
}

// scores (B, K0, K1) float32; valid0 (B, K0), valid1 (B, K1) bytes (0 or
// not); alpha (1,) float32; spill (B * cluster, rows in L2, round_up(K1, 4))
// float32 scratch, unused when no row lies in L2. Outputs best1, sc0 (B, K0)
// and best0, sc1 (B, K1). `cluster` from fs_sinkhorn_plan.
extern "C" int fs_sinkhorn_decode(const float* scores, const uint8_t* valid0, const uint8_t* valid1,
                                  const float* alpha, float* spill, int* best1, float* sc0, int* best0,
                                  float* sc1, int B, int K0, int K1, int iters, int cluster,
                                  cudaStream_t stream) {
  if (B < 1 || K0 < 1 || K1 < 1 || iters < 0 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = device_setup.get((const void*)sinkhorn_cluster_kernel, true, &cap);
  if (err != cudaSuccess) return (int)err;
  Layout L;
  if (!make_layout(K0, K1, cluster, cap, &L) || (L.Rg > 0 && spill == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, B, L, stream);
  err = cudaLaunchKernelEx(&cfg, sinkhorn_cluster_kernel, scores, valid0, valid1, alpha, spill, best1, sc0,
                           best0, sc1, K0, K1, iters, L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
