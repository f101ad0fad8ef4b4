// PnP-RANSAC's refine-and-select stage: one CTA per pair.
//
// Replaces no TPU kernel: the JAX package runs this stage of
// geometry/pnp.py:solve_pnp_ransac (from the top-k start hypotheses to the
// returned pose) as XLA ops inside its jitted pair step. The port ran it as
// PyTorch ops: about 1,900 small launches a call, behind a torch.linalg.svd
// (orthogonalize_pose) that synchronised the host with the card, so the
// card sat idle while the host enqueued them. Here it is one launch that
// reads the hypotheses by their top-k indices and writes the PnPResult.
// The semantics are those of geometry/pnp_kernel.py:refine_and_select_plain:
//
// 1. Each of the k starts (k <= 8) becomes a rigid pose by one polar factor
//    of M = P[:, :3]: R = d U V^T, s = d mean(S), d = det(U V^T), t = p3 / s
//    (|s| < 1e-12 taken as 1e-12); a non-finite M gives a NaN pose. The
//    plain version's second SVD (of -M) and its depth-majority flip give the
//    same R and t (SVD(-M) = (-U) S V^T flips the signs of s and t
//    together), so the kernel takes the first branch alone. The factor comes
//    from one-sided Jacobi on M's columns in float64 (M V = U S with V a
//    product of plane rotations, so det V = 1), and U's column of the
//    smallest singular value from the cross product of the other two, so a
//    nearly singular M keeps an orthonormal R.
// 2. The identity joins as one more start when identity_anneal > 0.
// 3. `iters` Gauss-Newton steps on each start: the gate
//    thr (anneal (1 - frac) + frac), frac = min(i / half, 1), anneal 4 for
//    the hypotheses; the 5-term distorted projection; the analytic 2 x 6
//    Jacobian of _projection_jacobian (its zero entries multiplied out, so a
//    non-finite one poisons the sums as the plain version's does); the 6 x 6
//    normal equations plus damping I solved by LU with partial pivoting; a
//    step with a non-finite entry taken as 0; T <- exp(dx) T with
//    core/lie.py:se3_exp's small-angle branch.
// 4. Candidates [k refined, the first start unrefined, the refined
//    identity] scored as count + clamp(1 - mean_err / thr, 0, 1) over all N
//    points (err * inlier summed, so a NaN error makes a NaN score); the
//    first maximum wins, a NaN counting as the maximum (torch.argmax); the
//    winner's R re-orthonormalised by Gram-Schmidt on its rows.
//
// What bounds it on the H100: neither bytes nor operations. A learned pair
// chunk (48 pairs, N = 1024, 4 starts, 8 steps) reads about 1 MB and does
// about 0.3 GFLOP (utils/roofline.py:pnp_refine_cost: 5 us at the float32
// peak); the time is the chain of 8 dependent steps, each a sweep over the
// points, a reduction of 27 sums and a 6 x 6 solve on one thread. Design:
// - One CTA per pair, the points (X, Y, Z, u, v, valid) in shared memory
//   for every pass. The starts run side by side: a group of warps a start
//   (16 warps shared out, at most 512 threads), each group sweeping all
//   points for its start, its 27 sums reduced by shuffles and then in
//   shared memory in a fixed order, so a pair's result does not depend on
//   P or on the run.
// - The inlier masks of every candidate are kept as ballot words in shared
//   memory, so the mask written out is the one that was counted.
// - The normal equations are summed and solved in float64 (solve6 says
//   why); J and r, the poses and the steps stay float32.
// - Deterministic: no atomics.
// -Xptxas -v (sm_90a): see chip_smoke.py's build line.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStarts = 8;                 // top-k hypotheses a pair
constexpr int kMaxCands = kMaxStarts + 2;     // and the identity and the first start unrefined
constexpr int kMaxWarps = 16;                 // a CTA's warps
constexpr int kSums = 27;                     // J^T J's upper triangle (21) and J^T r (6)
constexpr float kStartAnneal = 4.0f;

struct Camera {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

// a pose: R row-major (9), then t (3)
struct Pose {
  float v[12];
};

__device__ __forceinline__ void transform(const Pose& T, float X, float Y, float Z, float& x, float& y, float& z) {
  x = T.v[0] * X + T.v[1] * Y + T.v[2] * Z + T.v[9];
  y = T.v[3] * X + T.v[4] * Y + T.v[5] * Z + T.v[10];
  z = T.v[6] * X + T.v[7] * Y + T.v[8] * Z + T.v[11];
}

// core/camera.py:project_points with distortion
__device__ __forceinline__ void project(const Camera& c, float X, float Y, float Z, float& u, float& v) {
  const float zs = fabsf(Z) < 1e-9f ? 1e-9f : Z;
  const float x = X / zs, y = Y / zs;
  const float r2 = x * x + y * y;
  const float radial = 1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
  const float xy = x * y;
  const float xd = x * radial + 2.0f * c.p1 * xy + c.p2 * (r2 + 2.0f * x * x);
  const float yd = y * radial + c.p1 * (r2 + 2.0f * y * y) + 2.0f * c.p2 * xy;
  u = xd * c.fx + c.cx;
  v = yd * c.fy + c.cy;
}

// reprojection distance of world point (X, Y, Z) observed at (u, v)
__device__ __forceinline__ float reproject_error(const Camera& c, const Pose& T, float X, float Y, float Z, float u,
                                                 float v) {
  float x, y, z, pu, pv;
  transform(T, X, Y, Z, x, y, z);
  project(c, x, y, z, pu, pv);
  const float du = pu - u, dv = pv - v;
  return sqrtf(du * du + dv * dv);
}

// One point's Gauss-Newton terms (geometry/pnp.py:gauss_newton_refine and
// _projection_jacobian) added to acc: J^T J's upper triangle row by row,
// then J^T r. J and r are float32, as the plain version's; their products
// and sums are float64 (see solve6).
__device__ __forceinline__ void accumulate(const Camera& c, const Pose& T, float X, float Y, float Z, float u, float v,
                                           bool vld, float gate, double acc[kSums]) {
  float Xc, Yc, Zc, pu, pv;
  transform(T, X, Y, Z, Xc, Yc, Zc);
  project(c, Xc, Yc, Zc, pu, pv);
  const float du = pu - u, dv = pv - v;
  const float w = (sqrtf(du * du + dv * dv) < gate && vld) ? 1.0f : 0.0f;
  const float r[2] = {du * w, dv * w};

  const bool guard = fabsf(Zc) < 1e-9f;
  const float zs = guard ? 1e-9f : Zc;
  const float x = Xc / zs, y = Yc / zs;
  const float inv = 1.0f / zs;
  const float jn[2][3] = {{inv, 0.0f, guard ? 0.0f : -x * inv}, {0.0f, inv, guard ? 0.0f : -y * inv}};
  const float r2 = x * x + y * y;
  const float rad = 1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
  const float drad = c.k1 + r2 * (2.0f * c.k2 + 3.0f * c.k3 * r2);
  const float off = 2.0f * x * y * drad + 2.0f * c.p1 * x + 2.0f * c.p2 * y;
  const float jd[2][2] = {{rad + 2.0f * x * x * drad + 2.0f * c.p1 * y + 6.0f * c.p2 * x, off},
                          {off, rad + 2.0f * y * y * drad + 6.0f * c.p1 * y + 2.0f * c.p2 * x}};
  const float f[2] = {c.fx, c.fy};
  // d pixel / d point (2 x 3), then [I | -hat(pc)] (3 x 6)
  const float jpc[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, Zc, -Yc},
                           {0.0f, 1.0f, 0.0f, -Zc, 0.0f, Xc},
                           {0.0f, 0.0f, 1.0f, Yc, -Xc, 0.0f}};
  float J[2][6];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float jpix[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) jpix[k] = f[a] * (jd[a][0] * jn[0][k] + jd[a][1] * jn[1][k]);
#pragma unroll
    for (int m = 0; m < 6; ++m) J[a][m] = (jpix[0] * jpc[0][m] + jpix[1] * jpc[1][m] + jpix[2] * jpc[2][m]) * w;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int i = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
#pragma unroll
      for (int n = m; n < 6; ++n) acc[i++] += (double)J[a][m] * J[a][n];
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) acc[21 + m] += (double)J[a][m] * r[a];
  }
}

// x = A^-1 b by LU with partial pivoting (the first largest pivot), as
// torch.linalg.solve_ex; a zero pivot gives non-finite entries. In float64:
// where few points pass the gate, J^T J is of rank 2 or 4 and the damping
// (1e-6 against diagonals of 1e2-1e7) is below float32's resolution, so a
// float32 solve returns rounding noise (a step of any size, or a zero pivot
// and no step) where the damped step is well defined; the plain version's
// float32 solve is that noise too, so the two agree there only by chance.
__device__ void solve6(double A[6][6], double b[6], double x[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    double best = fabs(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(A[r][c]) > best) {
        best = fabs(A[r][c]);
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const double s = A[c][q];
          A[c][q] = A[r][q];
          A[r][q] = s;
        }
        const double s = b[c];
        b[c] = b[r];
        b[r] = s;
      }
    }
    const double inv = 1.0 / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const double l = A[r][c] * inv;
#pragma unroll
      for (int q = c + 1; q < 6; ++q) A[r][q] -= l * A[c][q];
      b[r] -= l * b[c];
    }
  }
#pragma unroll
  for (int c = 5; c >= 0; --c) {
    double s = b[c];
#pragma unroll
    for (int q = c + 1; q < 6; ++q) s -= A[c][q] * x[q];
    x[c] = s / A[c][c];
  }
}

// T <- exp(dx) T (core/lie.py:se3_exp, dx = [v, w])
__device__ void apply_step(const float dx[6], Pose& T) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(fmaxf(theta2, 1e-12f));
  const bool small = theta2 < 1e-8f;
  const float A = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float C = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - A) / theta2;
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float W2[3][3], Re[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float e = i == j ? 1.0f : 0.0f;
      Re[i][j] = e + A * W[i][j] + B * W2[i][j];
      V[i][j] = e + B * W[i][j] + C * W2[i][j];
    }
  }
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) te[i] = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
  Pose out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out.v[3 * i + j] = Re[i][0] * T.v[j] + Re[i][1] * T.v[3 + j] + Re[i][2] * T.v[6 + j];
    out.v[9 + i] = Re[i][0] * T.v[9] + Re[i][1] * T.v[10] + Re[i][2] * T.v[11] + te[i];
  }
  T = out;
}

// The rigid pose of a raw 3 x 4 hypothesis (row-major): one polar factor
// of its left 3 x 3, as described at the top.
__device__ Pose polar_pose(const float* h) {
  Pose T;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) finite &= isfinite(h[4 * i + j]);
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 12; ++i) T.v[i] = nanf("");
    return T;
  }
  double B[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = h[4 * i + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const double det = B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1]) -
                     B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0]) +
                     B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]);
  const double d = det < 0.0 ? -1.0 : 1.0;
  // one-sided Jacobi: rotate column pairs of B (and V) until orthogonal
  for (int sweep = 0; sweep < 12; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int i = pair == 2 ? 1 : 0, j = pair == 0 ? 1 : 2;
      double a = 0.0, b = 0.0, g = 0.0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        a += B[r][i] * B[r][i];
        b += B[r][j] * B[r][j];
        g += B[r][i] * B[r][j];
      }
      if (fabs(g) <= 1e-15 * sqrt(a * b)) continue;
      rotated = true;
      const double zeta = (b - a) / (2.0 * g);
      const double tn = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double cs = 1.0 / sqrt(1.0 + tn * tn), sn = cs * tn;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double bi = B[r][i], bj = B[r][j];
        B[r][i] = cs * bi - sn * bj;
        B[r][j] = sn * bi + cs * bj;
        const double vi = V[r][i], vj = V[r][j];
        V[r][i] = cs * vi - sn * vj;
        V[r][j] = sn * vi + cs * vj;
      }
    }
    if (!rotated) break;
  }
  double s[3], U[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s[j] = sqrt(B[0][j] * B[0][j] + B[1][j] * B[1][j] + B[2][j] * B[2][j]);
#pragma unroll
    for (int r = 0; r < 3; ++r) U[r][j] = s[j] > 0.0 ? B[r][j] / s[j] : (r == j ? 1.0 : 0.0);
  }
  // c: the smallest singular value; (a, b, c) a cyclic order of (0, 1, 2),
  // so u_c = d (u_a x u_b) and R = d (u_a v_a^T + u_b v_b^T) + (u_a x u_b) v_c^T
  const int c = s[0] <= s[1] && s[0] <= s[2] ? 0 : (s[1] <= s[2] ? 1 : 2);
  double ua[3], ub[3], va[3], vb[3], vc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    ua[r] = c == 0 ? U[r][1] : (c == 1 ? U[r][2] : U[r][0]);
    ub[r] = c == 0 ? U[r][2] : (c == 1 ? U[r][0] : U[r][1]);
    va[r] = c == 0 ? V[r][1] : (c == 1 ? V[r][2] : V[r][0]);
    vb[r] = c == 0 ? V[r][2] : (c == 1 ? V[r][0] : V[r][1]);
    vc[r] = c == 0 ? V[r][0] : (c == 1 ? V[r][1] : V[r][2]);
  }
  const double uc[3] = {ua[1] * ub[2] - ua[2] * ub[1], ua[2] * ub[0] - ua[0] * ub[2], ua[0] * ub[1] - ua[1] * ub[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T.v[3 * i + j] = (float)(d * (ua[i] * va[j] + ub[i] * vb[j]) + uc[i] * vc[j]);
  }
  float sc = (float)(d * (s[0] + s[1] + s[2]) / 3.0);
  if (fabsf(sc) < 1e-12f) sc = 1e-12f;
#pragma unroll
  for (int i = 0; i < 3; ++i) T.v[9 + i] = h[4 * i + 3] / sc;
  return T;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ Pose load_pose(const float* p) {
  Pose T;
#pragma unroll
  for (int i = 0; i < 12; ++i) T.v[i] = p[i];
  return T;
}

__device__ __forceinline__ void store_pose(float* p, const Pose& T) {
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = T.v[i];
}

__global__ void __launch_bounds__(kMaxWarps * 32)
pnp_refine_kernel(const float* __restrict__ hyps, const int64_t* __restrict__ top, const float* __restrict__ pts3d,
                  const float* __restrict__ pts2d, const unsigned char* __restrict__ valid,
                  const float* __restrict__ Kmat, const float* __restrict__ dist, float* __restrict__ R_out,
                  float* __restrict__ t_out, bool* __restrict__ inl_out, int64_t* __restrict__ n_out,
                  bool* __restrict__ ok_out, int H, int N, int k, int group_warps, int iters, float thr,
                  float identity_anneal, float damping, int min_inliers) {
  extern __shared__ float smem[];
  __shared__ float poses[kMaxCands][12];             // candidate poses, refined in place
  __shared__ double sums[kMaxWarps][kSums];          // a warp's Gauss-Newton sums
  __shared__ float err_sums[kMaxCands][kMaxWarps];   // a candidate's inlier error, by warp of its group
  __shared__ int counts[kMaxCands][kMaxWarps];       // and its inliers
  __shared__ float score[kMaxCands];
  __shared__ int count[kMaxCands];
  __shared__ int chosen;

  const int pair = blockIdx.x;
  const bool identity = identity_anneal > 0.0f;
  const int cands = k + 1 + (identity ? 1 : 0);
  const int words = (N + 31) / 32;
  float* sX = smem;
  float* sY = sX + N;
  float* sZ = sY + N;
  float* su = sZ + N;
  float* sv = su + N;
  float* sw = sv + N;                                        // valid as 0 or 1
  uint32_t* masks = reinterpret_cast<uint32_t*>(sw + N);     // cands x words

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = warp / group_warps, gw = warp % group_warps;
  const int group_threads = 32 * group_warps;
  const bool leader = gw == 0 && lane == 0;
  // the candidate a group refines: hypotheses to 0..k-1, the identity to k+1
  // (k holds the first start unrefined)
  const int cand = group < k ? group : k + 1;

  for (int j = tid; j < N; j += blockDim.x) {
    const size_t o = (size_t)pair * N + j;
    sX[j] = pts3d[3 * o];
    sY[j] = pts3d[3 * o + 1];
    sZ[j] = pts3d[3 * o + 2];
    su[j] = pts2d[2 * o];
    sv[j] = pts2d[2 * o + 1];
    sw[j] = valid[o] ? 1.0f : 0.0f;
  }
  const Camera cam{Kmat[0], Kmat[4], Kmat[2], Kmat[5], dist[0], dist[1], dist[2], dist[3], dist[4]};
  if (leader) {
    Pose T;
    if (group < k) {
      T = polar_pose(hyps + ((size_t)pair * H + top[(size_t)pair * k + group]) * 12);
      if (group == 0) store_pose(poses[k], T);
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i) T.v[i] = (i == 0 || i == 4 || i == 8) ? 1.0f : 0.0f;
    }
    store_pose(poses[cand], T);
  }
  __syncthreads();

  const float anneal = group < k ? kStartAnneal : identity_anneal;
  const int half = max(iters / 2, 1);
  for (int it = 0; it < iters; ++it) {
    const double frac = fmin((double)it / half, 1.0);
    // threshold * (anneal * (1 - frac) + frac), rounded as the plain version's float32 ops
    const float gate = __fmul_rn(thr, __fadd_rn(__fmul_rn(anneal, (float)(1.0 - frac)), (float)frac));
    const Pose T = load_pose(poses[cand]);
    double acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0;
    for (int j = gw * 32 + lane; j < N; j += group_threads)
      accumulate(cam, T, sX[j], sY[j], sZ[j], su[j], sv[j], sw[j] != 0.0f, gate, acc);
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = warp_sum(acc[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) sums[warp][i] = acc[i];
    }
    __syncthreads();
    if (leader) {
      double tot[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) tot[i] = sums[warp][i];
      for (int w = 1; w < group_warps; ++w) {
#pragma unroll
        for (int i = 0; i < kSums; ++i) tot[i] += sums[warp + w][i];
      }
      double Hm[6][6], g[6], x[6];
      int i = 0;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
#pragma unroll
        for (int n = m; n < 6; ++n) {
          Hm[m][n] = tot[i];
          Hm[n][m] = tot[i];
          ++i;
        }
        Hm[m][m] += damping;
        g[m] = tot[21 + m];
      }
      solve6(Hm, g, x);
      float dx[6];
      bool finite = true;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        dx[m] = (float)-x[m];
        finite &= isfinite(dx[m]);
      }
      if (!finite) {
#pragma unroll
        for (int m = 0; m < 6; ++m) dx[m] = 0.0f;
      }
      Pose Tn = T;
      apply_step(dx, Tn);
      store_pose(poses[cand], Tn);
    }
    __syncthreads();
  }

  // score the candidates: each group its refined pose, group 0 the first
  // start unrefined as well
  for (int c = cand;; c = k) {
    const Pose T = load_pose(poses[c]);
    int cnt = 0;
    float esum = 0.0f;
    for (int base = gw * 32; base < N; base += group_threads) {
      const int j = base + lane;
      bool in = false;
      if (j < N) {
        const float e = reproject_error(cam, T, sX[j], sY[j], sZ[j], su[j], sv[j]);
        in = e < thr && sw[j] != 0.0f;
        cnt += in ? 1 : 0;
        esum += e * (in ? 1.0f : 0.0f);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, in);
      if (lane == 0) masks[c * words + base / 32] = word;
    }
    cnt = warp_sum(cnt);
    esum = warp_sum(esum);
    if (lane == 0) {
      counts[c][gw] = cnt;
      err_sums[c][gw] = esum;
    }
    if (group != 0 || c == k) break;
  }
  __syncthreads();
  if (tid < cands) {
    const int c = tid;
    int n = 0;
    float e = 0.0f;
    for (int w = 0; w < group_warps; ++w) {
      n += counts[c][w];
      e += err_sums[c][w];
    }
    const float mean_err = e / (float)max(n, 1);
    const float q = 1.0f - mean_err / thr;
    // clamp(q, 0, 1) keeping a NaN, as torch.clamp does
    score[c] = (float)n + (q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q));
    count[c] = n;
  }
  __syncthreads();
  if (tid == 0) {
    // torch.argmax: the first maximum, a NaN above every number
    int best = 0;
    bool best_nan = isnan(score[0]);
    for (int c = 1; c < cands && !best_nan; ++c) {
      if (isnan(score[c])) {
        best = c;
        best_nan = true;
      } else if (score[c] > score[best]) {
        best = c;
      }
    }
    chosen = best;
    const Pose T = load_pose(poses[best]);
    // so3_orthonormalize: Gram-Schmidt on the rows
    float r0[3] = {T.v[0], T.v[1], T.v[2]}, r1[3] = {T.v[3], T.v[4], T.v[5]};
    const float n0 = sqrtf(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) r0[i] /= n0;
    const float dp = r1[0] * r0[0] + r1[1] * r0[1] + r1[2] * r0[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) r1[i] -= dp * r0[i];
    const float n1 = sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) r1[i] /= n1;
    float* R = R_out + (size_t)pair * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      R[i] = r0[i];
      R[3 + i] = r1[i];
      t_out[(size_t)pair * 3 + i] = T.v[9 + i];
    }
    R[6] = r0[1] * r1[2] - r0[2] * r1[1];
    R[7] = r0[2] * r1[0] - r0[0] * r1[2];
    R[8] = r0[0] * r1[1] - r0[1] * r1[0];
    n_out[pair] = count[best];
    ok_out[pair] = count[best] >= min_inliers;
  }
  __syncthreads();
  const uint32_t* m = masks + chosen * words;
  for (int j = tid; j < N; j += blockDim.x) inl_out[(size_t)pair * N + j] = (m[j / 32] >> (j % 32)) & 1u;
}

// the dynamic shared memory a block may take on each device, its attribute
// set once per device (a runtime call on the launch path costs the host-bound
// paths): the opt-in limit less the kernel's static shared memory
constexpr int kDevices = 64;
int g_dynamic_cap[kDevices] = {};

cudaError_t dynamic_cap(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && g_dynamic_cap[dev] > 0) {
    *out = g_dynamic_cap[dev];
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, (const void*)pnp_refine_kernel);
  if (err != cudaSuccess) return err;
  const int cap = optin - (int)fa.sharedSizeBytes;
  err = cudaFuncSetAttribute((const void*)pnp_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return err;
  if (dev < kDevices) g_dynamic_cap[dev] = cap;
  *out = cap;
  return cudaSuccess;
}

// warps a start's group takes: 16 shared out among the starts
int group_warps_for(int groups) { return groups >= kMaxWarps ? 1 : kMaxWarps / groups; }

size_t smem_bytes_for(int N, int cands) {
  return (size_t)6 * N * sizeof(float) + (size_t)cands * ((N + 31) / 32) * sizeof(uint32_t);
}

}  // namespace

extern "C" int fs_pnp_refine(const float* hyps, const int64_t* top, const float* pts3d, const float* pts2d,
                             const unsigned char* valid, const float* K, const float* dist, float* R, float* t,
                             bool* inliers, int64_t* n_inliers, bool* ok, int P, int H, int N, int k, int iters,
                             float thr, float identity_anneal, float damping, int min_inliers, cudaStream_t stream) {
  if (P < 0 || N < 0 || k < 1 || k > kMaxStarts || H < k || iters < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int groups = k + (identity_anneal > 0.0f ? 1 : 0);
  const int gw = group_warps_for(groups);
  const size_t smem = smem_bytes_for(N, groups + 1);
  int cap = 0;
  const cudaError_t err = dynamic_cap(&cap);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  pnp_refine_kernel<<<P, 32 * gw * groups, smem, stream>>>(hyps, top, pts3d, pts2d, valid, K, dist, R, t, inliers,
                                                          n_inliers, ok, H, N, k, gw, iters, thr, identity_anneal,
                                                          damping, min_inliers);
  return (int)cudaGetLastError();
}
