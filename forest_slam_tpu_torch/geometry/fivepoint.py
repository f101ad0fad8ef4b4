"""Batched Nister 5-point minimal solver for the essential matrix (port of
geometry/fivepoint.py).

The minimal solver of ``cv2.findEssentialMat``, the reference's monocular
estimator, as fixed-shape tensor work over any leading batch (pairs x
hypotheses):

1. the 4-dim nullspace (X, Y, Z, W) of the 5x9 epipolar system, by blocked
   inverse iteration on its 9x9 normal matrix;
2. the 10x20 cubic constraint matrix of E = xX + yY + zZ + W (det E and
   2 E E^T E - tr(E E^T) E) built by generic trivariate polynomial products
   (monomial product tensors made in numpy at import);
3. Gauss-Jordan by one batched solve, Nister's 3x3 system B(z) [x, y, 1]^T
   = 0 and its degree-10 determinant;
4. the real roots by sign sampling over z = tan(t) on a fixed grid of
   ``N_SAMPLES`` values of t in (-pi/2, pi/2) and 14 bisection steps (no
   eigensolver);
5. per root, (x, y) from B(z) in least squares and 6 Gauss-Newton steps on
   the cubic constraints evaluated from E itself, with an analytic
   Jacobian (E is linear in (x, y, z)); a candidate whose constraints the
   polish did not bring below ``CONSTRAINT_TOL`` is not valid.

Two departures from the reference, for what its float32 solve loses. The
solve runs in float64 (Hopper's CUDA cores run it at half the float32
rate): in float32 the shifted 9x9 normal matrix of step 1 is singular to
working precision, the reference's unrolled Cholesky meets a negative pivot
and leaves a sample without candidates (29 of 128 general-scene RANSAC samples
and 90 of 128 planar ones in tests/test_torch_fivepoint.py), and the
elimination loses or invents roots. And the grid has 1024 points, not 256:
two roots in one grid interval give no sign change, and a finer grid
separates more of them. The grid's monomials are computed in float64 at
import, so every device brackets the roots alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from forest_slam_tpu_torch.core.lie import mm

# monomial bases (exponent triples of x^i y^j z^k)
_B1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_B2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0), (0, 2, 0),
    (0, 1, 1), (0, 1, 0), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# degree 3: the first 10 are eliminated by Gauss-Jordan (x, y-degree >= 2),
# the last 10 are the kept set K = [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
_B3 = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _product_tensor(basis_a, basis_b, basis_out) -> np.ndarray:
    """M[a, b, c] = 1 where monomial_a * monomial_b == monomial_out_c."""
    index = {m: i for i, m in enumerate(basis_out)}
    M = np.zeros((len(basis_a), len(basis_b), len(basis_out)), np.float32)
    for i, ma in enumerate(basis_a):
        for j, mb in enumerate(basis_b):
            M[i, j, index[tuple(x + y for x, y in zip(ma, mb))]] = 1.0
    return M


N_SAMPLES = 1024  # t grid points, ends included
BISECT_ITERS = 14
POLISH_ITERS = 6
NULL_ITERS = 12
# largest cubic-constraint residual of a unit-norm candidate that counts as solved
CONSTRAINT_TOL = 1e-9
_T = np.linspace(-np.pi / 2, np.pi / 2, N_SAMPLES)[1:-1]  # the open interval
_DEG = 10
_K = np.arange(_DEG + 1)
_CONSTS = {
    "m11": _product_tensor(_B1, _B1, _B2).reshape(16, 10),  # deg1 * deg1 -> deg2
    "m21": _product_tensor(_B2, _B1, _B3).reshape(40, 20),  # deg2 * deg1 -> deg3
    "t": _T,
    # sin^k cos^(10-k) on the grid, for the homogenised degree-10 polynomial
    "grid": np.sin(_T)[:, None] ** _K * np.cos(_T)[:, None] ** (_DEG - _K),
    # deterministic full-rank start of the nullspace iteration
    "v0": np.eye(9)[:, :4] + 0.01 * np.arange(36).reshape(9, 4),
}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The module's constant ``name`` on ``device``, copied there once."""
    return torch.as_tensor(_CONSTS[name], dtype=dtype, device=device)


def _c(name: str, like: torch.Tensor) -> torch.Tensor:
    return _const(name, like.device, like.dtype)


def _mul11(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of degree-1 polynomials (..., 4) -> degree 2 (..., 10)."""
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)
    return mm(outer[..., None, :], _c("m11", a))[..., 0, :]


def _mul21(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of degree 2 (..., 10) and degree 1 (..., 4) -> degree 3 (..., 20)."""
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)
    return mm(outer[..., None, :], _c("m21", a))[..., 0, :]


def constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """Nullspace basis (..., 4, 3, 3) [X, Y, Z, W] -> constraint matrix
    (..., 10, 20): det(E), then the 9 entries of 2 E E^T E - tr(E E^T) E,
    over the degree-3 monomials _B3."""
    E = basis.movedim(-3, -1)  # (..., 3, 3, 4): entries as polynomials over [x, y, z, 1]

    def minor2(r0, c0, r1, c1):
        return _mul11(E[..., r0, c0, :], E[..., r1, c1, :]) - _mul11(E[..., r0, c1, :], E[..., r1, c0, :])

    det = (_mul21(minor2(1, 1, 2, 2), E[..., 0, 0, :]) - _mul21(minor2(1, 0, 2, 2), E[..., 0, 1, :])
           + _mul21(minor2(1, 0, 2, 1), E[..., 0, 2, :]))  # (..., 20)
    # P = E E^T (degree 2): sum_j E[i, j, a] E[k, j, b] through the product tensor
    Q = (E[..., :, None, :, :, None] * E[..., None, :, :, None, :]).sum(-3)  # (..., 3, 3, 4, 4)
    P = mm(Q.flatten(-2)[..., None, :], _c("m11", basis))[..., 0, :]  # (..., 3, 3, 10)
    trace = P[..., 0, 0, :] + P[..., 1, 1, :] + P[..., 2, 2, :]
    S = (P[..., :, :, None, :, None] * E[..., None, :, :, None, :]).sum(-4)  # (..., 3, 3, 10, 4)
    PE = mm(S.flatten(-2)[..., None, :], _c("m21", basis))[..., 0, :]  # (..., 3, 3, 20)
    T = (trace[..., None, None, :, None] * E[..., :, :, None, :]).flatten(-2)  # (..., 3, 3, 40)
    trE = mm(T[..., None, :], _c("m21", basis))[..., 0, :]
    tr_rows = (2.0 * PE - trE).flatten(-3, -2)  # (..., 9, 20)
    return torch.cat([det[..., None, :], tr_rows], dim=-2)


def _powers(x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, ..., x^n] along a new last axis, by repeated products."""
    out = [torch.ones_like(x)]
    for _ in range(n):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def poly_eval_homog(coeffs: torch.Tensor, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_k coeffs[..., k] s^k c^(D-k), the homogenised degree-D polynomial
    at z = s / c; coeffs (..., D+1), s and c broadcastable against coeffs'
    batch."""
    D = coeffs.shape[-1] - 1
    return (coeffs * _powers(s, D) * _powers(c, D).flip(-1)).sum(-1)


def conv1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of polynomials given by ascending coefficients (..., la), (..., lb)."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (la + lb - 1,), dtype=a.dtype,
                      device=a.device)
    for i in range(la):
        out = out + torch.nn.functional.pad(a[..., i:i + 1] * b, (i, la - 1 - i))
    return out


def det_b_poly(Bx: torch.Tensor, By: torch.Tensor, Bc: torch.Tensor) -> torch.Tensor:
    """det [[Bx_i, By_i, Bc_i]]_{i<3}, rows Bx, By of degree 3 (..., 3, 4) and
    Bc of degree 4 (..., 3, 5) in z -> degree-10 coefficients (..., 11), by
    cofactors along the third column."""

    def m2(p, q, r, s):
        return conv1d(p, s) - conv1d(q, r)

    c0 = m2(Bx[..., 1, :], By[..., 1, :], Bx[..., 2, :], By[..., 2, :])
    c1 = m2(Bx[..., 0, :], By[..., 0, :], Bx[..., 2, :], By[..., 2, :])
    c2 = m2(Bx[..., 0, :], By[..., 0, :], Bx[..., 1, :], By[..., 1, :])
    return conv1d(Bc[..., 0, :], c0) - conv1d(Bc[..., 1, :], c1) + conv1d(Bc[..., 2, :], c2)


def real_roots_deg10(coeffs: torch.Tensor, bisect_iters: int = BISECT_ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """Real roots of degree-10 polynomials (ascending, (..., 11)): the first
    10 grid intervals of t in (-pi/2, pi/2) whose ends differ in sign (or
    hold a zero) as brackets of z = tan(t), then bisection. Returns (roots
    (..., 10), valid (..., 10))."""
    coeffs = coeffs / torch.clamp(coeffs.abs().amax(-1, keepdim=True), min=1e-30)
    # signs only: one float64 product (no TF32, and no (..., N_SAMPLES, 11) temporary)
    vals = coeffs.double() @ _const("grid", coeffs.device, torch.float64).T  # (..., N_SAMPLES - 2)
    sign = torch.sign(vals)
    change = sign[..., :-1] * sign[..., 1:] <= 0.0
    n_int = change.shape[-1]
    order = torch.where(change, torch.arange(n_int, device=coeffs.device), n_int + 1)
    first10 = torch.sort(order, dim=-1).values[..., :10]
    valid = first10 < n_int
    idx = torch.where(valid, first10, torch.zeros_like(first10))
    t = _c("t", coeffs)
    lo, hi = t[idx], t[idx + 1]
    cf = coeffs[..., None, :]
    f_lo = poly_eval_homog(cf, torch.sin(lo), torch.cos(lo))
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        f_mid = poly_eval_homog(cf, torch.sin(mid), torch.cos(mid))
        left = f_lo * f_mid <= 0.0  # the root is in [lo, mid]
        lo, hi, f_lo = torch.where(left, lo, mid), torch.where(left, mid, hi), torch.where(left, f_lo, f_mid)
    return torch.tan(0.5 * (lo + hi)), valid


def _mgs(V: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt on the 4 columns of (..., 9, 4)."""
    cols = []
    for j in range(V.shape[-1]):
        v = V[..., :, j]
        for c in cols:
            v = v - (c * v).sum(-1, keepdim=True) * c
        cols.append(v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12))
    return torch.stack(cols, dim=-1)


def null4_subspace(AtA: torch.Tensor, iters: int = NULL_ITERS) -> torch.Tensor:
    """Orthonormal basis (..., 4, 9) of the 4-dim near-nullspace of PSD
    (..., 9, 9): blocked inverse iteration with the scale-normalised
    shifted inverse (shift 1e-8, below the 4th/5th eigenvalue gap of noisy
    planar samples), an LU inverse (``inv_ex``), and Gram-Schmidt after each
    product. Meant for float64: in float32 the shifted matrix is singular
    to working precision."""
    eye = torch.eye(9, dtype=AtA.dtype, device=AtA.device)
    scale = torch.clamp(AtA.diagonal(dim1=-2, dim2=-1).sum(-1) / 9.0, min=1e-12)
    Binv = torch.linalg.inv_ex(AtA / scale[..., None, None] + 1e-8 * eye).inverse
    V = _mgs(_c("v0", AtA).expand(AtA.shape[:-2] + (9, 4)))
    for _ in range(iters):
        V = _mgs(mm(Binv, V))
    return V.transpose(-1, -2)


def _residuals(E: torch.Tensor, D: torch.Tensor | None = None):
    """The 10 cubic constraints (..., 10) of E (..., 3, 3), det(E) and
    2 E E^T E - tr(E E^T) E; with directions D (..., 3, 3, 3), also their
    derivatives (..., 10, 3) along them (E is linear in (x, y, z))."""
    Et = E.transpose(-1, -2)
    P = mm(E, Et)
    tr = P.diagonal(dim1=-2, dim2=-1).sum(-1)
    tc = 2.0 * mm(P, E) - tr[..., None, None] * E
    r0, r1, r2 = E[..., 0, :], E[..., 1, :], E[..., 2, :]
    cof = torch.stack([torch.linalg.cross(r1, r2, dim=-1), torch.linalg.cross(r2, r0, dim=-1),
                       torch.linalg.cross(r0, r1, dim=-1)], dim=-2)
    r = torch.cat([(r0 * cof[..., 0, :]).sum(-1)[..., None], tc.flatten(-2)], dim=-1)
    if D is None:
        return r
    Dk = D.movedim(-3, 0)  # (3, ..., 3, 3)
    dP = mm(Dk, Et) + mm(E, Dk.transpose(-1, -2))
    dtr = dP.diagonal(dim1=-2, dim2=-1).sum(-1)
    dtc = 2.0 * (mm(dP, E) + mm(P, Dk)) - dtr[..., None, None] * E - tr[..., None, None] * Dk
    ddet = (cof * Dk).sum((-2, -1))  # (3, ...)
    J = torch.cat([ddet[..., None], dtc.flatten(-2)], dim=-1).movedim(0, -1)  # (..., 10, 3)
    return r, J


def polish(s: torch.Tensor, basis: torch.Tensor, iters: int = POLISH_ITERS) -> torch.Tensor:
    """Gauss-Newton on the cubic constraints of E(s) = xX + yY + zZ + W,
    evaluated from E itself (not from the expanded constraint matrix, which
    carries the resultant's cancellation noise). s (..., 3); basis
    (..., 4, 3, 3) broadcast against s's batch; a step that comes out
    non-finite is not taken."""
    D = basis[..., :3, :, :]
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(iters):
        E = (s[..., :, None, None] * D).sum(-3) + basis[..., 3, :, :]
        r, J = _residuals(E, D)
        Jt = J.transpose(-1, -2)
        h = mm(Jt, J) + 1e-12 * eye
        g = (Jt * r[..., None, :]).sum(-1)
        s_new = s - torch.linalg.solve_ex(h, g[..., None]).result[..., 0]
        s = torch.where(torch.isfinite(s_new).all(-1, keepdim=True), s_new, s)
    return s


def _horner(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Ascending coefficients p (..., d) at z (broadcast against p's batch)."""
    y = p[..., -1]
    for k in range(p.shape[-1] - 2, -1, -1):
        y = y * z + p[..., k]
    return y


def five_point_candidates(x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """5-point minimal solves: (..., 5, 2) + (..., 5, 2) normalised
    coordinates -> candidate essential matrices (..., 10, 3, 3) of unit
    Frobenius norm, in the inputs' dtype, and their validity (..., 10).
    The solve runs in float64 (see the module docstring)."""
    from forest_slam_tpu_torch.geometry.epipolar import epipolar_rows

    dtype = x0.dtype
    A = epipolar_rows(x0.double(), x1.double())  # (..., 5, 9)
    basis = null4_subspace(mm(A.transpose(-1, -2), A)).reshape(A.shape[:-2] + (4, 3, 3))
    C = constraint_matrix(basis)
    C = C / torch.clamp(C.abs().amax(-1, keepdim=True), min=1e-30)
    L = -torch.linalg.solve_ex(C[..., :10], C[..., 10:]).result  # rows over K: h_i = L[i] . K

    # Nister's rows z * L[m] - L[mz] for m in (x^2, xy, y^2); over K a row
    # reads a(z) x + b(z) y + g(z), a = cols (2, 1, 0), b = (5, 4, 3), g = (9, 8, 7, 6)
    def split(row):
        return row[..., 0:3].flip(-1), row[..., 3:6].flip(-1), row[..., 6:10].flip(-1)

    def z_shift_minus(pm, pz):  # z * pm - pz, ascending
        zero = torch.zeros_like(pm[..., :1])
        return torch.cat([zero, pm], dim=-1) - torch.cat([pz, zero], dim=-1)

    rows = [(z_shift_minus(am, az), z_shift_minus(bm, bz), z_shift_minus(gm, gz))
            for (am, bm, gm), (az, bz, gz) in ((split(L[..., m, :]), split(L[..., mz, :]))
                                               for m, mz in ((7, 4), (8, 5), (9, 6)))]
    Bx, By, Bc = (torch.stack(p, dim=-2) for p in zip(*rows))  # (..., 3, 4), (..., 3, 4), (..., 3, 5)
    roots, valid = real_roots_deg10(det_b_poly(Bx, By, Bc))  # (..., 10)

    # B(z) [x, y, 1]^T = 0 in least squares: rows equilibrated, 2x2 normal equations
    z = roots[..., :, None]  # (..., 10, 1) against the 3 rows
    Bz = torch.stack([_horner(Bx[..., None, :, :], z), _horner(By[..., None, :, :], z),
                      _horner(Bc[..., None, :, :], z)], dim=-1)  # (..., 10, 3, 3)
    Bz = Bz / torch.clamp(torch.linalg.vector_norm(Bz, dim=-1, keepdim=True), min=1e-30)
    a0, a1, bb = Bz[..., 0], Bz[..., 1], -Bz[..., 2]
    m00 = (a0 * a0).sum(-1) + 1e-12
    m01 = (a0 * a1).sum(-1)
    m11 = (a1 * a1).sum(-1) + 1e-12
    g0, g1 = (a0 * bb).sum(-1), (a1 * bb).sum(-1)
    det2 = m00 * m11 - m01 * m01
    det2 = torch.where(det2.abs() < 1e-30, torch.full_like(det2, 1e-30), det2)
    x = (m11 * g0 - m01 * g1) / det2
    y = (m00 * g1 - m01 * g0) / det2
    w_ok = torch.isfinite(x) & torch.isfinite(y)
    x, y = torch.where(w_ok, x, torch.zeros_like(x)), torch.where(w_ok, y, torch.zeros_like(y))
    s = polish(torch.stack([x, y, roots], dim=-1), basis[..., None, :, :, :])
    E = (s[..., :, None, None] * basis[..., None, :3, :, :]).sum(-3) + basis[..., None, 3, :, :]
    n = torch.linalg.vector_norm(E, dim=(-2, -1))
    E = E / torch.clamp(n, min=1e-30)[..., None, None]
    # a root whose polish did not converge gives no essential matrix
    solved = _residuals(E).abs().amax(-1) < CONSTRAINT_TOL
    return E.to(dtype), w_ok & torch.isfinite(n) & (n > 1e-20) & valid & solved
