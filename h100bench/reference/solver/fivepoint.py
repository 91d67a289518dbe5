# Frozen copy of far_tpu_torch/geometry/fivepoint.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Nister 5-point minimal solver, batched.

Counterpart of ``far_tpu/geometry/fivepoint.py``, with the same algorithm,
fixed constants and candidate order, so the two packages' candidates line
up slot for slot wherever f32 pins the roots (det C(z) is nearly
singular, so a few ulp of C(z) can move an ill-conditioned root; see
tests/test_torch_fivepoint.py):

1. the 4-dim nullspace of the 5x9 epipolar system by Householder QR;
2. with E(x, y, z) = x E1 + y E2 + z E3 + E4, the ten cubic constraints
   (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) form C(z) m(x, y) = 0 with
   m the ten xy-monomials of degree <= 3. C(z) is recovered at any z from
   constraint values at 10 fixed (x, y) nodes through a precomputed
   inverse Vandermonde; det C(z), a degree-10 polynomial, is sampled at 11
   Chebyshev nodes (unpivoted elimination after a fixed orthogonal mix)
   and interpolated;
3. its ten roots by a fixed 64-step Durand-Kerner sweep;
4. (x, y) of each near-real root from the nullvector of C(z*) by inverse
   iteration (``smallest_eigvec_power``).

Every sample gives up to 10 candidates per basis rotation and a validity
mask. The matrices are (..., n, n) tensors with one vectorised row update
per pivot step (the JAX package unpacks them into per-component arrays
for the TPU's layout; eager PyTorch would pay one launch per entry).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from h100bench.reference.solver.solvers import smallest_eigvec_power
from h100bench.reference.solver.tables import device_table

_EPS = 1e-12

# ---------------------------------------------------------------------- #
# fixed evaluation geometry (numpy, computed once at import, as the JAX
# package computes it: same seeds, same picks)
# ---------------------------------------------------------------------- #

# xy-monomial exponents of m(x, y) = (x^3, x^2 y, x y^2, y^3, x^2, x y,
# y^2, x, y, 1)
_MONO_PX = np.array([3, 2, 1, 0, 2, 1, 0, 1, 0, 0])
_MONO_PY = np.array([0, 1, 2, 3, 0, 1, 2, 0, 1, 0])


def _pick_xy_nodes(n_try: int = 256) -> np.ndarray:
    """10 (x, y) nodes with the best-conditioned cubic Vandermonde among
    ``n_try`` seeded draws."""
    best, best_cond = None, np.inf
    for seed in range(n_try):
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-1.0, 1.0, (10, 2))
        V = (pts[:, :1] ** _MONO_PX) * (pts[:, 1:] ** _MONO_PY)
        c = np.linalg.cond(V)
        if c < best_cond:
            best, best_cond = pts, c
    return best


_XY_NODES = _pick_xy_nodes()                                   # (10, 2)
_V_XY = (_XY_NODES[:, :1] ** _MONO_PX) * (_XY_NODES[:, 1:] ** _MONO_PY)
# C(z) = Qvals @ V^-T, Qvals[i, j] = q_i(x_j, y_j, z)
_VINV_T = np.linalg.inv(_V_XY.astype(np.float64)).T.astype(np.float32)

# 11 Chebyshev z-nodes on [-1, 1] and the inverse Vandermonde from
# det values to monomial coefficients (f64 inverse, stored f32)
_Z_NODES = np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi).astype(np.float64)
_W_Z = _Z_NODES[:, None] ** np.arange(11)[None, :]
_WINV_Z = np.linalg.inv(_W_Z).astype(np.float32)               # (11, 11)


def _basis_rotations(k: int) -> np.ndarray:
    """Fixed orthogonal 4x4 re-mixes of the nullspace basis, the first the
    identity. A solution with a small E4 coefficient sits at a huge |z|
    that the f32 interpolation cannot pin; a rotated basis moves it, so
    the candidates of a couple of rotations are pooled."""
    rots = [np.eye(4)]
    rng = np.random.default_rng(11)
    for _ in range(k - 1):
        Q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
        rots.append(Q)
    return np.stack(rots).astype(np.float32)                   # (k, 4, 4)


def _det_mix(n: int) -> np.ndarray:
    """The fixed orthogonal row mix of ``det_gauss_mixed``."""
    Q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(n, n)))
    return Q.astype(np.float32)


def _dk_start(n: int) -> np.ndarray:
    """Durand-Kerner start: 1.4 exp(2 pi i (k + 0.37) / n), complex64."""
    angles = (2.0 * np.pi * (np.arange(n) + 0.37) / n).astype(np.complex64)
    return (1.4 * np.exp(1j * angles)).astype(np.complex64)


_TABLES = {"xy_nodes": lambda n: _XY_NODES, "vinv_t": lambda n: _VINV_T,
           "z_nodes": lambda n: _Z_NODES, "winv_z": lambda n: _WINV_Z,
           "det_mix": _det_mix, "rotations": _basis_rotations,
           "dk_start": _dk_start}


def _table(name: str, n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A fixed table on a device, copied there once (``device_table``)."""
    return device_table(_TABLES[name], n, device=device, dtype=dtype)


def _const(name: str, like: torch.Tensor, n: int = 0) -> torch.Tensor:
    return _table(name, n, like.device, like.dtype)


# ---------------------------------------------------------------------- #
# batched small linear algebra
# ---------------------------------------------------------------------- #

def det_gauss_mixed(M: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., n, n) by unpivoted elimination after a
    fixed orthogonal row mix Q, which keeps the growth benign without a
    pivot search. Every determinant carries the same factor det(Q) = +-1,
    which the interpolation downstream does not see (it is scale-free
    across the z-nodes)."""
    n = M.shape[-1]
    # Q M summed over k in order, as the JAX package sums it: the
    # elimination amplifies the rounding of another order to ~2e-3 of
    # the determinant on C(z)
    Q = _const("det_mix", M, n)
    A = Q[:, 0:1] * M[..., 0:1, :]
    for k in range(1, n):
        A = A + Q[:, k:k + 1] * M[..., k:k + 1, :]
    det = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    for k in range(n):
        piv = A[..., k, k]
        det = det * piv
        inv_piv = torch.where(piv.abs() < _EPS, torch.zeros_like(piv), 1.0 / piv)
        f = A[..., k + 1:, k] * inv_piv[..., None]                 # (..., n-k-1)
        A[..., k + 1:, k + 1:] -= f[..., :, None] * A[..., k:k + 1, k + 1:]
    return det


def det_gauss(M: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., n, n) by Gaussian elimination with
    partial pivoting (first row of the largest magnitude on ties)."""
    n = M.shape[-1]
    A = M
    rows = torch.arange(n, device=M.device)
    det = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    for k in range(n):
        col = torch.where(rows >= k, A[..., :, k].abs(),
                          torch.full_like(A[..., :, k], -float("inf")))
        p = col.argmax(dim=-1)                                      # (...,)
        pk = p[..., None]
        perm = torch.where(rows == k, pk, torch.where(rows == pk, k, rows))
        A = torch.gather(A, -2, perm[..., None].expand(A.shape))
        det = torch.where(p == k, det, -det)
        piv = A[..., k, k]
        det = det * piv
        inv_piv = torch.where(piv.abs() < _EPS, torch.zeros_like(piv), 1.0 / piv)
        factor = A[..., :, k] * inv_piv[..., None] * (rows > k).to(M.dtype)
        A = A - factor[..., :, None] * A[..., k:k + 1, :]
    return det


def _nullspace4(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis (..., 9, 4) of the nullspace of (..., 5, 9) by
    Householder QR of A^T: the last four columns of Q."""
    M = A.transpose(-1, -2)                                         # (..., 9, 5)
    rows = torch.arange(9, device=A.device)
    Qt = torch.eye(9, dtype=A.dtype, device=A.device).expand(*M.shape[:-2], 9, 9)
    for k in range(5):
        xcol = M[..., :, k] * (rows >= k)
        nrm = torch.linalg.norm(xcol, dim=-1)
        s = torch.where(M[..., k, k] >= 0, 1.0, -1.0).to(A.dtype)
        v = xcol + (s * nrm)[..., None] * (rows == k)
        vtv = (v * v).sum(-1)
        beta = torch.where(vtv > _EPS, 2.0 / (vtv + _EPS), torch.zeros_like(vtv))
        bv = beta[..., None, None] * v[..., :, None]
        M = M - bv * (v[..., None, :] @ M)
        Qt = Qt - bv * (v[..., None, :] @ Qt)
    return Qt[..., 5:9, :].transpose(-1, -2)                        # (..., 9, 4)


def det3(E: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the cofactor expansion of row 0."""
    return (E[..., 0, 0] * (E[..., 1, 1] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 1])
            - E[..., 0, 1] * (E[..., 1, 0] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 0])
            + E[..., 0, 2] * (E[..., 1, 0] * E[..., 2, 1] - E[..., 1, 1] * E[..., 2, 0]))


# ---------------------------------------------------------------------- #
# constraint evaluation
# ---------------------------------------------------------------------- #

def _constraints_at(Ebasis: torch.Tensor, x, y, z) -> torch.Tensor:
    """The 10 Nister constraint values [det E, vec(2 E E^T E - tr(E E^T) E)]
    (..., P, 10) at points (x, y, z) (..., P) of the basis (..., 4, 3, 3)."""
    coef = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)       # (..., P, 4)
    E = torch.einsum("...pk,...kij->...pij", coef, Ebasis)          # (..., P, 3, 3)
    EEt = E @ E.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    ct = 2.0 * (EEt @ E) - tr * E
    return torch.cat([det3(E)[..., None], ct.flatten(-2)], dim=-1)


def _c_of_z(Ebasis: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Numeric C(z) (..., Z, 10, 10) for z (..., Z): row i holds the
    xy-monomial coefficients of constraint i at that z."""
    Z = z.shape[-1]
    xy = _const("xy_nodes", z)                                       # (10, 2)
    lead = z.shape[:-1]
    xs = xy[:, 0].expand(*lead, Z, 10).reshape(*lead, Z * 10)
    ys = xy[:, 1].expand(*lead, Z, 10).reshape(*lead, Z * 10)
    zs = z.repeat_interleave(10, dim=-1)
    q = _constraints_at(Ebasis, xs, ys, zs).reshape(*lead, Z, 10, 10)
    return q.transpose(-1, -2) @ _const("vinv_t", z)                 # (..., Z, ci, xy)


# ---------------------------------------------------------------------- #
# degree-10 roots by Durand-Kerner
# ---------------------------------------------------------------------- #

def durand_kerner_roots(coeffs: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """All complex roots of batched polynomials, coeffs (..., n+1) with
    coeffs[..., d] the coefficient of z^d -> (..., n) complex64.

    The polynomial is first balanced by z = s u with s = max_k
    |c_k / c_n|^(1/(n-k)), so every root has |u| <= 2; the start is the
    JAX package's, 1.4 exp(2 pi i (k + 0.37) / n), and each step is
    clamped to length 3. Degenerate polynomials give garbage roots, which
    the callers' realness and magnitude checks mask."""
    n = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    safe = torch.where(lead.abs() < 1e-20, torch.full_like(lead, 1e-20), lead)
    ratios = (coeffs[..., :-1] / safe).abs()
    k = torch.arange(n, device=coeffs.device, dtype=coeffs.dtype)
    s = (ratios ** (1.0 / (n - k))).amax(dim=-1).clamp(1e-6, 1e6)[..., None]
    powers = torch.arange(n + 1, device=coeffs.device, dtype=coeffs.dtype)
    c = coeffs * s ** powers
    c = (c / c[..., -1:]).to(torch.complex64)                       # monic in u

    w = _table("dk_start", n, coeffs.device, torch.complex64).expand(
        *coeffs.shape[:-1], n)
    eye = torch.eye(n, dtype=torch.complex64, device=coeffs.device)
    cs = [c[..., None, kk] for kk in range(n + 1)]
    for _ in range(iters):
        pw = cs[n]                                                  # Horner
        for kk in range(n - 1, -1, -1):
            pw = pw * w + cs[kk]
        denom = (w[..., :, None] - w[..., None, :] + eye).prod(dim=-1)
        step = pw / torch.where(denom.abs() < 1e-20,
                                torch.full_like(denom, 1e-20), denom)
        mag = step.abs()
        step = torch.where(mag > 3.0, step * (3.0 / mag), step)
        w = w - step
    return w * s.to(torch.complex64)


# ---------------------------------------------------------------------- #
# the solver
# ---------------------------------------------------------------------- #

def _solve_from_basis(Ebasis: torch.Tensor, real_tol: float,
                      det_tol: float = 2.5e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to 10 essential candidates (..., 10, 3, 3) and their mask from a
    nullspace basis (..., 4, 3, 3)."""
    batch = Ebasis.shape[:-3]
    # p(z) = det C(z) by sampling at the Chebyshev nodes + interpolation
    z_nodes = _const("z_nodes", Ebasis).expand(*batch, 11)
    detvals = det_gauss_mixed(_c_of_z(Ebasis, z_nodes))             # (..., 11)
    # scale-normalise: the det values span a large range in f32
    dmax = detvals.abs().amax(dim=-1, keepdim=True) + _EPS
    coeffs = (detvals / dmax) @ _const("winv_z", Ebasis).t()

    roots = durand_kerner_roots(coeffs)                             # (..., 10)
    re, im = roots.real, roots.imag
    is_real = im.abs() <= real_tol * (1.0 + re.abs())
    z = re

    # (x, y) from the nullvector of C(z*)
    Cz = _c_of_z(Ebasis, z)                                         # (..., 10, 10, 10)
    v = smallest_eigvec_power(Cz.transpose(-1, -2) @ Cz, iters=4)   # (..., 10, 10)
    wv = v[..., 9]
    finite_xy = wv.abs() > 1e-6
    inv_w = torch.where(finite_xy, 1.0 / torch.where(finite_xy, wv, torch.ones_like(wv)),
                        torch.zeros_like(wv))
    x = v[..., 7] * inv_w
    y = v[..., 8] * inv_w

    coef = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)       # (..., 10, 4)
    E = torch.einsum("...rk,...kij->...rij", coef, Ebasis)          # (..., 10, 3, 3)
    nrm = torch.linalg.norm(E, dim=(-2, -1), keepdim=True)
    E = E * (2.0 ** 0.5 / (nrm + _EPS))

    # on the essential manifold a true root's det E is at f32 noise level;
    # spurious near-real roots that pass the magnitude checks are not
    valid = (is_real & finite_xy
             & (z.abs() < 1e3) & (x.abs() < 1e3) & (y.abs() < 1e3)
             & (det3(E).abs() < det_tol)
             & torch.isfinite(E).all(dim=-1).all(dim=-1))
    # masked slots stay finite: residuals are computed over every slot
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    E = torch.where(valid[..., None, None], torch.nan_to_num(E), eye)
    return E, valid


def run_5point_essential(points1: torch.Tensor, points2: torch.Tensor,
                         real_tol: float = 5e-2, n_basis_rotations: int = 2,
                         det_tol: float = 2.5e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nister 5-point solve on K-normalised correspondences.

    Args:
        points1/points2: (..., 5, 2), epipolar convention p2^T E p1 = 0.
        real_tol: relative imaginary part below which a root is real.
        n_basis_rotations: elimination passes under fixed basis re-mixes
            (candidates pooled).
        det_tol: |det E| acceptance threshold on sqrt(2)-normalised
            candidates.
    Returns:
        E (..., 10 * n_basis_rotations, 3, 3), Frobenius norm sqrt(2)
        where valid (identity elsewhere); valid (..., 10 * n_basis_rotations).
    """
    x1, y1 = points1[..., 0], points1[..., 1]
    x2, y2 = points2[..., 0], points2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)                  # (..., 5, 9)
    basis = _nullspace4(A)                                          # (..., 9, 4)
    Ebasis = basis.transpose(-1, -2).reshape(*basis.shape[:-2], 4, 3, 3)
    rots = _const("rotations", A, n_basis_rotations)
    Eb_r = torch.einsum("rkm,...mij->...rkij", rots, Ebasis)        # (..., R, 4, 3, 3)
    E, valid = _solve_from_basis(Eb_r, real_tol, det_tol)
    return (E.reshape(*E.shape[:-4], n_basis_rotations * 10, 3, 3),
            valid.reshape(*valid.shape[:-2], n_basis_rotations * 10))
