# Frozen copy of far_tpu_torch/geometry/solvers.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Weighted 8-point solver, essential decompositions and cheirality vote.

Counterpart of the solver parts of ``far_tpu/geometry/solvers.py``:
Hartley normalization, the DLT normal equations solved by inverse
iteration (``impl='power'``) or an eigensolver (``impl='eigh'``, the
polish step and ``linalg='exact'``) with its rank-2 and essential
projections by a 3x3 SVD (``ops/small_linalg``: ``torch.linalg`` on the
CPU, hand-written kernels on CUDA, which read nothing back to the host,
so a request can be captured in a CUDA graph), the SVD-free adjugate
decomposition of E, and the recoverPose cheirality vote over the fast or
the SVD decomposition. Everything is batched over leading axes; invalid
correspondences carry weight 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from h100bench.reference.solver.epipolar import (
    cross_product_matrix,
    motion_from_essential,
)
from h100bench.reference.solver.rotations import (
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)
from h100bench.reference.solver.transforms import to_homogeneous
from h100bench.reference.solver.tables import device_table

_EPS = 1e-8


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(M, dim=(-2, -1), keepdim=True)


def normalize_points(points: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Hartley normalization: centroid to 0, mean distance
    sqrt(2). points (..., N, 2) -> (points_norm, T (..., 3, 3))."""
    w = torch.ones(points.shape[:-1], dtype=points.dtype,
                   device=points.device) if weights is None else weights
    wsum = w.sum(-1, keepdim=True) + eps
    mean = (points * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    dist = torch.linalg.norm(points - mean, dim=-1)
    scale = (dist * w).sum(-1, keepdim=True) / wsum
    scale = 2.0 ** 0.5 / (scale + eps)
    sx = scale[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    T = torch.stack([sx, zeros, -sx * mx, zeros, sx, -sx * my,
                     zeros, zeros, ones], dim=-1).reshape(*sx.shape, 3, 3)
    return (points - mean) * scale[..., None], T


def gauss_jordan_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix inverse by unrolled Gauss-Jordan without
    pivoting (for ridge-regularized PSD systems)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)
    for k in range(n):
        pivot_row = A[..., k:k + 1, :] / A[..., k:k + 1, k:k + 1]
        A = A - A[..., :, k:k + 1] * pivot_row
        A[..., k, :] = pivot_row[..., 0, :]
    return A[..., :, n:]


def smallest_eigvec_power(M: torch.Tensor, iters: int = 4,
                          ridge: float = 1e-6) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric PSD
    (..., k, k), by inverse iteration from a fixed start."""
    k = M.shape[-1]
    eye = torch.eye(k, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eps = ridge * tr / k + 1e-30
    Minv = gauss_jordan_inverse(M + eps * eye)

    def normalize(x):
        return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-20)

    v = normalize(torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
                  + 0.01 * torch.arange(k, dtype=M.dtype, device=M.device))
    for _ in range(iters):
        v = normalize((Minv @ v[..., None])[..., 0])
    return v


def run_8point(points1: torch.Tensor, points2: torch.Tensor,
               weights: Optional[torch.Tensor] = None, impl: str = "eigh",
               rank2_project: bool = True) -> torch.Tensor:
    """Weighted normalized 8-point DLT -> unit-Frobenius F (..., 3, 3)."""
    p1n, T1 = normalize_points(points1, weights)
    p2n, T2 = normalize_points(points2, weights)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    X = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    Xw = X if weights is None else X * weights[..., None]
    XtX = Xw.transpose(-1, -2) @ X
    if impl == "power":
        f = smallest_eigvec_power(XtX)
    else:
        f = torch.linalg.eigh(XtX)[1][..., :, 0]  # ascending eigenvalues
    F = f.reshape(*f.shape[:-1], 3, 3)
    if rank2_project:
        U, S, Vh = torch.linalg.svd(F)
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
        F = (U * S[..., None, :]) @ Vh
    F = T2.transpose(-1, -2) @ F @ T1
    return F / (_fro(F) + _EPS)


def run_8point_essential(points1: torch.Tensor, points2: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         impl: str = "eigh") -> torch.Tensor:
    """8-point on normalized camera coords -> essential matrix.

    'eigh' projects onto singular values (1, 1, 0); 'power' leaves the
    matrix near-essential, scaled to ||E||_F = sqrt(2)."""
    if impl == "power":
        F = run_8point(points1, points2, weights, impl="power",
                       rank2_project=False)
        return F * 2.0 ** 0.5
    F = run_8point(points1, points2, weights)
    U, _, Vh = torch.linalg.svd(F)
    return (U * device_table(_essential_sv, device=F.device, dtype=F.dtype)) @ Vh


def _essential_sv() -> np.ndarray:
    """An essential matrix's singular values."""
    return np.array([1.0, 1.0, 0.0], np.float32)


def fast_decompose_essential(E: torch.Tensor):
    """SVD-free decomposition by the adjugate identity:
    R1 = adj(E)^T - [t]_x E, R2 = adj(E)^T + [t]_x E, t the unit null
    vector of E E^T (inverse iteration). Rotations are re-orthonormalized
    through the 6D map. Returns (R1, R2, t)."""
    En = E * (2.0 ** 0.5 / (_fro(E) + _EPS))
    t = smallest_eigvec_power(En @ En.transpose(-1, -2), iters=3)
    a = En
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adjT = torch.stack([c00, c01, c02, c10, c11, c12, c20, c21, c22],
                       dim=-1).reshape(*a.shape[:-2], 3, 3)
    TxE = cross_product_matrix(t) @ En

    def orthonormalize(R):
        return rotation_6d_to_matrix(matrix_to_rotation_6d(R))

    return orthonormalize(adjT - TxE), orthonormalize(adjT + TxE), t


def fast_motion_from_essential(E: torch.Tensor):
    """The four candidate motions [R1,+t], [R1,-t], [R2,+t], [R2,-t]:
    Rs (..., 4, 3, 3), ts (..., 4, 3)."""
    R1, R2, t = fast_decompose_essential(E)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def two_view_depths(R, t, x1, x2, eps: float = 1e-12):
    """Closed-form depths (z1, z2) of bearings x1, x2 under
    z2 x2 = z1 R x1 + t."""
    b1 = to_homogeneous(x1)
    b2 = to_homogeneous(x2)
    Rb1 = torch.einsum("...ij,...nj->...ni", R, b1)
    c2t = torch.linalg.cross(b2, t[..., None, :].expand_as(Rb1), dim=-1)
    c2R = torch.linalg.cross(b2.expand_as(Rb1), Rb1, dim=-1)
    z1 = -(c2t * c2R).sum(-1) / ((c2R * c2R).sum(-1) + eps)
    z2 = (Rb1 * z1[..., None] + t[..., None, :])[..., 2]
    return z1, z2


def cheirality_counts(Rs, ts, x1, x2, weights=None,
                      distance_thresh: float = 1e9):
    """Weighted count of points in front of both cameras per candidate.
    Rs (..., C, 3, 3), ts (..., C, 3), x1/x2 (..., N, 2) ->
    (counts (..., C), good (..., C, N))."""
    z1, z2 = two_view_depths(Rs, ts, x1[..., None, :, :], x2[..., None, :, :])
    good = (z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & (z2 < distance_thresh)
    w = torch.ones_like(z1) if weights is None else weights[..., None, :]
    return (good.to(x1.dtype) * w).sum(-1), good


def recover_pose_from_essential(E, x1, x2, weights=None,
                                distance_thresh: float = 1e9,
                                method: str = "svd"):
    """E -> best (R, t) by the cheirality vote (recoverPose) over the four
    motions of the SVD decomposition (``method='svd'``) or of the SVD-free
    one (``'fast'``). Returns R (..., 3, 3), t (..., 3), n_good (...,),
    good (..., N)."""
    if method == "fast":
        Rs, ts = fast_motion_from_essential(E)
    else:
        Rs, ts = motion_from_essential(E)
    counts, good = cheirality_counts(Rs, ts, x1, x2, weights, distance_thresh)
    best = counts.argmax(dim=-1)  # first index on ties, as jnp.argmax

    def take(a):
        idx = best.reshape(best.shape + (1,) * (a.ndim - best.ndim))
        idx = idx.expand(*best.shape, 1, *a.shape[best.ndim + 1:])
        return torch.gather(a, best.ndim, idx).squeeze(best.ndim)

    return take(Rs), take(ts), take(counts), take(good)


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """Batched two-view DLT triangulation: (..., 3, 4) projections and
    (..., N, 2) points in their frames -> (..., N, 3), the eigenvector of
    A^T A's smallest eigenvalue (``torch.linalg.eigh``, as the JAX
    package solves it)."""
    def rows(P, x):
        P = P[..., None, :, :]
        return (x[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                x[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    A = torch.stack([*rows(P1, x1), *rows(P2, x2)], dim=-2)   # (..., N, 4, 4)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Xh = V[..., :, 0]
    w = Xh[..., 3:4]
    return Xh[..., :3] / (w + torch.where(w < 0, -_EPS, _EPS))


def procrustes(A: torch.Tensor, B: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Kabsch: the rigid (R (..., 3, 3), t (..., 3)) with
    b ~= R a + t minimising sum_i w_i ||R a_i + t - b_i||^2 over (..., N, 3)
    point sets (crockwell/far: mapfree_6dreg/lib/utils/solver.py:4-37).
    ``torch.linalg.svd`` of the weighted covariance, its last singular
    direction flipped where det(V U^T) < 0, so R is never a reflection."""
    w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device) if weights is None \
        else weights
    wsum = w.sum(-1, keepdim=True) + _EPS
    ca = (A * w[..., None]).sum(-2) / wsum
    cb = (B * w[..., None]).sum(-2) / wsum
    H = torch.einsum("...ni,...nj->...ij", (A - ca[..., None, :]) * w[..., None],
                     B - cb[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    D = torch.ones(H.shape[:-2] + (3,), dtype=H.dtype, device=H.device)
    D[..., -1] = torch.linalg.det(V @ Ut)
    R = V @ (D[..., :, None] * Ut)
    return R, cb - torch.einsum("...ij,...j->...i", R, ca)
