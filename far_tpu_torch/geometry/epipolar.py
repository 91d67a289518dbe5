"""Essential-matrix algebra and epipolar residuals.

Counterpart of the parts of ``far_tpu/geometry/epipolar.py`` the
8-point RANSAC path uses. The residuals are written as broadcast
arithmetic, so (B, H, N) hypothesis x point grids never build (B, H, N,
3) intermediates.
"""

from __future__ import annotations

import torch


def cross_product_matrix(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric [v]_x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def essential_from_pose34(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) relative pose -> E = [t]_x R."""
    return cross_product_matrix(T[..., :3, 3]) @ T[..., :3, :3]


def _epipolar_terms(pts1, pts2, Fm):
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    F = Fm[..., None]  # broadcast over the point axis
    a = F[..., 0, 0, :] * x1 + F[..., 0, 1, :] * y1 + F[..., 0, 2, :]
    b = F[..., 1, 0, :] * x1 + F[..., 1, 1, :] * y1 + F[..., 1, 2, :]
    c = F[..., 2, 0, :] * x1 + F[..., 2, 1, :] * y1 + F[..., 2, 2, :]
    num = x2 * a + y2 * b + c
    d = F[..., 0, 0, :] * x2 + F[..., 1, 0, :] * y2 + F[..., 2, 0, :]
    e = F[..., 0, 1, :] * x2 + F[..., 1, 1, :] * y2 + F[..., 2, 1, :]
    return num, a, b, d, e


def sampson_epipolar_distance(pts1, pts2, Fm, eps: float = 1e-8):
    """Squared Sampson distance; pts (..., N, 2), Fm (..., 3, 3)."""
    num, a, b, d, e = _epipolar_terms(pts1, pts2, Fm)
    return num ** 2 / (a ** 2 + b ** 2 + d ** 2 + e ** 2 + eps)


def symmetrical_epipolar_distance(pts1, pts2, Fm, eps: float = 1e-8):
    """Squared symmetric epipolar distance."""
    num, a, b, d, e = _epipolar_terms(pts1, pts2, Fm)
    inv = 1.0 / (a ** 2 + b ** 2 + eps) + 1.0 / (d ** 2 + e ** 2 + eps)
    return num ** 2 * inv
