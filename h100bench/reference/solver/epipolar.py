# Frozen copy of far_tpu_torch/geometry/epipolar.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Essential-matrix algebra and epipolar residuals.

Counterpart of ``far_tpu/geometry/epipolar.py``. The residuals are written as broadcast arithmetic, so (B, H, N)
hypothesis x point grids never build (B, H, N, 3) intermediates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from h100bench.reference.solver.tables import device_table


def cross_product_matrix(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric [v]_x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def essential_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for the relative motion x2 ~ R x1 + t."""
    return cross_product_matrix(t) @ R


def essential_from_pose34(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) relative pose -> E = [t]_x R."""
    return essential_from_Rt(T[..., :3, :3], T[..., :3, 3])


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    """F = K2^-T E K1^-1 (Hartley/Zisserman 9.12)."""
    return torch.linalg.inv(K2).transpose(-1, -2) @ E @ torch.linalg.inv(K1)


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1."""
    return K2.transpose(-1, -2) @ F @ K1


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


def _w_table() -> np.ndarray:
    """Hartley and Zisserman's W (result 9.18)."""
    return np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def decompose_essential_matrix(
        E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD decomposition E = U diag(1, 1, 0) V^T into R1 = U W V^T,
    R2 = U W^T V^T and t = u3, with U and V^T sign-fixed to proper
    rotations. E (..., 3, 3) -> (R1, R2, t)."""
    U, _, Vh = torch.linalg.svd(E)
    one = torch.ones(E.shape[:-2] + (2,), dtype=E.dtype, device=E.device)

    def flip(M):  # -1 on the last singular vector where det(M) < 0
        sign = torch.where(torch.linalg.det(M) < 0.0, -1.0, 1.0).to(E.dtype)
        return torch.cat([one, sign[..., None]], dim=-1)

    U = U * flip(U)[..., None, :]
    Vh = Vh * flip(Vh)[..., :, None]
    W = device_table(_w_table, device=E.device, dtype=E.dtype)
    return U @ W @ Vh, U @ W.t() @ Vh, U[..., :, -1]


def motion_from_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four candidate motions [R1,+t], [R1,-t], [R2,+t], [R2,-t] of the
    SVD decomposition: Rs (..., 4, 3, 3), ts (..., 4, 3)."""
    R1, R2, t = decompose_essential_matrix(E)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))
