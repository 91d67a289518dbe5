# Frozen copy of far_tpu_torch/geometry/rotations.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Rotation representations: ortho-6D, quaternions, angles, SO(3) projection.

Counterpart of ``far_tpu/geometry/rotations.py``: the 6D row convention
(``rotation_6d_to_matrix``: mp3d, map-free 6DReg) and RotationContinuity's
column convention (``ortho6d_to_matrix_rc``: ViTEss's decode); quaternions
both ways, rotation angles and geodesics (the map-free losses), and the
SVD projection onto SO(3) (the DLT-PnP solver).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; the frame is the rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """First two rows of R flattened -> (..., 6)."""
    return R[..., :2, :].reshape(*R.shape[:-2], 6)


def ortho6d_to_matrix_rc(d6: torch.Tensor) -> torch.Tensor:
    """RotationContinuity's ``compute_rotation_matrix_from_ortho6d``:
    x = n(a1), z = n(x x a2), y = z x x, stacked as the COLUMNS."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    x = _normalize(a1)
    z = _normalize(torch.linalg.cross(x, a2, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (normalised first) -> (..., 3, 3)."""
    q = _normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0.

    Shepperd's selection without branches, as the JAX package computes
    it: all four candidates, the one of the largest pivot (the first on a
    tie), the sign flipped where w < 0, normalised."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    s = torch.sqrt(pivots.clamp(min=_EPS)) * 2.0
    s0, s1, s2, s3 = s.unbind(-1)
    cands = torch.stack([
        torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1),
        torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1),
        torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1),
        torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1),
    ], dim=-2)                                             # (..., 4, 4)
    idx = pivots.argmax(dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return _normalize(q)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Angle (radians) of a rotation matrix, batched."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0))


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations (radians), batched."""
    return rotation_angle(R1 @ R2.transpose(-1, -2))


def so3_project(M: torch.Tensor) -> torch.Tensor:
    """The rotation closest to a 3x3 matrix: U diag(1, 1, det(U V^T)) V^T."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    S = torch.cat([torch.ones_like(U[..., 0, :2]), det[..., None]], dim=-1)
    return (U * S[..., None, :]) @ Vh
