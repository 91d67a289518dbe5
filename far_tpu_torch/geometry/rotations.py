"""Ortho-6D rotation representation.

Counterpart of the 6D functions of ``far_tpu/geometry/rotations.py``: the
row convention (``rotation_6d_to_matrix``: mp3d, map-free 6DReg) and
RotationContinuity's column convention (``ortho6d_to_matrix_rc``:
ViTEss's decode).
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
