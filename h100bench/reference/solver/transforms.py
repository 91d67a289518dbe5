# Frozen copy of far_tpu_torch/geometry/transforms.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Homogeneous-coordinate and camera-normalization helpers.

Counterpart of ``far_tpu/geometry/transforms.py``: homogeneous points,
rigid (..., 3, 4) poses and keypoint normalisation by K.
"""

from __future__ import annotations

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., N, D+1) -> (..., N, D), dividing by the last coordinate (kept
    at least ``eps`` away from 0, with its sign)."""
    denom = pts[..., -1:]
    small = torch.where(denom < 0, -eps, eps).to(pts.dtype)
    denom = torch.where(denom.abs() < eps, small, denom)
    return pts[..., :-1] / denom


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A (..., D+1, D+1) projective or (..., D, D+1) affine transform
    applied to (..., N, D) points."""
    out = torch.einsum("...ij,...nj->...ni", T, to_homogeneous(pts))
    if T.shape[-2] == pts.shape[-1]:  # affine: no divide
        return out
    return from_homogeneous(out)


def compose_pose34(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 3, 4)."""
    return torch.cat([R, t[..., None]], dim=-1)


def pose34_to_44(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4)."""
    bottom = torch.zeros(T.shape[:-2] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([T, bottom], dim=-2)


def invert_pose34(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 3, 4) pose."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return compose_pose34(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def apply_pose34(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A rigid (..., 3, 4) pose applied to (..., N, 3) points."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def normalize_kpts_by_K(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints (..., N, 2) -> normalized camera coordinates."""
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
    return (kpts - c) / f
