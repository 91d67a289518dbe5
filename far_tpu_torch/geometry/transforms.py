"""Homogeneous-coordinate and camera-normalization helpers.

Counterpart of the parts of ``far_tpu/geometry/transforms.py`` the
inference path uses.
"""

from __future__ import annotations

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_kpts_by_K(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints (..., N, 2) -> normalized camera coordinates."""
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
    return (kpts - c) / f
