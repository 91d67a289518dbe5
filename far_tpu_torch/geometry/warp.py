"""Depth-based keypoint warping for coarse supervision.

Counterpart of ``far_tpu/geometry/warp.py`` (``warp_kpts``): unproject
with depth and K, move rigidly, reproject, and test covisibility and
depth consistency. Rounding follows the JAX package: ``torch.round``
rounds half to even as ``jnp.round`` does, and ``.to(torch.int32)``
truncates toward zero as ``.astype(jnp.int32)`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _gather_depth(depth: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel depth of integer (B, L, 2) <x, y>; 0 outside the image."""
    H, W = depth.shape[-2:]
    x = xy[..., 0].clamp(0, W - 1)
    y = xy[..., 1].clamp(0, H - 1)
    out = torch.gather(depth.reshape(depth.shape[0], -1), 1, (y * W + x).long())
    inb = (xy[..., 0] >= 0) & (xy[..., 0] < W) & (xy[..., 1] >= 0) & (xy[..., 1] < H)
    return torch.where(inb, out, torch.zeros_like(out))


def warp_kpts(kpts0: torch.Tensor, depth0: torch.Tensor, depth1: torch.Tensor,
              T_0to1: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor,
              consistency_rel_err: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp (B, L, 2) <x, y> pixels of image 0 into image 1.

    Args:
        depth0/depth1: (B, H, W); T_0to1: (B, 3, 4) or (B, 4, 4); K0/K1 (B, 3, 3).
    Returns:
        valid (B, L) bool (covisible, nonzero depth, consistent depth) and
        the warped points (B, L, 2) in image 1.
    """
    kpts0_depth = _gather_depth(depth0, torch.round(kpts0).to(torch.int32))
    nonzero = kpts0_depth != 0
    kpts0_h = torch.cat([kpts0, torch.ones_like(kpts0[..., :1])], dim=-1) \
        * kpts0_depth[..., None]
    kpts0_cam = torch.einsum("bij,blj->bli", torch.linalg.inv(K0), kpts0_h)
    R, t = T_0to1[:, :3, :3], T_0to1[:, :3, 3]
    w_cam = torch.einsum("bij,blj->bli", R, kpts0_cam) + t[:, None, :]
    w_depth_computed = w_cam[..., 2]
    w_h = torch.einsum("bij,blj->bli", K1, w_cam)
    w_kpts0 = w_h[..., :2] / (w_h[..., 2:] + 1e-4)

    h, w = depth1.shape[-2:]
    covisible = (w_kpts0[..., 0] > 0) & (w_kpts0[..., 0] < w - 1) \
        & (w_kpts0[..., 1] > 0) & (w_kpts0[..., 1] < h - 1)
    w_long = torch.where(covisible[..., None], w_kpts0,
                         torch.zeros_like(w_kpts0)).to(torch.int32)
    w_depth = _gather_depth(depth1, w_long)
    consistent = ((w_depth - w_depth_computed) / (w_depth + 1e-8)).abs() \
        < consistency_rel_err
    return nonzero & covisible & consistent, w_kpts0
