"""SuperPoint-style keypoint detector and descriptor.

Counterpart of ``far_tpu/models/superpoint.py`` (``SuperPointConfig``,
``simple_nms``, ``SuperPointTPU`` as ``SuperPoint``, ``_bilinear_sample``):
a VGG-style encoder at 1/8, a 65-way cell detector head (64 positions of
the 8x8 cell and a dustbin) and a descriptor head; NMS is one max-pool
equality, the 4-pixel border is cleared and the keypoints are a fixed
top-K over H*W with a validity mask, so every shape is static. Module
names are magicleap's ``superpoint_v1.pth`` ones (``conv1a`` ...
``convDb``), so that checkpoint loads with ``strict=True``. Images and
keypoints keep the JAX package's layout at the public functions: (B, H,
W, 1) in, <x, y> pixels out. Plain torch: no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.models.backbone import conv
from far_tpu_torch.models.matching import topk_stable

BORDER = 4  # pixels SuperPoint clears at the image border


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    channels: Tuple[int, ...] = (64, 64, 128, 128)
    desc_dim: int = 256
    nms_radius: int = 4
    keypoint_threshold: float = 0.005
    max_keypoints: int = 1024
    dtype: str = "float32"


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W) scores kept where they equal their (2r+1)^2 window's max
    (the pool pads with -inf), else 0."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(scores[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def _bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) sampled at float <x, y> (B, K, 2): clipped into the
    map, then the four corners gathered and weighted."""
    B, h, w, C = fmap.shape
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = fmap.reshape(B, h * w, C)

    def g(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, C))

    return (g(y0, x0) * (1 - wx) * (1 - wy) + g(y0, x1) * wx * (1 - wy)
            + g(y1, x0) * (1 - wx) * wy + g(y1, x1) * wx * wy)


_ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")
_POOL_AFTER = ("conv1b", "conv2b", "conv3b")


class SuperPoint(nn.Module):
    """Counterpart of ``SuperPointTPU``."""

    def __init__(self, cfg: SuperPointConfig):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3, c4 = cfg.channels
        widths = (c1, c1, c2, c2, c3, c3, c4, c4)
        cin = 1
        for name, cout in zip(_ENCODER, widths):
            self.add_module(name, nn.Conv2d(cin, cout, 3, 1, 1))
            cin = cout
        self.convPa = nn.Conv2d(c4, 256, 3, 1, 1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(c4, 256, 3, 1, 1)
        self.convDb = nn.Conv2d(256, cfg.desc_dim, 1)

    def forward(self, image: torch.Tensor):
        """image (B, H, W, 1) gray in [0, 1], H and W divisible by 8 ->
        kpts (B, K, 2) <x, y> pixels, scores (B, K), valid (B, K), desc
        (B, K, D) L2-normalised."""
        cfg = self.cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        B, H, W, _ = image.shape
        x = image.permute(0, 3, 1, 2).to(dt)
        for name in _ENCODER:
            x = F.relu(conv(x, getattr(self, name)))
            if name in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)

        det = conv(F.relu(conv(x, self.convPa)), self.convPb)
        prob = torch.softmax(det.float(), dim=1)[:, :64]          # drop the dustbin
        hc, wc = H // 8, W // 8
        # channel a*8 + b of cell (i, j) is pixel (8i + a, 8j + b)
        heat = prob.reshape(B, 8, 8, hc, wc).permute(0, 3, 1, 4, 2).reshape(B, H, W)
        heat = simple_nms(heat, cfg.nms_radius)
        border = torch.zeros(H, W, device=heat.device)
        border[BORDER:H - BORDER, BORDER:W - BORDER] = 1.0
        heat = heat * border

        scores, idx = topk_stable(heat.reshape(B, H * W), cfg.max_keypoints)
        kpts = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()], -1)
        valid = scores > cfg.keypoint_threshold

        desc = conv(F.relu(conv(x, self.convDa)), self.convDb).float()
        d = _bilinear_sample(desc.permute(0, 2, 3, 1), kpts / 8.0)
        d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-8)
        return kpts, scores, valid, d
