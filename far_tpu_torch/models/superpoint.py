"""SuperPoint-style keypoint detector and descriptor.

Counterpart of ``far_tpu/models/superpoint.py`` (``SuperPointConfig``,
``simple_nms``, ``SuperPointTPU`` as ``SuperPoint``, ``_bilinear_sample``):
a VGG-style encoder at 1/8, a 65-way cell detector head (64 positions of
the 8x8 cell and a dustbin) and a descriptor head; the 4-pixel border is
cleared and the keypoints are a fixed top-K over H*W with a validity
mask, so every shape is static. Module names are magicleap's
``superpoint_v1.pth`` ones (``conv1a`` ... ``convDb``), so that
checkpoint loads with ``strict=True``. Images and keypoints keep the JAX
package's layout at the public functions: (B, H, W, 1) in, <x, y> pixels
out. Plain torch: no kernel.

Three steps follow magicleap's published SuperPoint
(SuperGluePretrainedNetwork/models/superpoint.py) where the JAX package
departs from it:

- ``simple_nms``: the max-pool equality, then two suppression passes
  (the JAX package keeps the equality alone);
- the dense descriptor map is L2-normalised over channels before it is
  sampled, and again after (the JAX package normalises after only);
- ``sample_descriptors``: a keypoint at pixel x is read at
  (x - s/2 + 0.5) / (w s - s/2 - 0.5) of the map's ``align_corners``
  span, s = 8 (the JAX package reads it at x / 8).
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
    """magicleap's ``simple_nms`` on (B, H, W) scores: kept where they
    equal their (2r+1)^2 window's max (the pool pads with -inf); then,
    twice, the scores away from every kept one (``supp``: within r of
    none) that equal their window's max among those scores are kept too;
    the others are 0."""
    def pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    keep = scores == pool(scores)
    for _ in range(2):
        supp = pool(keep.float()) > 0
        left = torch.where(supp, zeros, scores)
        keep = keep | ((left == pool(left)) & ~supp)
    return torch.where(keep, scores, zeros)


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


def sample_descriptors(fmap: torch.Tensor, kpts: torch.Tensor, s: int = 8) -> torch.Tensor:
    """magicleap's ``sample_descriptors``: (B, h, w, C) read at keypoints
    <x, y> pixels (B, K, 2) of an image s times the map's size, each at
    (x - s/2 + 0.5) / (w s - s/2 - 0.5) of the map's span from its first
    to its last column (``grid_sample(align_corners=True)``; rows alike),
    bilinearly, then L2-normalised. Every keypoint outside the 4-pixel
    border reads inside the map; a padded slot outside it reads the
    clipped map where ``grid_sample`` reads zeros."""
    _, h, w, _ = fmap.shape
    x = (kpts[..., 0] - s / 2 + 0.5) / (w * s - s / 2 - 0.5) * (w - 1)
    y = (kpts[..., 1] - s / 2 + 0.5) / (h * s - s / 2 - 0.5) * (h - 1)
    return F.normalize(_bilinear_sample(fmap, torch.stack([x, y], -1)), dim=-1)


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

        desc = F.normalize(conv(F.relu(conv(x, self.convDa)), self.convDb).float(), dim=1)
        return kpts, scores, valid, sample_descriptors(desc.permute(0, 2, 3, 1), kpts)
