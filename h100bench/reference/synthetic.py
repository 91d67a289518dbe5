"""Synthetic image pairs with a known relative pose, made on the device.

The arithmetic of the program's ``SyntheticPairDataset`` (a textured
surface with depth relief, seen from a second camera rotated about a
random axis and moved a little, each surface point splatted to its
nearest pixel), written in torch for a batch of pairs at once and drawn
from one ``torch.Generator``: every pair has its own texture, relief and
pose. Where two points land on one pixel the brighter wins, so the same
seed gives the same images.
"""

from __future__ import annotations

import math

import torch


def make_pairs(n: int, hw, generator: torch.Generator, device,
               max_angle_deg: float = 20.0, channels: int = 1, extra_hw=None):
    """n pairs -> (image0, image1 (n, H, W, channels) float32 in [0, 1],
    K (n, 3, 3)); with ``extra_hw`` the same scenes seen a second time at
    that size, appended as (image0, image1, K) of their own. Each channel
    has a texture of its own."""
    g = generator

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    tex = 0.1 + 0.9 * rand(n, 8, 8, channels)
    for _ in range(3):
        up = tex.repeat_interleave(2, 1).repeat_interleave(2, 2)
        tex = (up + (rand(*up.shape) * 0.2 - 0.1)).clamp(0.0, 1.0)
    th, tw = tex.shape[1:3]
    relief = torch.randn((n, 8, 8), generator=g, device=device)
    relief = relief.repeat_interleave(th // 8, 1).repeat_interleave(tw // 8, 2)
    z0 = 3.0 + 2.0 * rand(n)
    ax = rand(n, 3) * 2 - 1
    ax = ax / ax.norm(dim=-1, keepdim=True)
    ang = (0.2 + 0.8 * rand(n)) * math.radians(max_angle_deg)
    t = rand(n, 3) * 0.6 - 0.3
    t[:, 2] = t[:, 2].abs() * 0.3
    zero = torch.zeros(n, device=device)
    Kx = torch.stack([zero, -ax[:, 2], ax[:, 1], ax[:, 2], zero, -ax[:, 0],
                      -ax[:, 1], ax[:, 0], zero], -1).reshape(n, 3, 3)
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    R = eye + torch.sin(ang)[:, None, None] * Kx \
        + (1 - torch.cos(ang))[:, None, None] * (Kx @ Kx)

    gy, gx = torch.meshgrid(torch.arange(th, device=device, dtype=torch.float32),
                            torch.arange(tw, device=device, dtype=torch.float32),
                            indexing="ij")
    X = torch.stack([(gx / (tw - 1) - 0.5).expand(n, th, tw) * 6.0,
                     (gy / (th - 1) - 0.5).expand(n, th, tw) * 6.0,
                     z0[:, None, None] + relief * 0.8], -1).reshape(n, -1, 3)
    vals = tex.reshape(n, -1, channels)

    def view(H, W):
        f = 0.8 * max(H, W)
        K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device=device)

        def splat(Rv, tv):
            P = X @ Rv.transpose(1, 2) + tv[:, None, :]
            u = torch.round(P[..., 0] / P[..., 2] * f + W / 2).long()
            v = torch.round(P[..., 1] / P[..., 2] * f + H / 2).long()
            ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
            flat = torch.where(ok, v * W + u, H * W)  # off-image points to a spare slot
            flat = flat + torch.arange(n, device=device)[:, None] * (H * W + 1)
            img = torch.zeros(n * (H * W + 1), channels, device=device)
            img.scatter_reduce_(0, flat.reshape(-1, 1).expand(-1, channels),
                                vals.reshape(-1, channels), "amax")
            return img.reshape(n, H * W + 1, channels)[:, :-1].reshape(n, H, W, channels)

        return (splat(eye, torch.zeros(n, 3, device=device)), splat(R, t),
                K.expand(n, 3, 3).contiguous())

    out = view(*hw)
    return out if extra_hw is None else out + view(*extra_hw)
