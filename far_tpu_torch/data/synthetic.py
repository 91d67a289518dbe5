"""Procedural image pairs with exact ground-truth pose and depth.

The port's own numpy copy of ``far_tpu/data/datasets.py:
SyntheticPairDataset``: the same draws from the same seeds, so both
packages see the same pairs (a test holds the arrays equal). A textured
surface with smooth depth relief is splatted into two views; the relief
keeps essential-matrix estimation away from the planar degeneracy. A
sample also names its scene, its pair (``pair_names``, which validation
joins into the pair's identifier) and its dataset. ``collate`` stacks
samples into a ``PairBatch`` on a device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from far_tpu_torch.data.loader import collate_pairs, to_device
from far_tpu_torch.types import PairBatch


class SyntheticPairDataset:
    """``n`` pairs of ``hw`` grayscale images over ``n_scenes`` textures,
    rotations up to ``max_angle_deg``."""

    def __init__(self, n: int = 32, hw: Tuple[int, int] = (480, 640),
                 seed: int = 0, max_angle_deg: float = 20.0,
                 n_scenes: int = 4):
        self.n = n
        self.hw = hw
        self.seed = seed
        self.max_angle = np.radians(max_angle_deg)
        self.n_scenes = n_scenes
        H, W = hw
        f = 0.8 * max(H, W)
        self.K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                          np.float32)

    def __len__(self):
        return self.n

    def _texture(self, rng):
        tex = rng.uniform(0.1, 1.0, size=(8, 8))
        for _ in range(3):
            up = np.kron(tex, np.ones((2, 2)))
            up += rng.uniform(-0.1, 0.1, up.shape)
            tex = np.clip(up, 0, 1)
        return tex

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng(self.seed + idx % self.n_scenes)
        prng = np.random.default_rng(self.seed * 7919 + idx)
        H, W = self.hw
        K = self.K
        tex = self._texture(rng)
        th, tw = tex.shape

        # plane at depth z0, rotation about a random axis, small translation
        z0 = prng.uniform(3.0, 5.0)
        ax = prng.uniform(-1, 1, 3)
        ax /= np.linalg.norm(ax)
        ang = prng.uniform(0.2, 1.0) * self.max_angle
        cx, sx = np.cos(ang), np.sin(ang)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                       [-ax[1], ax[0], 0]])
        R = np.eye(3) + sx * Kx + (1 - cx) * (Kx @ Kx)
        t = prng.uniform(-0.3, 0.3, 3)
        t[2] = abs(t[2]) * 0.3

        # surface points on a grid with depth relief, splatted to the
        # nearest pixel of each view
        gy, gx = np.mgrid[0:th, 0:tw]
        relief = rng.normal(size=(8, 8))
        relief = np.kron(relief, np.ones((th // 8, tw // 8)))[:th, :tw]
        Xw = np.stack([
            (gx / (tw - 1) - 0.5) * 6.0,
            (gy / (th - 1) - 0.5) * 6.0,
            z0 + relief * 0.8,
        ], -1).reshape(-1, 3)
        vals = tex.reshape(-1)

        def splat(Rv, tv):
            P = Xw @ Rv.T + tv
            uv = (P[:, :2] / P[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            img = np.zeros((H, W), np.float32)
            dep = np.zeros((H, W), np.float32)
            ij = np.round(uv).astype(int)
            ok = (ij[:, 0] >= 0) & (ij[:, 0] < W) & (ij[:, 1] >= 0) & (ij[:, 1] < H)
            img[ij[ok, 1], ij[ok, 0]] = vals[ok]
            dep[ij[ok, 1], ij[ok, 0]] = P[ok, 2]
            return img[..., None], dep

        img0, depth0 = splat(np.eye(3), np.zeros(3))
        img1, depth1 = splat(R, t)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return {"image0": img0, "image1": img1, "depth0": depth0,
                "depth1": depth1, "K0": K, "K1": K, "T_0to1": T,
                "T_1to0": np.linalg.inv(T).astype(np.float32),
                "scene": f"synthetic_{idx % self.n_scenes}",
                "pair_id": np.asarray(idx, np.int64),
                "pair_names": (f"syn_{idx}_0", f"syn_{idx}_1"),
                "dataset_name": "synthetic"}


def collate(samples: Sequence[Dict], device=None) -> Tuple[PairBatch, torch.Tensor]:
    """(PairBatch, T_0to1 (B, 4, 4)) on ``device``: ``collate_pairs``'s
    batch (images, intrinsics, both poses and depths, pair ids) moved
    there."""
    batch = to_device(collate_pairs(list(samples)), device)
    return batch, batch.T_0to1
