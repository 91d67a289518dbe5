"""Procedural image pairs with exact ground-truth pose and depth.

The port's own numpy copy of ``far_tpu/data/datasets.py:
SyntheticPairDataset``: the same draws from the same seeds, so both
packages see the same pairs (a test holds the arrays equal). A textured
surface with smooth depth relief is splatted into two views; the relief
keeps essential-matrix estimation away from the planar degeneracy. A
sample also names its scene, its pair (``pair_names``, which validation
joins into the pair's identifier) and its dataset. ``collate`` stacks
samples into a ``PairBatch`` on a device. ``GTCorrespondenceDataset``
and ``SolverPoseDataset`` are numpy copies of the JAX package's wrappers
that feed the family trainers (same per-index seeds). ``synthetic_batch``
makes a ``PairBatch`` of smooth random images at once, for requests that
need no ground truth.
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


class GTCorrespondenceDataset:
    """Correspondences from ground truth for a pair dataset with depth
    (the JAX package's ``GTCorrespondenceDataset``, the same draws from
    ``seed * 99991 + idx``): ``max_matches`` depth-valid pixels of image 0,
    projected through ``T_0to1`` into image 1, jittered by ``noise_pix``,
    a share ``outlier_pct`` replaced by uniform points of image 1. Adds
    ``correspondences`` (N, 2, 2), ``corr_valid`` (N,) and
    ``num_correspondences`` to each sample and keeps its images."""

    def __init__(self, base_dataset, max_matches: int = 512,
                 noise_pix: float = 1.0, outlier_pct: float = 0.1,
                 seed: int = 0):
        self.base = base_dataset
        self.max_matches = max_matches
        self.noise_pix = noise_pix
        self.outlier_pct = outlier_pct
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict:
        s = dict(self.base[idx])
        rng = np.random.default_rng(self.seed * 99991 + idx)
        depth0 = np.asarray(s["depth0"], np.float64)
        K0 = np.asarray(s["K0"], np.float64)
        K1 = np.asarray(s["K1"], np.float64)
        T = np.asarray(s["T_0to1"], np.float64)
        H, W = depth0.shape
        ys, xs = np.nonzero(depth0 > 0)
        n = self.max_matches
        corr = np.zeros((n, 2, 2), np.float32)
        valid = np.zeros(n, bool)
        if len(xs) > 0:
            pick = rng.integers(0, len(xs), size=n)
            u, v = xs[pick].astype(np.float64), ys[pick].astype(np.float64)
            z = depth0[ys[pick], xs[pick]]
            X = np.stack([(u - K0[0, 2]) / K0[0, 0] * z,
                          (v - K0[1, 2]) / K0[1, 1] * z, z], -1)
            X1 = X @ T[:3, :3].T + T[:3, 3]
            ok = X1[:, 2] > 1e-3
            u1 = X1[:, 0] / np.maximum(X1[:, 2], 1e-3) * K1[0, 0] + K1[0, 2]
            v1 = X1[:, 1] / np.maximum(X1[:, 2], 1e-3) * K1[1, 1] + K1[1, 2]
            ok &= (u1 >= 0) & (u1 < W) & (v1 >= 0) & (v1 < H)
            p0 = np.stack([u, v], -1) + rng.normal(0, self.noise_pix, (n, 2))
            p1 = np.stack([u1, v1], -1) + rng.normal(0, self.noise_pix, (n, 2))
            out = rng.uniform(size=n) < self.outlier_pct
            p1[out] = rng.uniform([0, 0], [W, H], size=(out.sum(), 2))
            corr = np.stack([p0, p1], axis=1).astype(np.float32)
            valid = ok
        s["correspondences"] = corr
        s["corr_valid"] = valid
        s["num_correspondences"] = np.asarray(valid.sum(), np.float32)
        return s


class SolverPoseDataset:
    """A solver pose for each pair, the input of LoFTR-gated ViTEss (the
    JAX package's ``SolverPoseDataset``): from ``pose_npz`` (arrays 'rt'
    (N, 3, 4) and 'num_corr' (N,) in pair order), or else the ground
    truth rotated by a normal angle of ``rot_noise_deg`` about a random
    axis, its translation jittered by ``trans_noise`` and made unit, and
    a count in [50, 500), drawn from ``seed * 77003 + idx``."""

    def __init__(self, base_dataset, pose_npz=None,
                 rot_noise_deg: float = 5.0, trans_noise: float = 0.1,
                 seed: int = 0):
        self.base = base_dataset
        self.poses = None
        if pose_npz is not None:
            z = np.load(pose_npz)
            self.poses = (np.asarray(z["rt"], np.float32),
                          np.asarray(z["num_corr"], np.float32))
        self.rot_noise = np.radians(rot_noise_deg)
        self.trans_noise = trans_noise
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict:
        s = dict(self.base[idx])
        if self.poses is not None:
            s["solver_rt"] = self.poses[0][idx]
            s["num_correspondences"] = self.poses[1][idx]
            return s
        rng = np.random.default_rng(self.seed * 77003 + idx)
        T = np.asarray(s["T_0to1"], np.float64)
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        ang = rng.normal(0, self.rot_noise)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                       [-ax[1], ax[0], 0]])
        dR = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
        rt = np.zeros((3, 4), np.float32)
        rt[:, :3] = dR @ T[:3, :3]
        t = T[:3, 3] + rng.normal(0, self.trans_noise, 3)
        n = np.linalg.norm(t)
        rt[:, 3] = t / n if n > 1e-8 else np.array([0, 0, 1.0])
        s["solver_rt"] = rt
        s["num_correspondences"] = np.asarray(rng.integers(50, 500), np.float32)
        return s


def collate(samples: Sequence[Dict], device=None) -> Tuple[PairBatch, torch.Tensor]:
    """(PairBatch, T_0to1 (B, 4, 4)) on ``device``: ``collate_pairs``'s
    batch (images, intrinsics, both poses and depths, pair ids) moved
    there."""
    batch = to_device(collate_pairs(list(samples)), device)
    return batch, batch.T_0to1


def synthetic_batch(B: int, H: int, W: int, device, seed: int = 0) -> PairBatch:
    """Smooth random images, image 1 a shifted crop of image 0, with
    intrinsics of focal length 517.97 px centred in the image."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(B, 1, H // 8 + 2, W // 8 + 2, generator=g)
    img = torch.nn.functional.interpolate(low, size=(H + 16, W + 32),
                                          mode="bilinear", align_corners=True)
    K = torch.tensor([[517.97, 0.0, W / 2.0], [0.0, 517.97, H / 2.0],
                      [0.0, 0.0, 1.0]]).expand(B, 3, 3).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous().to(device)
    return PairBatch(image0=nhwc(img[:, :, :H, :W]), image1=nhwc(img[:, :, 16:, 32:]),
                     K0=K.to(device), K1=K.to(device))
