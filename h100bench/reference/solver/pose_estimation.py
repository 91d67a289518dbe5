# Frozen copy of far_tpu_torch/solvers/pose_estimation.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Pose estimation front end: pixel keypoints -> robust (R, t).

Counterpart of ``far_tpu/solvers/pose_estimation.py``: normalize the
keypoints by the intrinsics, choose the threshold and the prior, run one
RANSAC round, and scale t by a predicted metric translation scale when
one is given. Too few valid matches give ``success=False`` and an
identity pose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from h100bench.reference.solver.transforms import normalize_kpts_by_K
from h100bench.reference.solver.ransac import RansacConfig, prior_ransac
from h100bench.reference.solver.types import PoseEstimate, PriorParams
from h100bench.reference.solver.tables import device_table

# probe cloud size of the prior transport error (reference metrics.py:103)
_NUM_PCL = 300


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """solver: 'ransac' (pixel threshold, no prior), 'prior_ransac_noprior'
    (fixed threshold, no prior) or 'prior_ransac' (biased sampling and
    prior scoring)."""

    solver: str = "ransac"
    num_hypotheses: int = 2048
    pixel_thr: float = 0.5
    prior_inl_th: float = 3e-7
    prior_lambda: float = 0.3
    bias_sigma_sq: float = 0.1
    min_valid: int = 8
    minimal_solver: str = "8pt"
    scoring: str = "inlier"

    def ransac_config(self, use_prior: bool) -> RansacConfig:
        return RansacConfig(
            num_hypotheses=self.num_hypotheses,
            minimal_solver=self.minimal_solver,
            inl_th=self.prior_inl_th,
            prior_lambda=self.prior_lambda,
            bias_sigma_sq=self.bias_sigma_sq,
            use_prior_scoring=use_prior,
            use_biased_sampling=use_prior,
            min_valid=self.min_valid,
            scoring=self.scoring,
        )


def default_prior_pcl(device=None, dtype=torch.float32) -> torch.Tensor:
    """The port's fixed probe cloud: 300 points uniform in [-3, 3]^3 from
    a CPU generator seeded 0, made once per (device, dtype) and shared by
    every caller, who must not change it. (The JAX package draws its own
    from ``jax.random.PRNGKey(0)``; the two clouds differ, so a comparison
    hands one cloud to both.)"""
    return device_table(_probe_cloud, device=device if device is not None else "cpu",
                        dtype=dtype)


def _probe_cloud() -> np.ndarray:
    g = torch.Generator().manual_seed(0)
    return (torch.rand((_NUM_PCL, 3), generator=g, dtype=torch.float32) * 6 - 3).numpy()


def estimate_pose(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    valid: torch.Tensor,
    prior_rt: Optional[torch.Tensor] = None,
    translation_scale: Optional[torch.Tensor] = None,
    cfg: SolverConfig = SolverConfig(),
    prior_pcl: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    quant=None,
) -> PoseEstimate:
    """Robust essential-matrix pose estimation, batched over pairs.

    Args:
        kpts0/kpts1: (B, N, 2) pixel correspondences; K0/K1: (B, 3, 3).
        valid: (B, N) bool mask; prior_rt: (B, 3, 4) pose prior.
        translation_scale: (B,) optional metric scale multiplier of t.
        prior_pcl: (P, 3) probe cloud (default: ``default_prior_pcl``).
        uniforms / generator: the sampler's draws (see ``prior_ransac``).
    """
    kp0n = normalize_kpts_by_K(kpts0, K0)
    kp1n = normalize_kpts_by_K(kpts1, K1)
    if quant is not None:  # the benchmark's control: the solver's inputs rounded
        kp0n, kp1n = quant(kp0n), quant(kp1n)
    use_prior = prior_rt is not None and cfg.solver == "prior_ransac"
    prior = None
    if use_prior:
        pcl = default_prior_pcl(kp0n.device, kp0n.dtype) if prior_pcl is None \
            else prior_pcl.to(device=kp0n.device, dtype=kp0n.dtype)
        prior = PriorParams(rt=prior_rt, pcl=pcl)
    inl_th = None
    if cfg.solver == "ransac":  # pixel threshold -> normalized, per pair
        f = torch.stack([K0[..., 0, 0], K1[..., 1, 1], K0[..., 0, 0],
                         K1[..., 1, 1]], -1).mean(-1)
        inl_th = (cfg.pixel_thr / f) ** 2
    est = prior_ransac(kp0n, kp1n, valid, prior, cfg.ransac_config(use_prior),
                       inl_th=inl_th, uniforms=uniforms, generator=generator)
    if translation_scale is None:
        return est
    return dataclasses.replace(est, t=est.t * translation_scale[..., None])
