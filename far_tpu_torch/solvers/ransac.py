"""Batched prior-biased RANSAC.

Counterpart of ``far_tpu/solvers/ransac.py:prior_ransac``: weighted
inverse-CDF sampling (biased by a pose prior when one is given), minimal
solves (Nister 5-point, up to 20 candidates a sample, or the 8-point
DLT), verification of every hypothesis against every point, inlier or
MAGSAC-style scoring, prior transport scoring, an optional weighted
least-squares polish over the winning inliers, and the recoverPose
cheirality vote.

The sampler's uniforms come from a ``torch.Generator`` or are handed in
(``uniforms``), so a test can give the port the JAX sampler's draws and
compare hypotheses one for one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from far_tpu_torch.geometry.epipolar import (
    decompose_essential_matrix,
    essential_from_pose34,
    sampson_epipolar_distance,
    symmetrical_epipolar_distance,
)
from far_tpu_torch.geometry.solvers import (
    fast_decompose_essential,
    recover_pose_from_essential,
    run_8point,
    run_8point_essential,
)
from far_tpu_torch.ops.fivepoint import fivepoint_essential
from far_tpu_torch.solvers.types import PoseEstimate, PriorParams

# elimination passes per 5-point sample (see fivepoint._basis_rotations)
_FIVEPT_ROTATIONS = 2


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """The JAX package's fields and defaults (a test holds them equal)."""

    num_hypotheses: int = 2048   # total hypothesis budget; 5pt: 20 a sample
    minimal_solver: str = "8pt"  # '8pt' or '5pt' (Nister)
    inl_th: float = 3e-7         # squared epipolar error on normalized coords
    prior_lambda: float = 0.3
    bias_sigma_sq: float = 0.1
    use_prior_scoring: bool = True
    use_biased_sampling: bool = True
    distance_thresh: float = 1e9
    error_fn: str = "sampson"    # or 'symmetric'
    scoring: str = "inlier"      # or 'magsac' (sigma-marginalized count)
    magsac_levels: int = 8
    fivept_det_tol: float = 2.5e-2  # |det E| filter of the 5-point candidates
    min_valid: int = 8
    linalg: str = "fast"         # 'fast' (power-iteration paths) or 'exact'
    polish: bool = True          # weighted LS re-fit on the winning inliers

    def __post_init__(self):
        for name, allowed in (("minimal_solver", ("8pt", "5pt")),
                              ("error_fn", ("sampson", "symmetric")),
                              ("scoring", ("inlier", "magsac")),
                              ("linalg", ("fast", "exact"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"RansacConfig.{name}={getattr(self, name)!r}, "
                                 f"not one of {allowed}")

    def sampling(self):
        """(samples drawn, points a sample, candidates a sample)."""
        if self.minimal_solver == "5pt":
            n_cand = 10 * _FIVEPT_ROTATIONS
            return max(self.num_hypotheses // n_cand, 1), 5, n_cand
        return self.num_hypotheses, 8, 1


def draw_round_uniforms(cfg: RansacConfig, B: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """One round's sampler draws, (B, n_samples, S) float32 uniforms
    (``cfg.sampling()``), from ``generator`` (or the device's default
    generator) on ``device``."""
    n_samples, S, _ = cfg.sampling()
    return torch.rand((B, n_samples, S), generator=generator, device=device,
                      dtype=torch.float32)


def sample_indices(u: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
    """Weighted sampling with replacement by inverse CDF.

    Args:
        u: (B, n, S) uniforms in [0, 1); logw: (B, N) log weights (-inf
            for invalid points).
    Returns:
        (B, n, S) int64 indices: #{cdf < u * total}, capped at N - 1.
    """
    B, N = logw.shape
    w = torch.exp(logw - logw.amax(dim=-1, keepdim=True))
    cdf = torch.cumsum(w, dim=-1)
    target = u * cdf[:, -1:, None]
    idx = torch.searchsorted(cdf.contiguous(), target.reshape(B, -1),
                             side="left").reshape(u.shape)
    return idx.clamp(max=N - 1)


def _epipolar_error(cfg: RansacConfig, p1, p2, E):
    if cfg.error_fn == "symmetric":
        return symmetrical_epipolar_distance(p1, p2, E)
    return sampson_epipolar_distance(p1, p2, E)


def prior_transport_error(E: torch.Tensor, prior: PriorParams,
                          linalg: str = "fast") -> torch.Tensor:
    """Min point-cloud transport error between the hypotheses' poses (both
    rotation candidates, +t) and the prior with unit translation.
    E (B, H, 3, 3) -> (B, H)."""
    if linalg == "fast":
        R1, R2, t = fast_decompose_essential(E)
    else:
        R1, R2, t = decompose_essential_matrix(E)
    prior_R = prior.rt[..., :3, :3]
    prior_t = prior.rt[..., :3, 3]
    prior_t = prior_t / (torch.linalg.norm(prior_t, dim=-1, keepdim=True) + 1e-8)
    pcl = prior.pcl
    target = torch.einsum("bij,pj->bpi", prior_R, pcl) + prior_t[:, None, :]

    def transport(R, tt):
        moved = torch.einsum("bhij,pj->bhpi", R, pcl) + tt[..., None, :]
        return (moved - target[:, None]).abs().mean(dim=(-1, -2))

    return torch.minimum(transport(R1, t), transport(R2, t))


def prior_ransac(
    kp1: torch.Tensor,
    kp2: torch.Tensor,
    valid: torch.Tensor,
    prior: Optional[PriorParams] = None,
    cfg: RansacConfig = RansacConfig(),
    inl_th: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PoseEstimate:
    """One batched RANSAC round.

    Args:
        kp1/kp2: (B, N, 2) K-normalized correspondences (padded).
        valid: (B, N) bool validity mask.
        prior: optional pose prior (biased sampling + prior scoring).
        inl_th: optional (B,) per-pair squared threshold.
        uniforms: optional (B, n_samples, S) sampler draws (S = 8 for the
            8-point solver, 5 for the 5-point one, n_samples from
            ``cfg.sampling()``); else ``draw_round_uniforms`` draws them
            from ``generator`` on the points' device.
    """
    B, N, _ = kp1.shape
    n_samples, S, n_cand = cfg.sampling()
    dtype = kp1.dtype
    validf = valid.to(dtype)

    if prior is not None and cfg.use_biased_sampling:
        prior_err = symmetrical_epipolar_distance(
            kp1, kp2, essential_from_pose34(prior.rt))
        bias = torch.exp(-prior_err / cfg.bias_sigma_sq) + 1e-4
        logw = torch.where(valid, torch.log(bias), -torch.inf)
    else:
        logw = torch.where(valid, 0.0, -torch.inf).to(dtype)
    if uniforms is None:
        uniforms = draw_round_uniforms(cfg, B, generator, kp1.device)
    if tuple(uniforms.shape) != (B, n_samples, S):
        raise ValueError(f"uniforms {tuple(uniforms.shape)} != {(B, n_samples, S)}")
    idx = sample_indices(uniforms.to(device=kp1.device, dtype=dtype), logw)

    # ---- minimal solves: E (B, H, 3, 3) and the slots that hold one
    bidx = torch.arange(B, device=kp1.device)[:, None, None]
    kp1_s, kp2_s = kp1[bidx, idx], kp2[bidx, idx]             # (B, n, S, 2)
    if cfg.minimal_solver == "5pt":
        E5, valid5 = fivepoint_essential(
            kp1_s, kp2_s, n_basis_rotations=_FIVEPT_ROTATIONS,
            det_tol=cfg.fivept_det_tol)
        E = E5.reshape(B, n_samples * n_cand, 3, 3)
        finite = valid5.reshape(B, n_samples * n_cand) \
            & torch.isfinite(E).all(dim=-1).all(dim=-1)
    else:
        if cfg.linalg == "fast":
            E = run_8point_essential(kp1_s, kp2_s, impl="power")
        else:
            # unprojected rank-2 DLT hypotheses, as the JAX package scores
            # them (projecting minimal samples costs inliers)
            E = run_8point(kp1_s, kp2_s)
        finite = torch.isfinite(E).all(dim=-1).all(dim=-1)

    # ---- verification and scoring
    thr = cfg.inl_th if inl_th is None else inl_th[:, None, None]
    errs = _epipolar_error(cfg, kp1[:, None], kp2[:, None], E)  # (B, H, N)
    inl = (errs <= thr) & valid[:, None]
    if cfg.scoring == "magsac":
        # the inlier indicator marginalized over sigma in (0, sigma_max] at
        # L levels: level l counts errors below thr (l / L)^2
        L = cfg.magsac_levels
        score = torch.zeros(errs.shape[:2], dtype=dtype, device=kp1.device)
        for lvl in range(1, L + 1):
            frac = (lvl / L) ** 2
            score = score + ((errs <= thr * frac) & valid[:, None]).to(dtype).sum(-1)
        score = score / L
    else:
        score = inl.to(dtype).sum(-1)
    if prior is not None and cfg.use_prior_scoring:
        score = score - prior_transport_error(E, prior, cfg.linalg) ** 2 \
            / cfg.prior_lambda
    score = torch.where(finite, score, -torch.inf)
    best = score.argmax(dim=-1)                               # (B,)
    ar = torch.arange(B, device=kp1.device)
    E_best, err_best, inl_best = E[ar, best], errs[ar, best], inl[ar, best]

    # ---- polish: weighted LS re-fit over the winning inliers, kept where
    # it loses none
    thr_b = cfg.inl_th if inl_th is None else inl_th[:, None]
    if cfg.polish:
        w_inl = inl_best.to(dtype)
        enough = w_inl.sum(-1, keepdim=True) >= 8
        w_safe = torch.where(enough, w_inl, validf)
        E_pol = run_8point_essential(kp1, kp2, weights=w_safe, impl="eigh")
        errs_pol = _epipolar_error(cfg, kp1, kp2, E_pol)
        inl_pol = (errs_pol <= thr_b) & valid
        better = ((inl_pol.to(dtype).sum(-1) >= w_inl.sum(-1))
                  & torch.isfinite(E_pol).all(dim=-1).all(dim=-1))
        E_best = torch.where(better[:, None, None], E_pol, E_best)
        err_best = torch.where(better[:, None], errs_pol, err_best)
        inl_best = torch.where(better[:, None], inl_pol, inl_best)

    num_inl = inl_best.to(dtype).sum(-1)
    num_tight = ((err_best <= thr_b / 10.0) & valid).to(dtype).sum(-1)
    num_ultra = ((err_best <= thr_b / 100.0) & valid).to(dtype).sum(-1)

    R, t, _, _ = recover_pose_from_essential(
        E_best, kp1, kp2, weights=inl_best.to(dtype),
        distance_thresh=cfg.distance_thresh,
        method="fast" if cfg.linalg == "fast" else "svd")

    success = validf.sum(-1) >= cfg.min_valid
    eye = torch.eye(3, dtype=dtype, device=kp1.device).expand(B, 3, 3)
    s3, s2, sf = success[:, None, None], success[:, None], success.to(dtype)
    return PoseEstimate(
        E=torch.where(s3, E_best, eye),
        R=torch.where(s3, R, eye),
        t=torch.where(s2, t, torch.zeros_like(t)),
        inliers=inl_best & s2,
        num_inliers=num_inl * sf,
        num_tight=num_tight * sf,
        num_ultra_tight=num_ultra * sf,
        success=success,
    )
