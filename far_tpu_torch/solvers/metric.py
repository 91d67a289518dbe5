"""Metric-scale pose solvers of the map-free family's classical baseline.

Counterpart of ``far_tpu/solvers/metric.py``:

- ``metric_scale_mean``: the metric translation from the mean 3D
  residual of the inliers projected on the unit t;
- ``metric_scale_ransac``: a 1-D RANSAC over the per-correspondence
  scales, as an (N, N) vote;
- ``pnp_ransac``: a batched DLT-PnP RANSAC over image-0 points
  back-projected with depth, scored by reprojection error and re-fitted
  on the winner's inliers.

The 12x12 smallest-eigenvector solves use the same inverse iteration as
the 8-point solver (``geometry/solvers.py:smallest_eigvec_power``) and the
hypotheses the same inverse-CDF sampler (``solvers/ransac.py:
sample_indices``) on uniforms that are handed in or drawn from a
``torch.Generator``, so a test can give both packages the same draws.
Everything is batched over pairs, statically shaped and masked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from far_tpu_torch.geometry.rotations import so3_project
from far_tpu_torch.geometry.solvers import smallest_eigvec_power
from far_tpu_torch.geometry.transforms import normalize_kpts_by_K
from far_tpu_torch.geometry.warp import _gather_depth
from far_tpu_torch.solvers.ransac import sample_indices


def backproject_3d(kpts: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (B, N, 2) with depth (B, N) -> camera-space points (B, N, 3)."""
    xy = normalize_kpts_by_K(kpts, K)
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1) * depth[..., None]


def _inlier_depths(kpts0, kpts1, depth0, depth1, inliers):
    d0 = _gather_depth(depth0, torch.round(kpts0).to(torch.int32))
    d1 = _gather_depth(depth1, torch.round(kpts1).to(torch.int32))
    return d0, d1, inliers & (d0 > 0) & (d1 > 0)


def _residual_points(R, kpts0, kpts1, depth0, depth1, K0, K1, inliers):
    """(R xyz0, xyz1, valid) of the inliers with depth in both images."""
    d0, d1, valid = _inlier_depths(kpts0, kpts1, depth0, depth1, inliers)
    xyz0r = torch.einsum("bij,bnj->bni", R, backproject_3d(kpts0, d0, K0))
    return xyz0r, backproject_3d(kpts1, d1, K1), valid


def metric_scale_mean(R, t, kpts0, kpts1, depth0, depth1, K0, K1,
                      inliers) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metric t from the mean 3D residual projected on the unit ``t``.

    Args:
        R (B, 3, 3); t (B, 3) unit; kpts (B, N, 2) pixels; depth (B, H, W);
        inliers (B, N) bool.
    Returns:
        (t_metric (B, 3), ok (B,) bool).
    """
    xyz0r, xyz1, valid = _residual_points(R, kpts0, kpts1, depth0, depth1, K0, K1, inliers)
    w = valid.float()
    denom = w.sum(-1, keepdim=True) + 1e-8
    pmean0 = (xyz0r * w[..., None]).sum(1) / denom
    pmean1 = (xyz1 * w[..., None]).sum(1) / denom
    scale = ((pmean1 - pmean0) * t).sum(-1)
    ok = w.sum(-1) >= 1
    return t * scale[..., None] * ok[..., None], ok


def metric_scale_ransac(R, t, kpts0, kpts1, depth0, depth1, K0, K1, inliers,
                        scale_threshold: float = 0.1):
    """Metric t by a 1-D RANSAC over the scales s_i = (xyz1 - R xyz0) . t:
    the s_i with the most s_j within ``scale_threshold`` wins (the first
    on a tie). Returns (t_metric (B, 3), its vote count (B,), ok (B,))."""
    xyz0r, xyz1, valid = _residual_points(R, kpts0, kpts1, depth0, depth1, K0, K1, inliers)
    scales = ((xyz1 - xyz0r) * t[:, None, :]).sum(-1)          # (B, N)
    w = valid.float()
    close = ((scales[:, :, None] - scales[:, None, :]).abs() < scale_threshold).float() \
        * w[:, :, None] * w[:, None, :]
    votes = torch.where(valid, close.sum(1), -1.0)
    best = votes.argmax(dim=-1, keepdim=True)
    best_scale = scales.gather(1, best)[:, 0]
    best_votes = votes.gather(1, best)[:, 0]
    ok = w.sum(-1) >= 1
    return t * best_scale[..., None] * ok[..., None], best_votes.clamp(min=0.0), ok


# ---- DLT-PnP RANSAC --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PnPConfig:
    num_hypotheses: int = 1024
    sample_size: int = 6
    reproj_thr_px: float = 3.0   # the reference's PNP.REPROJECTION_INLIER_THRESHOLD
    min_valid: int = 6
    max_t_norm: float = 1000.0   # degenerate-solution guard


def _dlt_pnp(X: torch.Tensor, uv: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct linear transform PnP: points (..., N, 3) and normalised 2D
    (..., N, 2) -> [R | t] (..., 3, 4). The smallest eigenvector of the
    12x12 normal matrix of [X 1 0 0 -u(X 1); 0 0 X 1 -v(X 1)], scaled so
    that |det| of its rotation block is 1, signed so that most points lie
    in front, its rotation block projected onto SO(3)."""
    u, v = uv[..., 0], uv[..., 1]
    Xh = torch.cat([X, torch.ones_like(u)[..., None]], -1)      # (..., N, 4)
    zeros = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zeros, -u[..., None] * Xh], -1),
                   torch.cat([zeros, Xh, -v[..., None] * Xh], -1)], -2)   # (..., 2N, 12)
    Aw = A if w is None else A * torch.cat([w, w], -1)[..., None]
    p = smallest_eigvec_power(torch.einsum("...ni,...nj->...ij", Aw, A))
    P = p.reshape(*p.shape[:-1], 3, 4)
    s = (torch.linalg.det(P[..., :3, :3]).abs() + 1e-20) ** (1.0 / 3.0)
    P = P / s[..., None, None]
    depths = torch.einsum("...j,...nj->...n", P[..., 2, :3], X) + P[..., 2, 3][..., None]
    sign = torch.where(torch.sign(depths).mean(-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    return torch.cat([so3_project(P[..., :3, :3]), P[..., :3, 3:]], -1)


def _reprojection(P, X, uv1, f1):
    """(pixel error, point in front) of X moved by P (..., 3, 4)."""
    Xc = torch.einsum("...ij,...nj->...ni", P[..., :3, :3], X) + P[..., None, :3, 3]
    z = Xc[..., 2:]
    proj = Xc[..., :2] / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.linalg.norm((proj - uv1) * f1, dim=-1), Xc[..., 2] > 0


def pnp_ransac(pts0: torch.Tensor, pts1: torch.Tensor, depth0: torch.Tensor,
               K0: torch.Tensor, K1: torch.Tensor, valid: torch.Tensor,
               cfg: PnPConfig = PnPConfig(),
               uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Batched DLT-PnP RANSAC: image-0 pixels (B, N, 2) back-projected with
    ``depth0`` (B, H, W), the pose of camera 1 solved from samples of
    ``cfg.sample_size`` points, scored by reprojection error into image 1,
    re-fitted on the winner's inliers where that loses none.

    ``uniforms`` (B, num_hypotheses, sample_size) are the sampler's draws;
    else they come from ``generator`` on the points' device.
    Returns (R (B, 3, 3), t (B, 3), inlier count (B,), ok (B,)).
    """
    B, N, _ = pts0.shape
    d0 = _gather_depth(depth0, torch.round(pts0).to(torch.int32))
    ok_pt = valid & (d0 > 0)
    X = backproject_3d(pts0, d0, K0)                         # (B, N, 3)
    uv1 = normalize_kpts_by_K(pts1, K1)                      # (B, N, 2)
    f1 = torch.stack([K1[..., 0, 0], K1[..., 1, 1]], -1)     # (B, 2)

    shape = (B, cfg.num_hypotheses, cfg.sample_size)
    if uniforms is None:
        uniforms = torch.rand(shape, generator=generator, device=pts0.device)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms {tuple(uniforms.shape)} != {shape}")
    logw = torch.where(ok_pt, 0.0, -torch.inf).to(X.dtype)
    idx = sample_indices(uniforms.to(device=pts0.device, dtype=X.dtype), logw)
    bidx = torch.arange(B, device=pts0.device)[:, None, None]
    P = _dlt_pnp(X[bidx, idx], uv1[bidx, idx])               # (B, Hy, 3, 4)

    err, front = _reprojection(P, X[:, None], uv1[:, None], f1[:, None, None])
    inl = (err < cfg.reproj_thr_px) & front & ok_pt[:, None]  # (B, Hy, N)
    score = inl.float().sum(-1)
    sane = (torch.linalg.norm(P[..., :3, 3], dim=-1) < cfg.max_t_norm) \
        & torch.isfinite(P).all(dim=-1).all(dim=-1)
    score = torch.where(sane, score, -1.0)
    best = score.argmax(dim=-1)
    ar = torch.arange(B, device=pts0.device)
    P_win, inl_win = P[ar, best], inl[ar, best]

    w = inl_win.float()
    enough = w.sum(-1, keepdim=True) >= cfg.min_valid
    P_ref = _dlt_pnp(X, uv1, torch.where(enough, w, ok_pt.float()))
    err_ref, front_ref = _reprojection(P_ref, X, uv1, f1[:, None])
    inl_ref = (err_ref < cfg.reproj_thr_px) & front_ref & ok_pt
    better = inl_ref.float().sum(-1) >= w.sum(-1)
    P_best = torch.where(better[:, None, None], P_ref, P_win)
    inl_final = torch.where(better[:, None], inl_ref, inl_win)

    n_inl = inl_final.float().sum(-1)
    ok = (ok_pt.float().sum(-1) >= cfg.min_valid) & (n_inl >= 4)
    return P_best[..., :3, :3], P_best[..., :3, 3], n_inl, ok
