"""Map-free rotation and translation losses, dispatched by name.

Counterpart of ``far_tpu/train/mapfree_losses.py``: the registries
``ROT_LOSSES`` (Frobenius, L1, geodesic angle, 6D, quaternion, Euler
bins) and ``TRANS_LOSSES`` (L1, L2, metric residual norm, direction
angle, direction plus scale) that the map-free regressor's configuration
names, and ``combined_loss``: ``rot + lam * trans``, or, when ``lam ==
0``, Kendall and Cipolla's homoscedastic weighting with learnable
``s_r`` and ``s_t``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from far_tpu_torch.geometry.rotations import (
    geodesic_distance,
    matrix_to_quaternion,
    matrix_to_rotation_6d,
)

ROT_LOSSES: Dict[str, Callable] = {}
TRANS_LOSSES: Dict[str, Callable] = {}


def _rot(fn):
    ROT_LOSSES[fn.__name__] = fn
    return fn


def _trans(fn):
    TRANS_LOSSES[fn.__name__] = fn
    return fn


# ---- rotation -------------------------------------------------------------

@_rot
def rot_frobenius_loss(R_pred: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Mean of ||R_pred - R_gt||_F^2."""
    return ((R_pred - R_gt) ** 2).sum(dim=(-2, -1)).mean()


@_rot
def rot_l1_loss(R_pred: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    return (R_pred - R_gt).abs().mean()


@_rot
def rot_angle_loss(R_pred: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Mean geodesic angle (radians)."""
    return geodesic_distance(R_pred, R_gt).mean()


@_rot
def rot_6d_loss(R_pred: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Squared L2 between the 6D representations (the FAR map-free one)."""
    d = matrix_to_rotation_6d(R_pred) - matrix_to_rotation_6d(R_gt)
    return (d ** 2).sum(-1).mean()


@_rot
def rot_quat_loss(R_pred: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Quaternion L1, the smaller over the sign of q."""
    q_p, q_g = matrix_to_quaternion(R_pred), matrix_to_quaternion(R_gt)
    d1 = (q_p - q_g).abs().sum(-1)
    d2 = (q_p + q_g).abs().sum(-1)
    return torch.minimum(d1, d2).mean()


@_rot
def rot_bin_loss(R_bins_logits: torch.Tensor, euler_gt_deg: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over 360 / 180 / 360 one-degree Euler-angle bins (the
    angular-bins head); targets rounded half to even, as ``jnp.round``."""
    def target(col, offset, n):
        return (torch.round(euler_gt_deg[..., col]) + offset).clamp(0, n - 1).long()

    def ce(logits, t):
        return -torch.log_softmax(logits, -1).gather(-1, t[..., None])[..., 0]

    return (ce(R_bins_logits[..., :360], target(0, 180, 360))
            + ce(R_bins_logits[..., 360:540], target(1, 90, 180))
            + ce(R_bins_logits[..., 540:900], target(2, 180, 360))).mean()


# ---- translation ----------------------------------------------------------

@_trans
def trans_l1_loss(t_pred: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    return (t_pred - t_gt).abs().mean()


@_trans
def trans_l2_loss(t_pred: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    return ((t_pred - t_gt) ** 2).sum(-1).mean()


@_trans
def trans_unnormalized_loss(t_pred: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """Mean L2 norm of the metric residual (the FAR map-free one)."""
    return torch.linalg.norm(t_pred - t_gt, dim=-1).mean()


@_trans
def trans_ang_loss(t_pred: torch.Tensor, t_gt: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Mean angle between the translation directions."""
    cos = (t_pred * t_gt).sum(-1) / (
        torch.linalg.norm(t_pred, dim=-1) * torch.linalg.norm(t_gt, dim=-1) + eps)
    return torch.arccos(cos.clamp(-1 + 1e-7, 1 - 1e-7)).mean()


@_trans
def trans_scale_direction_loss(t_pred: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """Direction angle plus the mean |norm| residual."""
    scale = (torch.linalg.norm(t_pred, dim=-1) - torch.linalg.norm(t_gt, dim=-1)).abs()
    return trans_ang_loss(t_pred, t_gt) + scale.mean()


def combined_loss(R_pred, t_pred, R_gt, t_gt,
                  rot_loss: str = "rot_6d_loss",
                  trans_loss: str = "trans_unnormalized_loss",
                  lam: float = 1.0,
                  s_r: Optional[torch.Tensor] = None,
                  s_t: Optional[torch.Tensor] = None):
    """(total, {"rot_loss", "trans_loss"}): ``lr + lam * lt`` (``lam``
    scales the translation term), or with ``lam == 0``
    ``lt exp(-s_t) + s_t + lr exp(-s_r) + s_r``."""
    lr = ROT_LOSSES[rot_loss](R_pred, R_gt)
    lt = TRANS_LOSSES[trans_loss](t_pred, t_gt)
    if lam == 0.0:
        if s_r is None or s_t is None:
            raise ValueError("lam == 0 (Kendall-Cipolla weighting) needs s_r and s_t")
        total = lt * torch.exp(-s_t) + s_t + lr * torch.exp(-s_r) + s_r
    else:
        total = lr + lam * lt
    return total, {"rot_loss": lr, "trans_loss": lt}
