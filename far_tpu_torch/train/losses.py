"""FAR training losses.

Counterpart of ``far_tpu/train/losses.py``: focal or cross-entropy coarse
loss on the dual-softmax confidences (sparse or dense supervision), the
fine l2 (or inverse-std weighted l2) loss, L1/L2 on the normalized 9D
pose, and the clamped translation-scale loss. Every reduction is a masked
mean, so the static-shape padding never counts.

Under a process group the losses are those of the global batch, every
rank's rows, as the JAX package's step over a mesh computes them: a
masked mean divides this rank's sum by the count over all ranks, times
the world size, so that DDP's average of the ranks' gradients (and the
mean of their values) is the global mean's; the fine loss's inverse-std
normaliser, the RT loss's clamp and the scale loss's cut-off read global
values. Plain means over equal shards need nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from far_tpu_torch.models.constants import compute_normalized_6d
from far_tpu_torch.parallel.comm import all_reduce_sum, mean_over_ranks, process_count
from far_tpu_torch.utils.config import LossConfig


@dataclasses.dataclass
class FarLosses:
    total: torch.Tensor
    coarse: torch.Tensor
    fine: torch.Tensor
    rt_rot: torch.Tensor
    rt_tr: torch.Tensor
    scale: torch.Tensor

    def scalars(self) -> Dict[str, torch.Tensor]:
        return {"loss": self.total, "loss_c": self.coarse, "loss_f": self.fine,
                "loss_rot": self.rt_rot, "loss_tr": self.rt_tr,
                "loss_scale": self.scale}


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """This rank's share of the global masked mean (see the module note)."""
    m = mask.to(x.dtype)
    return (x * m).sum() / (all_reduce_sum(m.sum().detach()) + eps) * process_count()


@torch.no_grad()
def _global_masked_mean(x: torch.Tensor, mask: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """The masked mean over every rank's rows, without gradient."""
    m = mask.to(x.dtype)
    num, count = all_reduce_sum(torch.stack([(x * m).sum(), m.sum()]))
    return num / (count + eps)


def _clamp_global(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """This rank's share of a mean over equal shards, clamped as the global
    mean is: the clamp's bound where the global mean is past it."""
    g = mean_over_ranks(x)
    return torch.where((g >= lo) & (g <= hi), x, g.clamp(lo, hi))


def coarse_loss(conf: torch.Tensor, conf_gt: torch.Tensor, cfg: LossConfig,
                sparse_spvs: bool = True,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal (or CE) loss on the (B, L, S) confidences; with
    ``sparse_spvs`` only the positive cells are supervised."""
    conf = conf.float().clamp(1e-6, 1 - 1e-6)
    pos = conf_gt == 1
    neg = conf_gt == 0
    w = torch.ones_like(conf) if weight is None else weight
    if cfg.coarse_type == "cross_entropy":
        lp = _masked_mean(-torch.log(conf) * w, pos)
        ln = _masked_mean(-torch.log(1 - conf) * w, neg)
        return cfg.pos_weight * lp + cfg.neg_weight * ln
    a, g = cfg.focal_alpha, cfg.focal_gamma
    loss_pos = -a * (1 - conf) ** g * torch.log(conf)
    if sparse_spvs:
        return cfg.pos_weight * _masked_mean(loss_pos * w, pos)
    loss_neg = -a * conf ** g * torch.log(1 - conf)
    return cfg.pos_weight * _masked_mean(loss_pos * w, pos) \
        + cfg.neg_weight * _masked_mean(loss_neg * w, neg)


def fine_loss(expec_f: torch.Tensor, expec_f_gt: torch.Tensor,
              valid: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """l2 (optionally inverse-std weighted, the weights detached) loss on
    the fine offsets, over real matches whose GT offset lies inside the
    window (inf-norm < fine_correct_thr)."""
    correct = (expec_f_gt.abs().amax(dim=-1) < cfg.fine_correct_thr) & valid
    off = ((expec_f_gt - expec_f[..., :2]) ** 2).sum(dim=-1)
    if cfg.fine_type == "l2":
        return _masked_mean(off, correct)
    inv_std = 1.0 / expec_f[..., 2].clamp(min=1e-10)
    denom = _global_masked_mean(inv_std, valid)   # over the valid population
    w = torch.where(valid, inv_std / (denom + 1e-8), torch.zeros_like(inv_std))
    return _masked_mean(off * w.detach(), correct)


def rt_loss(pose_9d: torch.Tensor, T_0to1: torch.Tensor,
            cfg: LossConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(translation, rotation) L1 or L2 of the normalized 9D pose against
    the ground truth's."""
    gt = compute_normalized_6d(T_0to1[..., :3, :4])
    p = 1 if cfg.use_l1_rt_loss else 2
    diff = (pose_9d - gt).abs() ** p
    return (_clamp_global(diff[..., :3].mean(), 1e-8, 1e5),
            _clamp_global(diff[..., 3:].mean(), 1e-8, 1e5))


def scale_loss(translation_scale: torch.Tensor, T_0to1: torch.Tensor,
               cfg: LossConfig) -> torch.Tensor:
    """Squared error of the metric translation norm, 0 (and no gradient)
    above ``max_scale_loss``."""
    gt = torch.linalg.norm(T_0to1[..., :3, 3], dim=-1)
    loss = ((translation_scale - gt) ** 2).mean()
    return torch.where(mean_over_ranks(loss) > cfg.max_scale_loss,
                       torch.zeros_like(loss), loss)


def compute_losses(cfg: LossConfig, conf=None, conf_gt=None, expec_f=None,
                   expec_f_gt=None, fine_valid=None, pose_9d=None, T_0to1=None,
                   translation_scale=None, sparse_spvs: bool = True) -> FarLosses:
    """Each configured loss and their weighted total (absent ones are 0)."""
    like = next(t for t in (conf, expec_f, pose_9d, translation_scale, T_0to1)
                if t is not None)
    zero = torch.zeros((), dtype=torch.float32, device=like.device)
    l_c = l_f = l_rot = l_tr = l_s = zero
    if conf is not None and conf_gt is not None:
        l_c = coarse_loss(conf, conf_gt, cfg, sparse_spvs)
    if expec_f is not None and expec_f_gt is not None:
        l_f = fine_loss(expec_f, expec_f_gt, fine_valid, cfg)
    if pose_9d is not None and T_0to1 is not None \
            and (cfg.rt_weight_rot + cfg.rt_weight_tr) > 0:
        l_tr, l_rot = rt_loss(pose_9d, T_0to1, cfg)
    if translation_scale is not None and T_0to1 is not None:
        l_s = scale_loss(translation_scale, T_0to1, cfg)
    total = (l_c * cfg.coarse_weight + l_f * cfg.fine_weight
             + l_rot * cfg.rt_weight_rot + l_tr * cfg.rt_weight_tr
             + l_s * cfg.scale_weight)
    return FarLosses(total=total, coarse=l_c, fine=l_f, rt_rot=l_rot,
                     rt_tr=l_tr, scale=l_s)
