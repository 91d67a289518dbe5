"""One training step of FARLoFTR on one device.

Counterpart of ``far_tpu/train/trainer.py:make_train_step`` (its data
parallelism over a mesh is not ported). A step:

1. ``FARLoFTR.match`` in train mode: BatchNorm on the batch's statistics,
   the coarse stack through K1, the dense confidence matrix, the fine
   transformer layer by layer;
2. coarse and fine supervision from depth, without gradient;
3. the EMM features once (K4 twice), then ``fine_pred_steps`` rounds of
   the robust solver on the detached keypoints, without gradient, each
   followed by the MoE fusion; a later round's prior is the previous
   round's fused pose, detached, and only the last pose reaches the loss;
4. focal, fine and RT losses, backward, and the optimizer
   (``train/optim.py``: clip, AdamW, the non-finite skip, the schedule).

The metrics are the loss scalars, ``num_matches`` and the global norm of
the gradients before clipping. The entry point runs on CUDA unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from far_tpu_torch.models.constants import denormalize_9d
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.pipeline import _summarize, make_solver_configs, resolve_device
from far_tpu_torch.solvers.pose_estimation import estimate_pose
from far_tpu_torch.train.losses import compute_losses
from far_tpu_torch.train.optim import OptimConfig, build_optimizer, global_norm
from far_tpu_torch.train.supervision import coarse_supervision, fine_supervision
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights


class Trainer:
    """Usage::

        trainer = Trainer(cfg, OptimConfig(...))      # on CUDA
        trainer.init(seed=0)                          # or load_state_dict
        metrics = trainer.step(batch, generator=g)    # PairBatch with depth
    """

    def __init__(self, cfg: FARConfig, optim_cfg: OptimConfig = OptimConfig(),
                 device=None):
        self.cfg = cfg
        self.model = FARLoFTR(cfg).to(resolve_device(device)).train()
        self.device = next(self.model.parameters()).device  # cuda:0, not cuda
        self.optimizer = build_optimizer(optim_cfg, self.model.parameters())
        self.step_count = 0

    def init(self, seed: int = 0) -> "Trainer":
        """Deterministic random weights (``init_weights``)."""
        init_weights(self.model, seed)
        return self

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step_count}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])

    def loss(self, batch: PairBatch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             prior_pcl: Optional[torch.Tensor] = None):
        """(FarLosses, num_matches) of one forward pass in train mode.

        ``generator``, ``uniforms`` and ``prior_pcl`` are the solver's, as in
        ``pipeline.far_forward``: one (B, n_samples, S) uniform tensor per
        round."""
        cfg = self.cfg
        model = self.model.train()
        steps = max(cfg.solver.fine_pred_steps, 1)
        if uniforms is not None and len(uniforms) != steps:
            raise ValueError(f"need {steps} uniform tensors, got {len(uniforms)}")
        out = model.match(batch)
        m = out.matches
        with torch.no_grad():
            conf_gt, w_pt0, pt1 = coarse_supervision(
                batch, cfg.coarse_hw, float(cfg.backbone.resolution[0]))
            expec_f_gt = fine_supervision(
                w_pt0, pt1, m.i_ids, m.j_ids, float(cfg.backbone.resolution[1]),
                cfg.fine.window_size, batch.scale1)

        pose_9d = None
        if cfg.regress_rt:
            first_cfg, refine_cfg = make_solver_configs(cfg)
            kp0, kp1 = m.mkpts0_f.detach(), m.mkpts1_f.detach()
            num_before = m.valid.float().sum(-1)
            features = model.regress_features(out.feat_c0, out.feat_c1)
            prior_rt = None
            for i in range(steps):
                with torch.no_grad():
                    est = estimate_pose(
                        kp0, kp1, batch.K0, batch.K1, m.valid, prior_rt=prior_rt,
                        cfg=first_cfg if i == 0 else refine_cfg, prior_pcl=prior_pcl,
                        uniforms=None if uniforms is None else uniforms[i],
                        generator=generator)
                pose_9d, _ = model.regress_fuse(features, _summarize(est, num_before))
                prior_rt = denormalize_9d(pose_9d).detach()

        losses = compute_losses(
            cfg.loss, conf=out.conf_matrix, conf_gt=conf_gt, expec_f=m.expec_f,
            expec_f_gt=expec_f_gt, fine_valid=m.valid, pose_9d=pose_9d,
            T_0to1=batch.T_0to1,
            translation_scale=out.translation_scale
            if cfg.predict_translation_scale else None,
            sparse_spvs=cfg.match.sparse_spvs)
        return losses, m.valid.float().sum(-1).mean()

    def step(self, batch: PairBatch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             prior_pcl: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One training step; returns its metrics as floats."""
        if batch.image0.device != self.device:
            raise ValueError(f"batch on {batch.image0.device}, model on {self.device}")
        self.optimizer.zero_grad()
        losses, num_matches = self.loss(batch, generator, uniforms, prior_pcl)
        losses.total.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = global_norm(grads)
        self.optimizer.step()
        self.step_count += 1
        metrics = {k: float(v.detach()) for k, v in losses.scalars().items()}
        metrics.update(num_matches=float(num_matches), grad_norm=float(grad_norm))
        return metrics
