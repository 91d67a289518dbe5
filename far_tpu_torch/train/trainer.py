"""The FARLoFTR trainer: one step on one card, or data-parallel over ranks.

Counterpart of ``far_tpu/train/trainer.py``. A step:

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

Under a process group (``parallel.comm.init_distributed``, one process a
card) the step is the JAX package's step over a 1-D mesh: ``step`` takes
this rank's contiguous rows of the global batch (``comm.shard_rows``),
the solver's draws are the global batch's cut to this rank's rows,
``FarStep`` (steps 1-3 and the losses) runs inside DDP, which averages
the gradients, BatchNorm's moments and the losses' counts cover every
rank's rows (``models/backbone.bn``, ``train/losses``), and the metrics
are the global batch's. A W-rank step is then the one-process step on
the whole batch.

The metrics are the loss scalars, ``num_matches`` and the global norm of
the gradients before clipping. The entry point runs on CUDA unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from far_tpu_torch.models.constants import denormalize_9d
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.parallel import comm
from far_tpu_torch.pipeline import _summarize, make_solver_configs, resolve_device
from far_tpu_torch.solvers.pose_estimation import estimate_pose
from far_tpu_torch.train.losses import compute_losses
from far_tpu_torch.train.optim import OptimConfig, build_optimizer, global_norm
from far_tpu_torch.train.supervision import coarse_supervision, fine_supervision
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights


class FarStep(torch.nn.Module):
    """Steps 1-3 and the losses as one module, ``forward(batch, uniforms,
    prior_pcl) -> (FarLosses, num_matches)``: DDP prepares its gradient
    reduction in ``forward``, and the loss calls ``match``,
    ``regress_features`` and ``regress_fuse``, never the model's forward.

    ``uniforms`` are the solver's draws, one (B, n_samples, S) tensor a
    round, or None for the default generator's; ``prior_pcl`` the prior
    rounds' probe cloud, as in ``pipeline.far_forward``."""

    def __init__(self, model: FARLoFTR):
        super().__init__()
        self.model = model

    def forward(self, batch: PairBatch, uniforms: Optional[Sequence[torch.Tensor]] = None,
                prior_pcl: Optional[torch.Tensor] = None):
        model = self.model
        cfg = model.config
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
                        uniforms=None if uniforms is None else uniforms[i])
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


def solver_draws(cfg: FARConfig, rows: int, generator: Optional[torch.Generator],
                 device) -> List[torch.Tensor]:
    """The training solver's draws for this rank's ``rows`` pairs: each
    round's (W * rows, n_samples, S) uniforms from ``generator`` (the
    default generator when None), as ``prior_ransac`` draws them, cut to
    this rank's rows. A W-rank step at a seed so draws what the
    one-process step at that seed draws."""
    first_cfg, refine_cfg = make_solver_configs(cfg)
    rounds = [first_cfg.ransac_config(False)] + \
        [refine_cfg.ransac_config(refine_cfg.solver == "prior_ransac")] \
        * (max(cfg.solver.fine_pred_steps, 1) - 1)
    n = rows * comm.process_count()
    return [comm.shard_rows(torch.rand((n, *r.sampling()[:2]), generator=generator,
                                       device=device, dtype=torch.float32))
            for r in rounds]


class Trainer:
    """Usage::

        trainer = Trainer(cfg, OptimConfig(...))      # on CUDA (this rank's card)
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
        self.step_module = FarStep(self.model)
        self._ddp = None

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
        """(FarLosses, num_matches) of one forward pass in train mode on
        ``batch``, this rank's rows, without DDP.

        ``generator``, ``uniforms`` and ``prior_pcl`` are the solver's, as in
        ``pipeline.far_forward``: one (B, n_samples, S) uniform tensor per
        round, or the global batch's draws from ``generator``."""
        return self._forward(self.step_module, batch, generator, uniforms, prior_pcl)

    def _forward(self, module, batch, generator, uniforms, prior_pcl):
        self.model.train()
        if uniforms is None and self.cfg.regress_rt:
            uniforms = solver_draws(self.cfg, batch.image0.shape[0], generator, self.device)
        return module(batch, uniforms, prior_pcl)

    def step(self, batch: PairBatch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             prior_pcl: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One training step on ``batch``, this rank's rows of the global
        batch (``comm.shard_rows``, or the training CLI's loaders); returns
        the global batch's metrics as floats. ``uniforms`` are this rank's
        rows of the solver's draws, or None for the global batch's draws
        from ``generator``, cut to this rank's rows."""
        if batch.image0.device != self.device:
            raise ValueError(f"batch on {batch.image0.device}, model on {self.device}")
        if self._ddp is None:
            self._ddp = comm.data_parallel(self.step_module)
        self.optimizer.zero_grad()
        losses, num_matches = self._forward(self._ddp, batch, generator, uniforms, prior_pcl)
        losses.total.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = global_norm(grads)
        self.optimizer.step()
        self.step_count += 1
        return comm.mean_scalars({**losses.scalars(), "num_matches": num_matches,
                                  "grad_norm": grad_norm})
