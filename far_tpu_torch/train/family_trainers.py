"""Training steps of the ViTEss and map-free 6DReg families.

Counterpart of ``far_tpu/train/family_trainers.py`` (the FAR family's
trainer is ``train/trainer.py``):

- ``ViTEssTrainer``: ``w_tr MSE(t) + w_rot MSE(6D)`` of the 9D pose in
  the dataset's normalised space (``VITESS_POSE_STATS``), gated by the
  batch's solver pose when ``use_loftr_gating`` is set. The CrossBlock
  runs K4 twice a step through ``bilinear_dual_softmax_auto``; its
  backward recomputes the plain version at 576 tokens.
- ``SixDRegTrainer``: the MAGSAC RANSAC round on the batch's detached
  correspondences, without gradient, inside the step; its pose and
  inlier counts go into ``MapfreeRegression``, then ``combined_loss``.
  With ``lam == 0`` the Kendall-Cipolla weights ``s_r`` and ``s_t`` are
  learnable scalars of the trainer (not of the model, so a reference
  state dict still loads with ``strict=True``): clipped, updated and
  counted in ``grad_norm`` with the model's parameters.

Both have the FAR trainer's optimizer (``train/optim.py``), ``step``
(metrics as floats, ``grad_norm`` the global norm of the gradients before
clipping), ``eval_step`` (the model in eval mode: running statistics, no
update of them or of the parameters) and ``state_dict`` /
``load_state_dict``; they run on CUDA unless given ``device="cpu"``.
Under a process group they are data-parallel as the FAR trainer is (the
JAX package's ``_SpmdTrainer`` over a mesh): ``step`` and ``eval_step``
take this rank's rows of the global batch (``comm.shard_rows``), the
model and the trainer's own parameters run inside one DDP module,
BatchNorm's moments cover every rank's rows, and the metrics are the
global batch's. Every
loss here is a plain mean over equal shards, so DDP's average of the
gradients is the global loss's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from far_tpu_torch.geometry.rotations import matrix_to_rotation_6d
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
from far_tpu_torch.parallel import comm
from far_tpu_torch.pipeline import resolve_device
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose
from far_tpu_torch.train.mapfree_losses import combined_loss
from far_tpu_torch.train.optim import OptimConfig, build_optimizer, global_norm
from far_tpu_torch.utils.convert_weights import init_weights


# ---- batches and collates --------------------------------------------------

@dataclasses.dataclass
class ViTEssBatch:
    images: torch.Tensor                            # (B, 2, H, W, 3) RGB in [0, 1]
    T_0to1: torch.Tensor                            # (B, 4, 4)
    solver_rt: Optional[torch.Tensor] = None        # (B, 3, 4) gating input
    solver_num_corr: Optional[torch.Tensor] = None  # (B,)


@dataclasses.dataclass
class MapfreeBatch:
    image0: torch.Tensor      # (B, H, W, 3) RGB at the regressor's size
    image1: torch.Tensor
    corr: torch.Tensor        # (B, N, 2, 2) pixel matches
    corr_valid: torch.Tensor  # (B, N) bool
    K0: torch.Tensor          # (B, 3, 3)
    K1: torch.Tensor
    T_0to1: torch.Tensor      # (B, 4, 4)


def _rgb(sample: Dict, key: str) -> np.ndarray:
    """The sample's ``<key>_rgb``, or its grayscale image tiled to 3 channels."""
    if f"{key}_rgb" in sample:
        return np.asarray(sample[f"{key}_rgb"], np.float32)
    return np.tile(np.asarray(sample[key], np.float32), (1, 1, 3))


def _stack(samples: List[Dict], fn, device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(fn(s), dtype) for s in samples])).to(device)


def collate_vitess(samples: List[Dict], device) -> ViTEssBatch:
    """A ViTEss batch on ``device``; the solver pose and count where every
    sample has a ``solver_rt``."""
    batch = ViTEssBatch(
        images=_stack(samples, lambda s: np.stack([_rgb(s, "image0"), _rgb(s, "image1")]),
                      device),
        T_0to1=_stack(samples, lambda s: s["T_0to1"], device))
    if all("solver_rt" in s for s in samples):
        batch.solver_rt = _stack(samples, lambda s: s["solver_rt"], device)
        batch.solver_num_corr = _stack(samples, lambda s: s.get("num_correspondences", 0.0),
                                       device)
    return batch


def collate_sixdreg(samples: List[Dict], device) -> MapfreeBatch:
    """A map-free batch on ``device`` from ``GTCorrespondenceDataset`` samples."""
    return MapfreeBatch(
        image0=_stack(samples, lambda s: _rgb(s, "image0"), device),
        image1=_stack(samples, lambda s: _rgb(s, "image1"), device),
        corr=_stack(samples, lambda s: s["correspondences"], device),
        corr_valid=_stack(samples, lambda s: s["corr_valid"], device, bool),
        K0=_stack(samples, lambda s: s["K0"], device),
        K1=_stack(samples, lambda s: s["K1"], device),
        T_0to1=_stack(samples, lambda s: s["T_0to1"], device))


# ---- the shared step ---------------------------------------------------------

def _images(batch) -> torch.Tensor:
    """A family batch's first field, its images."""
    return getattr(batch, dataclasses.fields(batch)[0].name)


class _FamilyStep(torch.nn.Module):
    """The model and the trainer's own parameters as one module, whose
    ``forward(batch, uniforms, prior_pcl)`` is the trainer's loss: DDP
    reduces the gradients of what it holds, and prepares that in
    ``forward``."""

    def __init__(self, model: torch.nn.Module, extra: Dict[str, torch.nn.Parameter],
                 loss_fn):
        super().__init__()
        self.model = model
        self.extra = torch.nn.ParameterDict(extra)
        self.loss_fn = loss_fn

    def forward(self, batch, uniforms=None, prior_pcl=None):
        return self.loss_fn(batch, uniforms, prior_pcl)


class _FamilyTrainer:
    """One model on one device (this rank's card under a process group),
    its optimizer over the model's parameters and the trainer's own
    (``self.extra``), and the step count."""

    def __init__(self, model: torch.nn.Module, optim_cfg: OptimConfig, device,
                 extra: Dict[str, float] = None):
        self.model = model.to(resolve_device(device)).train()
        self.device = next(self.model.parameters()).device  # cuda:0, not cuda
        self.step_module = _FamilyStep(
            self.model, {k: torch.nn.Parameter(torch.tensor(v, device=self.device))
                         for k, v in (extra or {}).items()}, self._loss)
        self.extra = self.step_module.extra
        self.optimizer = build_optimizer(optim_cfg, self.parameters())
        self.step_count = 0
        self._ddp = None

    def parameters(self) -> List[torch.nn.Parameter]:
        """The model's parameters (each once), then the trainer's own."""
        return list(self.model.parameters()) + list(self.extra.values())

    def init(self, seed: int = 0):
        """Deterministic random weights (``init_weights``); the trainer's
        own parameters at 0."""
        init_weights(self.model, seed)
        with torch.no_grad():
            for p in self.extra.values():
                p.zero_()
        return self

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "extra": {k: p.detach().clone() for k, p in self.extra.items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step_count}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        if set(state["extra"]) != set(self.extra):
            raise KeyError(f"trainer parameters {sorted(state['extra'])}, "
                           f"expected {sorted(self.extra)}")
        with torch.no_grad():
            for k, p in self.extra.items():
                p.copy_(state["extra"][k])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])

    def _loss(self, batch, uniforms, prior_pcl):
        """(loss, {metric: tensor}) of one forward pass in the model's mode,
        on this rank's rows, with the solver's draws ``uniforms``."""
        raise NotImplementedError

    def _draws(self, rows: int, generator) -> Optional[torch.Tensor]:
        """The solver's draws for this rank's ``rows`` pairs, cut from the
        global batch's; None where the step runs no solver."""
        return None

    def loss(self, batch, generator=None, uniforms=None, prior_pcl=None):
        """(loss, {metric: tensor}) of one forward pass in the model's mode
        on ``batch``, this rank's rows, without DDP."""
        return self._forward(self.step_module, batch, generator, uniforms, prior_pcl)

    def _forward(self, module, batch, generator, uniforms, prior_pcl):
        if uniforms is None:
            uniforms = self._draws(len(_images(batch)), generator)
        return module(batch, uniforms, prior_pcl)

    def _check_device(self, batch) -> None:
        where = _images(batch).device
        if where != self.device:
            raise ValueError(f"batch on {where}, model on {self.device}")

    def step(self, batch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[torch.Tensor] = None,
             prior_pcl: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One training step on ``batch``, this rank's rows of the global
        batch (``comm.shard_rows``); returns the global batch's metrics as
        floats. ``uniforms`` are this rank's rows of the solver's draws, or
        None for the global batch's draws from ``generator``, cut."""
        self._check_device(batch)
        self.model.train()
        if self._ddp is None:
            self._ddp = comm.data_parallel(self.step_module)
        self.optimizer.zero_grad()
        loss, metrics = self._forward(self._ddp, batch, generator, uniforms, prior_pcl)
        loss.backward()
        grad_norm = global_norm([p.grad for p in self.parameters() if p.grad is not None])
        self.optimizer.step()
        self.step_count += 1
        return comm.mean_scalars({**metrics, "grad_norm": grad_norm})

    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None,
                  prior_pcl: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The global batch's loss metrics with the model in eval mode;
        nothing changes. ``batch`` and ``uniforms`` as in ``step``."""
        self._check_device(batch)
        self.model.eval()
        try:
            _, metrics = self.loss(batch, generator, uniforms, prior_pcl)
        finally:
            self.model.train()
        return comm.mean_scalars(metrics)


# ---- ViTEss -----------------------------------------------------------------

class ViTEssTrainer(_FamilyTrainer):
    """``w_tr MSE(pred_t, t) + w_rot MSE(pred_r6, r6)`` with the ground
    truth normalised by the dataset's statistics when
    ``cfg.use_normalized_6d``. No solver runs in the step: a gated model
    takes the batch's ``solver_rt`` and ``solver_num_corr``, so ``step``'s
    solver arguments are accepted and unused."""

    def __init__(self, cfg: ViTEssConfig, optim_cfg: OptimConfig = OptimConfig(),
                 w_tr: float = 10.0, w_rot: float = 10.0, device=None):
        self.cfg = cfg
        self.w_tr, self.w_rot = w_tr, w_rot
        super().__init__(ViTEss(cfg), optim_cfg, device)

    def _loss(self, batch: ViTEssBatch, uniforms=None, prior_pcl=None):
        _, _, pred_9d, _ = self.model(batch.images, batch.solver_rt, batch.solver_num_corr)
        gt_t = batch.T_0to1[..., :3, 3]
        gt_r6 = matrix_to_rotation_6d(batch.T_0to1[..., :3, :3])
        if self.cfg.use_normalized_6d:
            mean, std = self.model.pose_mean, self.model.pose_std
            gt_t = (gt_t - mean[:3]) / std[:3]
            gt_r6 = (gt_r6 - mean[3:]) / std[3:]
        loss_tr = ((pred_9d[..., :3] - gt_t) ** 2).mean()
        loss_rot = ((pred_9d[..., 3:] - gt_r6) ** 2).mean()
        loss = self.w_tr * loss_tr + self.w_rot * loss_rot
        return loss, {"loss": loss, "loss_tr": loss_tr, "loss_rot": loss_rot}


# ---- map-free 6DReg ---------------------------------------------------------

class SixDRegTrainer(_FamilyTrainer):
    """Solver (no gradient) -> ``MapfreeRegression`` -> ``combined_loss``.
    The solver is the map-free reference's MAGSAC round:
    ``SolverConfig(solver="ransac", pixel_thr, scoring="magsac")``; its
    draws come from ``generator`` or ``uniforms`` (B, 2048, 8)."""

    def __init__(self, cfg: SixDRegConfig, optim_cfg: OptimConfig = OptimConfig(),
                 rot_loss: str = "rot_6d_loss",
                 trans_loss: str = "trans_unnormalized_loss",
                 lam: float = 1.0, pixel_thr: float = 2.0, device=None):
        self.cfg = cfg
        self.rot_loss, self.trans_loss, self.lam = rot_loss, trans_loss, lam
        self.solver_cfg = SolverConfig(solver="ransac", pixel_thr=pixel_thr,
                                       scoring="magsac")
        extra = {"s_r": 0.0, "s_t": 0.0} if lam == 0.0 else None
        super().__init__(MapfreeRegression(cfg), optim_cfg, device, extra)

    def _draws(self, rows: int, generator) -> torch.Tensor:
        shape = self.solver_cfg.ransac_config(False).sampling()[:2]
        return comm.shard_rows(torch.rand((rows * comm.process_count(), *shape),
                                          generator=generator, device=self.device,
                                          dtype=torch.float32))

    def _loss(self, batch: MapfreeBatch, uniforms=None, prior_pcl=None):
        with torch.no_grad():
            est = estimate_pose(batch.corr[..., 0, :], batch.corr[..., 1, :], batch.K0,
                                batch.K1, batch.corr_valid, cfg=self.solver_cfg,
                                prior_pcl=prior_pcl, uniforms=uniforms)
            counts = torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)
            rt = torch.cat([est.R, est.t[..., None]], -1)
        R, t, _, _ = self.model(batch.image0, batch.image1, rt, counts)
        total, parts = combined_loss(
            R, t, batch.T_0to1[..., :3, :3], batch.T_0to1[..., :3, 3],
            rot_loss=self.rot_loss, trans_loss=self.trans_loss, lam=self.lam,
            s_r=self.extra.get("s_r"), s_t=self.extra.get("s_t"))
        return total, {"loss": total, "loss_rot": parts["rot_loss"],
                       "loss_tr": parts["trans_loss"],
                       "solver_inliers": est.num_inliers.mean()}
