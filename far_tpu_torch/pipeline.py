"""End-to-end FAR inference on the card: images -> fused 6DoF pose.

Counterpart of ``far_tpu/pipeline.py`` (``make_solver_configs``,
``far_forward``, ``mapfree_forward``, ``vitess_forward``,
``build_inference_fn``, ``init_model``): matcher -> RANSAC -> regressor
-> prior-biased RANSAC -> regressor for FAR and map-free 6DReg, matcher
-> RANSAC -> gated ViTEss for the 8-point ViT. The entry points run on
CUDA unless the caller asks for ``device="cpu"`` (there every kernel
wrapper runs its plain version); without a card and without that request
they raise.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from far_tpu_torch.models.constants import denormalize_9d
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
from far_tpu_torch.parallel.comm import local_device
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose
from far_tpu_torch.types import FarOutput, PairBatch, SolverSummary
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights


def make_solver_configs(cfg: FARConfig) -> Tuple[SolverConfig, SolverConfig]:
    """(first-round, refinement-round) solver configs; with
    solver='prior_ransac' the first round has no prior yet."""
    so = cfg.solver
    base = dict(
        num_hypotheses=so.num_hypotheses,
        minimal_solver=so.minimal_solver,
        pixel_thr=so.pixel_thr,
        prior_inl_th=so.prior_inl_th,
        prior_lambda=so.prior_lambda,
        bias_sigma_sq=so.bias_sigma_sq,
        scoring=so.scoring,
    )
    if so.solver == "prior_ransac":
        first = SolverConfig(solver="prior_ransac_noprior", **base)
        refine = SolverConfig(solver="prior_ransac", **{
            **base, "num_hypotheses": so.refine_num_hypotheses})
    elif so.solver == "prior_ransac_noprior":
        first = refine = SolverConfig(solver="prior_ransac_noprior", **base)
    else:
        first = refine = SolverConfig(solver="ransac", **base)
    return first, refine


def _summarize(est, num_before) -> SolverSummary:
    return SolverSummary(rt=est.rt34, num_before=num_before,
                         num_after=est.num_inliers, num_tight=est.num_tight,
                         num_ultra_tight=est.num_ultra_tight,
                         success=est.success)


def _device_of(model: FARLoFTR) -> torch.device:
    return next(model.parameters()).device


def far_forward(
    model: FARLoFTR,
    batch: PairBatch,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
) -> FarOutput:
    """Full FAR inference for a batch of pairs on the model's device.

    Round 0 solves without a prior; each of the config's
    ``fine_pred_steps - 1`` later rounds re-solves with the previous
    fused pose as a prior and re-fuses. With
    ``predict_translation_scale`` every round's t is scaled by the
    matcher's predicted scale.

    Args:
        generator: the RANSAC sampler's generator (on the model's device).
        uniforms: optional sampler draws in place of the generator's, one
            (B, n_samples, S) tensor per round: S = 5 and n_samples =
            max(H // 20, 1) for the 5-point solver, S = 8 and n_samples =
            H for the 8-point one, H the round's hypothesis budget
            (``RansacConfig.sampling``).
        prior_pcl: optional (P, 3) probe cloud of the prior rounds.
    """
    cfg = model.config
    device = _device_of(model)
    if batch.image0.device != device:
        raise ValueError(f"batch on {batch.image0.device}, model on {device}")
    steps = max(cfg.solver.fine_pred_steps, 1)
    if uniforms is not None and len(uniforms) != steps:
        raise ValueError(f"need {steps} uniform tensors, got {len(uniforms)}")
    first_cfg, refine_cfg = make_solver_configs(cfg)

    out = model.match(batch)
    m = out.matches
    num_before = m.valid.float().sum(-1)
    features = model.regress_features(out.feat_c0, out.feat_c1)

    prior_rt = None
    for i in range(steps):
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid,
            prior_rt=prior_rt, translation_scale=out.translation_scale,
            cfg=first_cfg if i == 0 else refine_cfg,
            prior_pcl=prior_pcl,
            uniforms=None if uniforms is None else uniforms[i],
            generator=generator)
        pose_9d, gate = model.regress_fuse(features, _summarize(est, num_before))
        prior_rt = denormalize_9d(pose_9d)

    return FarOutput(
        R=prior_rt[..., :3, :3], t=prior_rt[..., :3, 3], solver_rt=est.rt34,
        regressed_9d=pose_9d, prior_rt=prior_rt, matches=m,
        num_inliers=est.num_inliers, success=est.success, E=est.E,
        gating=gate, translation_scale=out.translation_scale)


def mapfree_forward(
    matcher: FARLoFTR,
    reg_model: MapfreeRegression,
    batch: PairBatch,
    image0_reg: torch.Tensor,
    image1_reg: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
    pixel_thr: float = 2.0,
    fine_pred_steps: int = 2,
):
    """Map-free FAR inference: matcher -> RANSAC -> 6DReg -> prior loop.

    Round 0 solves with plain RANSAC under MAGSAC scoring (the
    reference's cv2 USAC_MAGSAC); each later round with the prior-biased
    engine around the previous fused [R|t]. The regressor runs whole in
    every round, as the JAX package's does.

    Args:
        batch: the matcher-resolution grayscale pair with intrinsics.
        image0_reg/image1_reg: the regressor-resolution RGB pair
            (B, H, W, 3) in [0, 1].
        uniforms: optional sampler draws, one (B, H, 8) tensor per round
            (H: 2048 hypotheses in round 0, the refinement budget after).
    Returns:
        (R (B, 3, 3), t (B, 3), gate, the last round's PoseEstimate).
    """
    if uniforms is not None and len(uniforms) != fine_pred_steps:
        raise ValueError(f"need {fine_pred_steps} uniform tensors, got {len(uniforms)}")
    m = matcher.match(batch).matches
    first_cfg = SolverConfig(solver="ransac", pixel_thr=pixel_thr, scoring="magsac")
    refine_cfg = SolverConfig(solver="prior_ransac")
    prior_rt = R = t = gate = est = None
    for i in range(fine_pred_steps):
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid, prior_rt=prior_rt,
            cfg=first_cfg if i == 0 else refine_cfg, prior_pcl=prior_pcl,
            uniforms=None if uniforms is None else uniforms[i], generator=generator)
        counts = torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)
        R, t, _, gate = reg_model(image0_reg, image1_reg, est.rt34, counts)
        prior_rt = torch.cat([R, t[..., None]], -1)
    return R, t, gate, est


def vitess_forward(
    vitess_model: ViTEss,
    images: torch.Tensor,
    matcher: Optional[FARLoFTR] = None,
    matcher_batch: Optional[PairBatch] = None,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
):
    """8-point ViT inference, gated by the solver's pose when a matcher is
    given: matcher -> RANSAC (no prior, 2048 8-point hypotheses) ->
    ViTEss(images, [R|t], inlier count).

    Args:
        images: (B, 2, H, W, 3) RGB in [0, 1].
        uniforms: optional (B, 2048, 8) sampler draws for the solver.
    Returns:
        (t (B, 3), R (B, 3, 3), the normalized 9D pose, gate or None).
    """
    solver_pose = num_corr = None
    if matcher is not None:
        m = matcher.match(matcher_batch).matches
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, matcher_batch.K0, matcher_batch.K1, m.valid,
            cfg=SolverConfig(solver="prior_ransac_noprior"), uniforms=uniforms,
            generator=generator)
        solver_pose, num_corr = est.rt34, est.num_inliers
    return vitess_model(images, solver_pose, num_corr)


def build_inference_fn(model: FARLoFTR) -> Callable[..., FarOutput]:
    """(batch, generator=None, uniforms=None, prior_pcl=None) -> FarOutput,
    under ``torch.inference_mode``."""

    def fn(batch: PairBatch, generator=None, uniforms=None, prior_pcl=None):
        with torch.inference_mode():
            return far_forward(model, batch, generator, uniforms, prior_pcl)

    return fn


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise, and
    ``"cuda"`` this rank's card (``parallel.comm.local_device``)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: far_tpu_torch runs on the GPU; "
                           "pass device='cpu' for the plain CPU versions")
    return local_device(dev)


def init_model(cfg: Optional[FARConfig] = None, seed: int = 0,
               device=None) -> FARLoFTR:
    """The model with deterministic random weights (``init_weights``), in
    eval mode on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    model = FARLoFTR(cfg or FARConfig())
    init_weights(model, seed)
    return model.to(dev).eval()


def init_vitess(cfg: Optional[ViTEssConfig] = None, seed: int = 0,
                device=None) -> ViTEss:
    """ViTEss with ``init_weights(seed)``, in eval mode on ``device``."""
    dev = resolve_device(device)
    return init_weights(ViTEss(cfg or ViTEssConfig()), seed).to(dev).eval()


def init_sixdreg(cfg: Optional[SixDRegConfig] = None, seed: int = 0,
                 device=None) -> MapfreeRegression:
    """MapfreeRegression with ``init_weights(seed)``, in eval mode on
    ``device``."""
    dev = resolve_device(device)
    return init_weights(MapfreeRegression(cfg or SixDRegConfig()), seed).to(dev).eval()
