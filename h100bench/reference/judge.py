"""The comparison that decides ``correct`` for FAR requests.

``judge`` reads what the program returned for a request (matches, fine
positions, the last solver round, the gate and the fused pose) and works
each stage out again in float32 from the same images, intrinsics, weights
and sampler draws:

- ``match_gap``: how far, in log confidence, the program's least
  confident match lies below the K-th best match of the reference's own
  selection (0 where it is above);
- ``mconf_err``: the widest log-ratio of the program's match confidence to
  the reference's dual-softmax confidence at the same cells;
- ``fine_px``: the mean gap, in pixels, between the program's refined
  match in image 1 and the reference's refinement of the same coarse
  match; read but not compared: at random weights the refinement moves a
  match by about 0.1 px, the program's bf16 similarity keeps little of
  that, and offsets left at zero read as much as the program (PERF.md);
- ``fine_shift``: what offsets left at zero would read there, the mean
  distance the reference's refinement moves a match (read only);
- ``inlier_recount``: the widest gap between the program's inlier count and
  the inliers its own essential matrix has among its correspondences;
- ``solver_gap``: the widest relative gap between the program's inlier
  count and that of the reference's solver rounds (with its own fusion
  between them) run on the program's correspondences with the same draws;
- ``gate_err``: the widest gap of the MoE gate to the reference's fusion
  of its own features with the program's solver pose and counts;
- ``rt_err``: the mean over pairs of the widest entry gap of the fused
  [R | t] to that fusion's (the widest over pairs separated bf16 from
  the fp8 control by under 3x);
- ``r_max``, ``t_max``: the widest gap over pairs of R's entries and of
  t's, apart, to that fusion's, so that a fault in one pair is not
  averaged away.

A cell compares the numbers its traffic file gives a limit. The solver
is judged from the program's own state (its correspondences); the
matcher that produced that state is judged by itself against the
reference above.

``far_forward`` runs the reference as a program (round by round, its
solver included); the control runs it through ``fp8``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Sequence

import torch

from h100bench.reference.far import (
    FarReference,
    denormalize_9d,
    identity,
    ids_to_px,
    normalized_9d,
)
from h100bench.reference.solver.epipolar import sampson_epipolar_distance
from h100bench.reference.solver.pose_estimation import SolverConfig, estimate_pose
from h100bench.reference.solver.transforms import normalize_kpts_by_K

NUMBERS = ("match_gap", "mconf_err", "fine_px", "fine_shift", "inlier_recount", "solver_gap", "gate_err",
           "rt_err", "r_max", "t_max")


def solver_configs(solver: dict):
    """(first round, prior rounds) of FAR's prior_ransac loop."""
    base = dict(minimal_solver=solver.get("minimal_solver", "5pt"),
                pixel_thr=solver.get("pixel_thr", 0.5),
                prior_inl_th=solver.get("prior_inl_th", 3e-7),
                prior_lambda=solver.get("prior_lambda", 0.3),
                bias_sigma_sq=solver.get("bias_sigma_sq", 0.1))
    first = SolverConfig(solver="prior_ransac_noprior",
                         num_hypotheses=solver.get("num_hypotheses", 2048), **base)
    refine = SolverConfig(solver="prior_ransac",
                          num_hypotheses=solver.get("refine_num_hypotheses", 1024), **base)
    return first, refine


def _solver_in(rt, num_after, num_before, tight, ultra):
    return torch.cat([normalized_9d(rt), num_after[..., None] / 500.0,
                      num_before[..., None] / 500.0, tight[..., None] / 500.0,
                      ultra[..., None] / 500.0], -1)


def _fine_px(model: FarReference, expec, j_ids, valid):
    s = model.s
    coarse = ids_to_px(j_ids, s.coarse_hw[1], None) * valid[..., None]
    px = coarse + expec * (s.window // 2) * 2.0
    return torch.where(valid[..., None], px, coarse)


@torch.no_grad()
def far_forward(model: FarReference, image0, image1, K0, K1, uniforms: Sequence[torch.Tensor],
                solver: dict, q=identity) -> SimpleNamespace:
    """The reference as a program: matcher, solver rounds with the prior
    loop, MoE fusion; products through ``q``, the solver's inputs too."""
    t0, t1, ff0, ff1 = model.coarse(image0, image1, q)
    i_ids, j_ids, mconf, valid = model.select(model.confidence(t0, t1, q))
    expec = model.fine(ff0, ff1, t0, t1, i_ids, j_ids, q)
    mk0 = ids_to_px(i_ids, model.s.coarse_hw[1], None) * valid[..., None]
    mk1 = _fine_px(model, expec, j_ids, valid)
    feats = model.loftr_regress.features(t0, t1, q)
    first, refine = solver_configs(solver)
    num_before = valid.float().sum(-1)
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = estimate_pose(mk0, mk1, K0, K1, valid, prior_rt=prior_rt,
                            cfg=first if i == 0 else refine, uniforms=u,
                            quant=None if q is identity else q)
        pose9, gate = model.loftr_regress.fuse(
            feats, _solver_in(est.rt34, est.num_inliers, num_before, est.num_tight,
                              est.num_ultra_tight), q)
        prior_rt = denormalize_9d(pose9)
    return SimpleNamespace(
        i_ids=i_ids, j_ids=j_ids, mconf=mconf, valid=valid, mkpts0_f=mk0, mkpts1_f=mk1,
        E=est.E, num_inliers=est.num_inliers, solver_rt=est.rt34,
        gating=gate, R=prior_rt[..., :3], t=prior_rt[..., 3])


def matcher_numbers(model: FarReference, image0, image1, out):
    """(match_gap, mconf_err, fine_px, fine_shift, t0, t1) of the program's
    matches."""
    s = model.s
    B = image0.shape[0]
    t0, t1, ff0, ff1 = model.coarse(image0, image1)
    conf = model.confidence(t0, t1)
    _, _, ref_mconf, ref_valid = model.select(conf)
    kth = torch.where(ref_valid[:, -1], ref_mconf[:, -1],
                      torch.full_like(ref_mconf[:, -1], s.thr))
    valid = out.valid
    bidx = torch.arange(B, device=conf.device)[:, None]
    at = conf[bidx, out.i_ids, out.j_ids].clamp(min=1e-30)
    del conf
    gap = (kth.log()[:, None] - at.log()).clamp(min=0.0)
    match_gap = float(torch.where(valid, gap, 0.0).amax())
    mconf_err = float(torch.where(valid, (out.mconf.float().clamp(min=1e-30).log()
                                          - at.log()).abs(), 0.0).amax())
    expec = model.fine(ff0, ff1, t0, t1, out.i_ids, out.j_ids)
    ref_px = _fine_px(model, expec, out.j_ids, valid)
    gap = (out.mkpts1_f - ref_px).abs().amax(-1)[valid]
    shift = (expec.abs().amax(-1) * (s.window // 2) * 2.0)[valid]
    fine_px = float(gap.mean()) if gap.numel() else 0.0
    fine_shift = float(shift.mean()) if shift.numel() else 0.0
    return match_gap, mconf_err, fine_px, fine_shift, t0, t1


def recount(out, K0, K1, thr: float):
    """(the widest gap of the program's inlier count to the inliers of its
    own E among its correspondences, the count at a threshold)."""
    kp0n = normalize_kpts_by_K(out.mkpts0_f.double(), K0.double())
    kp1n = normalize_kpts_by_K(out.mkpts1_f.double(), K1.double())
    err = sampson_epipolar_distance(kp0n, kp1n, out.E.double())

    def count(t):
        return ((err <= t) & out.valid).double().sum(-1).float()

    return float((count(thr) - out.num_inliers.float()).abs().amax()), count


def _pose_gap(R, t, R_ref, t_ref):
    """(mean over pairs of the widest entry gap of [R | t] to the
    reference's, the widest gap of R's entries over pairs, that of t's)."""
    r = (R - R_ref).abs().flatten(1).amax(1)
    tt = (t - t_ref).abs().amax(1)
    return float(torch.maximum(r, tt).mean()), float(r.amax()), float(tt.amax())


def _finite(nums: Dict[str, float]) -> Dict[str, float]:
    return {k: (v if math.isfinite(v) else math.inf) for k, v in nums.items()}


@torch.no_grad()
def judge(model: FarReference, image0, image1, K0, K1, out,
          uniforms: Sequence[torch.Tensor], solver: dict) -> Dict[str, float]:
    """The numbers of one block of pairs (``out``: the program's output for
    them, with the fields of ``far_forward``'s)."""
    match_gap, mconf_err, fine_px, fine_shift, t0, t1 = matcher_numbers(model, image0, image1,
                                                                        out)
    valid = out.valid
    first, refine = solver_configs(solver)
    thr = refine.prior_inl_th
    inlier_recount, count = recount(out, K0, K1, thr)
    feats = model.loftr_regress.features(t0, t1)
    kp0, kp1 = out.mkpts0_f.float(), out.mkpts1_f.float()
    num_before = valid.float().sum(-1)
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = estimate_pose(kp0, kp1, K0, K1, valid, prior_rt=prior_rt,
                            cfg=first if i == 0 else refine, uniforms=u)
        pose9, _ = model.loftr_regress.fuse(feats, _solver_in(
            est.rt34, est.num_inliers, num_before, est.num_tight, est.num_ultra_tight))
        prior_rt = denormalize_9d(pose9)
    solver_gap = float(((est.num_inliers - out.num_inliers.float()).abs()
                        / est.num_inliers.clamp(min=1.0)).amax())
    pose9, gate = model.loftr_regress.fuse(feats, _solver_in(
        out.solver_rt.float(), out.num_inliers.float(), num_before,
        count(thr / 10.0), count(thr / 100.0)))
    rt = denormalize_9d(pose9)
    gate_err = float((out.gating.float() - gate).abs().amax())
    rt_err, r_max, t_max = _pose_gap(out.R.float(), out.t.float(), rt[..., :3], rt[..., 3])
    return _finite(dict(match_gap=match_gap, mconf_err=mconf_err, fine_px=fine_px,
                        fine_shift=fine_shift, inlier_recount=inlier_recount, solver_gap=solver_gap,
                        gate_err=gate_err, rt_err=rt_err, r_max=r_max, t_max=t_max))


def merge(parts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The widest reading of each number over blocks."""
    return {k: max(p[k] for p in parts) for k in NUMBERS}
