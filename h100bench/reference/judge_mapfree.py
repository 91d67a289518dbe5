"""The comparison that decides ``correct`` for map-free requests.

``judge`` reads what the program returned for a request (matches, fine
positions, the last solver round, the regressed pose before the blend, the
gate and the fused pose) and works each stage out again in float32 from
the same images, intrinsics, weights and sampler draws: the matcher with
``far.FarReference`` (``regress_rt`` off), the solver with the frozen
``solver/`` (8-point; MAGSAC scoring at 2 px in round 0, the prior-biased
engine in round 1), the regressor with ``sixdreg.SixDRegReference``:

- ``match_gap``, ``mconf_err``, ``fine_px``, ``fine_shift``,
  ``inlier_recount``: as ``judge.py`` reads them for FAR;
- ``solver_gap``: the widest relative gap between the program's inlier
  count and that of the reference's two rounds (with the reference's own
  blend between them) run on the program's correspondences with the same
  draws;
- ``reg_err``: over pairs, the widest gap of the program's regressed 9D
  pose (the pose MLP's output, before the blend) to the reference's, over
  the widest entry of the reference's: the ResUNet, the correlation volume,
  the head, the transformer and the pose MLP;
- ``gate_err``: the widest gap of the MoE gate to the reference's blend of
  its own features and pose with the program's solver pose and counts;
- ``r6_err``: the fused R against that blend's, seen in the blended 6D
  rows before Gram-Schmidt: each row of R apart from the reference's,
  times the length of the part of the rows it is normalised from (|a1|
  for the first row, the part of a2 across a1 for the second, the shorter
  of the two for the third), widest over rows and pairs, over the widest
  entry of the rows. To first order it is the rows' own gap, so a pair
  whose rows are nearly parallel (where Gram-Schmidt turns a small gap
  into a wide one) reads no wider than its rows are apart; it judges the
  rotation half of the blend and the 6D-to-matrix step.

  These three are read as a multiple of the same gap of the reference
  computed in bfloat16 (the precision the configuration states; every
  product's operands and layer outputs rounded, ``bf16``) on the same
  images with the program's solver pose and counts: the widest over the
  run of the program's gap over the widest of the bf16 reference's. How
  far a pose, a gate or a frame moves under rounding differs from one
  draw of weights to another by several times, for any precision; the
  multiple divides that out, so a sound bf16 program reads about 1
  whatever the draw;
- ``rt_err``, ``r_max``, ``t_max``: the fused [R | t] against that blend's
  (mean over pairs of the widest entry gap; R's and t's widest apart).

A cell compares the numbers its traffic file gives a limit; the others
are read. ``mapfree_forward`` runs the references as a program; the
control runs it through ``fp8``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Sequence

import torch

from h100bench.reference.far import FarReference, identity, ids_to_px
from h100bench.reference.judge import _finite, _fine_px, _pose_gap, matcher_numbers, recount
from h100bench.reference.sixdreg import SixDRegReference
from h100bench.reference.solver.pose_estimation import SolverConfig, estimate_pose
from h100bench.reference.solver.rotations import rotation_6d_to_matrix

NUMBERS = ("match_gap", "mconf_err", "fine_px", "fine_shift", "inlier_recount", "solver_gap",
           "reg_err", "gate_err", "r6_err", "rt_err", "r_max", "t_max")
# read over the bf16 reference's own gap (``merge``)
RELATIVE = ("reg_err", "gate_err", "r6_err")


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, returned in float32."""
    return x.to(torch.bfloat16).float()


def solver_configs():
    """(round 0, round 1) of the map-free loop: RANSAC at 2 px under MAGSAC
    scoring, then the prior-biased engine; 2048 8-point hypotheses each."""
    return (SolverConfig(solver="ransac", pixel_thr=2.0, scoring="magsac"),
            SolverConfig(solver="prior_ransac"))


def _counts(est):
    return torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)


@torch.no_grad()
def mapfree_forward(matcher: FarReference, reg: SixDRegReference, image0, image1, K0, K1,
                    image0_reg, image1_reg, uniforms: Sequence[torch.Tensor],
                    q=identity) -> SimpleNamespace:
    """The references as a program: matcher, regressor, solver rounds with
    the prior loop and the blend; products through ``q``, the solver's
    inputs too."""
    t0, t1, ff0, ff1 = matcher.coarse(image0, image1, q)
    i_ids, j_ids, mconf, valid = matcher.select(matcher.confidence(t0, t1, q))
    expec = matcher.fine(ff0, ff1, t0, t1, i_ids, j_ids, q)
    mk0 = ids_to_px(i_ids, matcher.s.coarse_hw[1], None) * valid[..., None]
    mk1 = _fine_px(matcher, expec, j_ids, valid)
    feats = reg.features(image0_reg, image1_reg, q)
    pred = reg.regress(feats, q)
    first, refine = solver_configs()
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = estimate_pose(mk0, mk1, K0, K1, valid, prior_rt=prior_rt,
                            cfg=first if i == 0 else refine, uniforms=u,
                            quant=None if q is identity else q)
        R, t, gate = reg.blend(feats, pred, est.rt34, _counts(est), q)
        prior_rt = torch.cat([R, t[..., None]], -1)
    return SimpleNamespace(
        i_ids=i_ids, j_ids=j_ids, mconf=mconf, valid=valid, mkpts0_f=mk0, mkpts1_f=mk1,
        E=est.E, num_inliers=est.num_inliers, solver_rt=est.rt34, regressed_9d=pred,
        gating=gate, R=R, t=t)


@torch.no_grad()
def judge(matcher: FarReference, reg: SixDRegReference, image0, image1, K0, K1, image0_reg,
          image1_reg, out, uniforms: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The numbers of one block of pairs (``out``: the program's output for
    them, with the fields of ``mapfree_forward``'s)."""
    match_gap, mconf_err, fine_px, fine_shift, _, _ = matcher_numbers(matcher, image0, image1,
                                                                      out)
    first, refine = solver_configs()
    thr = refine.prior_inl_th  # the last round's fixed threshold
    inlier_recount, count = recount(out, K0, K1, thr)
    feats = reg.features(image0_reg, image1_reg)
    pred = reg.regress(feats)
    kp0, kp1, valid = out.mkpts0_f.float(), out.mkpts1_f.float(), out.valid
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = estimate_pose(kp0, kp1, K0, K1, valid, prior_rt=prior_rt,
                            cfg=first if i == 0 else refine, uniforms=u)
        R, t, _ = reg.blend(feats, pred, est.rt34, _counts(est))
        prior_rt = torch.cat([R, t[..., None]], -1)
    solver_gap = float(((est.num_inliers - out.num_inliers.float()).abs()
                        / est.num_inliers.clamp(min=1.0)).amax())
    counts = torch.stack([out.num_inliers.float(), count(thr / 10.0), count(thr / 100.0)], -1)
    solver_rt = out.solver_rt.float()
    r6, t, gate = reg.blend6d(feats, pred, solver_rt, counts)
    R = rotation_6d_to_matrix(r6)
    rt_err, r_max, t_max = _pose_gap(out.R.float(), out.t.float(), R, t)

    def regressor_gaps(pred_x, gate_x, R_x, tag=""):
        gap = (pred_x.float() - pred).abs().amax(-1)
        return {"reg_err" + tag: float((gap / pred.abs().amax(-1).clamp(min=1e-30)).amax()),
                "gate_err" + tag: float((gate_x.float() - gate).abs().amax()),
                "r6_err" + tag: rows_gap(R_x.float(), r6, r6.abs().amax(-1))}

    feats16 = reg.features(image0_reg, image1_reg, bf16)
    pred16 = reg.regress(feats16, bf16)
    R16, _, gate16 = reg.blend(feats16, pred16, solver_rt, counts, bf16)
    return _finite(dict(match_gap=match_gap, mconf_err=mconf_err, fine_px=fine_px,
                        fine_shift=fine_shift, inlier_recount=inlier_recount,
                        solver_gap=solver_gap, rt_err=rt_err, r_max=r_max, t_max=t_max,
                        **regressor_gaps(out.regressed_9d, out.gating, out.R),
                        **regressor_gaps(pred16, gate16, R16, "_bf16")))


def rows_gap(R, r6, scale) -> float:
    """``r6_err``: the gap of R (B, 3, 3) to Gram-Schmidt's frame of the
    blended rows ``r6`` (B, 6), as a gap of those rows, over ``scale``
    (B,) (see the module's docstring)."""
    R_ref = rotation_6d_to_matrix(r6)
    a1, a2 = r6[..., :3], r6[..., 3:]
    b1 = R_ref[..., 0, :]
    n1 = a1.norm(dim=-1)
    n2 = (a2 - (a2 * b1).sum(-1, keepdim=True) * b1).norm(dim=-1)
    d = (R - R_ref).norm(dim=-1)  # (B, 3): each row's distance
    gap = torch.stack([n1 * d[:, 0], n2 * d[:, 1], torch.minimum(n1, n2) * d[:, 2]], -1)
    return float((gap.amax(-1) / scale.clamp(min=1e-30)).amax())


def merge(parts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The widest reading of each number over blocks; each of ``RELATIVE``
    over the widest of the bf16 reference's own."""
    nums = {k: max(p[k] for p in parts) for k in NUMBERS}
    for k in RELATIVE:
        nums[k] /= max(max(p[k + "_bf16"] for p in parts), 1e-30)
    return nums
