"""The comparison that decides ``correct`` for map-free requests whose
matcher is SuperPoint + SuperGlue.

``judge`` reads what the program returned for a request (both images'
keypoints, scores, validity and descriptors, the matches and their
assignment, the last solver round, the regressed pose before the blend,
the gate and the fused pose) and works each stage out again in float32
from the same images, intrinsics, weights and sampler draws: the matcher
with ``superglue.SuperPointSuperGlueReference``, the solver with the
frozen ``solver/`` (as ``judge_mapfree.py``), the regressor with
``sixdreg.SixDRegReference``:

- ``kpt_gap``: how far, in log score, the program's least-scored kept
  keypoint lies below the K-th best of the reference's own detections
  (the threshold where fewer pass it), read in the reference's heat
  before NMS at the program's pixel (0 where it is above): a keypoint
  the reference would not keep reads as far below as its heat is;
- ``desc_err``: the widest distance of the program's unit descriptors to
  the reference's at the program's keypoints;
- ``assign_err``: the widest |log| ratio of the program's assignment at
  its selected matches to the reference's at the same slots, the
  reference's GNN and Sinkhorn run on the program's keypoints and
  validity with its own scores and descriptors there;
- ``select_gap``: the selection, in log assignment on that same
  reference assignment P (its inner block): at each of the program's
  matches (i, j), how far P[i, j] lies below row i's maximum, column j's
  maximum or the threshold; at each of the reference's own mutual
  matches over the threshold that the program did not make, by how much
  it wins (its log over the larger of its row's and its column's
  runner-up and the threshold). 0 where the program's matches are the
  reference's mutual argmax; a pick or a miss within a near tie reads as
  narrow as the tie;
- ``corr_gap``: the widest pixel gap of the correspondences the solver
  is given (``mkpts0_f``, ``mkpts1_f``) to the program's own keypoints at
  its matches (``kpts0``, ``kpts1[matches0]``, zero where ``matches0`` is
  -1), plus the number of slots whose ``valid`` is not ``matches0 >=
  0``: exact, so 0;
- ``inlier_recount``, ``solver_gap``, ``reg_err``, ``gate_err``,
  ``r6_err``, ``rt_err``, ``r_max``, ``t_max``: as ``judge_mapfree.py``
  reads them.

``reg_err``, ``gate_err`` and ``r6_err`` are read as multiples of the
bfloat16 reference's own gap on the same images, solver pose and counts
(``RELATIVE``), as ``judge_mapfree.py`` reads them. ``desc_err`` and
``assign_err`` are also worked out for the bfloat16 reference (the
matcher's products and layer outputs rounded, ``judge_mapfree.bf16``) on
the program's keypoints, and read as ``desc_err_bf16`` and
``assign_err_bf16`` beside them. A cell compares the numbers its traffic
file gives a limit; the others are read. ``mapfree_forward`` runs the
references as a program; the control runs it through ``fp8``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Sequence

import torch

from h100bench.reference.far import identity
from h100bench.reference.judge import _finite, _pose_gap, recount
from h100bench.reference.judge_mapfree import _counts, bf16, rows_gap, solver_configs
from h100bench.reference.sixdreg import SixDRegReference
from h100bench.reference.solver.pose_estimation import estimate_pose
from h100bench.reference.solver.rotations import rotation_6d_to_matrix
from h100bench.reference.superglue import (
    SuperPointSuperGlueReference,
    heat_at,
    sample_descriptors,
)

NUMBERS = ("kpt_gap", "desc_err", "desc_err_bf16", "assign_err", "assign_err_bf16",
           "select_gap", "corr_gap", "inlier_recount", "solver_gap", "reg_err", "gate_err",
           "r6_err", "rt_err", "r_max", "t_max")
# read over the bf16 reference's own gap (``merge``)
RELATIVE = ("reg_err", "gate_err", "r6_err")


def _correspondences(ref: SuperPointSuperGlueReference, image0, image1, q):
    """The reference matcher as a program: detections, matches and the
    padded correspondences."""
    k0, s0, v0, d0 = ref.superpoint.detect(image0, q)
    k1, s1, v1, d1 = ref.superpoint.detect(image1, q)
    sg = ref.superglue
    m0, mconf = sg.select(sg.assignment(sg.scores(k0, s0, v0, d0, k1, s1, v1, d1, q), v0, v1),
                          v0)
    ok = m0 >= 0
    pts1 = k1.gather(1, m0.clamp(min=0)[..., None].expand(-1, -1, 2))
    return dict(kpts0=k0, kpts1=k1, scores0=s0, scores1=s1, kvalid0=v0, kvalid1=v1, desc0=d0,
                desc1=d1, matches0=m0, mconf=mconf, valid=ok, mkpts0_f=k0 * ok[..., None],
                mkpts1_f=pts1 * ok[..., None])


@torch.no_grad()
def mapfree_forward(ref: SuperPointSuperGlueReference, reg: SixDRegReference, image0, image1,
                    K0, K1, image0_reg, image1_reg, uniforms: Sequence[torch.Tensor],
                    q=identity) -> SimpleNamespace:
    """The references as a program: matcher, regressor, solver rounds with
    the prior loop and the blend; products through ``q``, the solver's
    inputs too."""
    m = _correspondences(ref, image0, image1, q)
    feats = reg.features(image0_reg, image1_reg, q)
    pred = reg.regress(feats, q)
    first, refine = solver_configs()
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = estimate_pose(m["mkpts0_f"], m["mkpts1_f"], K0, K1, m["valid"], prior_rt=prior_rt,
                            cfg=first if i == 0 else refine, uniforms=u,
                            quant=None if q is identity else q)
        R, t, gate = reg.blend(feats, pred, est.rt34, _counts(est), q)
        prior_rt = torch.cat([R, t[..., None]], -1)
    return SimpleNamespace(**m, E=est.E, num_inliers=est.num_inliers, solver_rt=est.rt34,
                           regressed_9d=pred, gating=gate, R=R, t=t)


def _side(ref: SuperPointSuperGlueReference, image, kpts, q):
    """The reference's heat before NMS and unit descriptors at the
    program's keypoints, and its whole heat."""
    heat, dmap = ref.superpoint.dense(image, q)
    return heat_at(heat, kpts), sample_descriptors(kpts, dmap), heat


def _kth(ref: SuperPointSuperGlueReference, heat):
    """The reference's own K-th best NMS'd score (B,), the threshold
    where fewer pass it."""
    s = ref.s
    kth = ref.superpoint.nms_heat(heat).flatten(1).topk(s.max_keypoints).values[:, -1]
    return kth.clamp(min=s.keypoint_threshold)


def _assignment(ref: SuperPointSuperGlueReference, out, sides, q):
    """The reference's assignment (B, K, K) on the program's keypoints and
    validity, its scores and descriptors there."""
    (h0, d0, _), (h1, d1, _) = sides
    sg = ref.superglue
    k0, k1 = out.kpts0.float(), out.kpts1.float()
    return sg.assignment(sg.scores(k0, h0, out.kvalid0, d0, k1, h1, out.kvalid1, d1, q),
                         out.kvalid0, out.kvalid1)


def _at_matches(P, out):
    """``P`` at the program's selected matches (B, K); 1 where no match was
    made."""
    at = P.gather(2, out.matches0.long().clamp(min=0)[..., None])[..., 0]
    return torch.where(out.valid, at, 1.0)


def select_gap(ref: SuperPointSuperGlueReference, P, out) -> float:
    """How far the program's matches lie from the reference's mutual
    argmax over the threshold on ``P``, in log (see the module's
    docstring)."""
    L = P.clamp(min=1e-30).log()
    thr = math.log(ref.s.match_threshold)
    m0 = out.matches0.long()
    made = m0 >= 0
    j = m0.clamp(min=0)
    at = L.gather(2, j[..., None])[..., 0]
    worst = torch.maximum(L.amax(2), L.amax(1).gather(1, j)).clamp(min=thr)
    picked = torch.where(made, worst - at, 0.0)
    r0, _ = ref.superglue.select(P, out.kvalid0)
    r = r0.clamp(min=0)
    row, col = L.topk(2, dim=2).values, L.topk(2, dim=1).values
    beat = torch.maximum(row[..., 1], col[:, 1].gather(1, r)).clamp(min=thr)
    missed = torch.where((r0 >= 0) & (m0 != r0), row[..., 0] - beat, 0.0)
    return float(torch.maximum(picked, missed).amax())


def corr_gap(out) -> float:
    """The correspondences against the program's keypoints at its matches
    (see the module's docstring)."""
    m0 = out.matches0.long()
    ok = m0 >= 0
    k0, k1 = out.kpts0.float(), out.kpts1.float()
    want1 = k1.gather(1, m0.clamp(min=0)[..., None].expand(-1, -1, 2))
    gap = max(float((out.mkpts0_f.float() - k0 * ok[..., None]).abs().amax()),
              float((out.mkpts1_f.float() - want1 * ok[..., None]).abs().amax()))
    return gap + float((out.valid != ok).sum())


def matcher_numbers(ref: SuperPointSuperGlueReference, image0, image1, out) -> Dict[str, float]:
    """``kpt_gap``, ``desc_err``, ``assign_err``, ``select_gap``,
    ``corr_gap``, and ``desc_err`` and ``assign_err`` for the bf16
    reference."""
    images, kvalid = (image0, image1), (out.kvalid0, out.kvalid1)
    kpts, desc = (out.kpts0.float(), out.kpts1.float()), (out.desc0, out.desc1)
    sides = [_side(ref, im, k, identity) for im, k in zip(images, kpts)]
    sides16 = [_side(ref, im, k, bf16) for im, k in zip(images, kpts)]
    gap = max(float(torch.where(v, (_kth(ref, heat).log()[:, None]
                                    - h.clamp(min=1e-30).log()).clamp(min=0), 0.0).amax())
              for (h, _, heat), v in zip(sides, kvalid))

    def desc_gap(others):
        return max(float(torch.where(v, (o.float() - d).norm(dim=-1), 0.0).amax())
                   for (_, d, _), o, v in zip(sides, others, kvalid))

    P = _assignment(ref, out, sides, identity)
    logP = _at_matches(P, out).clamp(min=1e-30).log()
    ratio = lambda a: float((a.clamp(min=1e-30).log() - logP).abs().amax())
    return dict(kpt_gap=gap, desc_err=desc_gap(desc),
                desc_err_bf16=desc_gap([d16 for _, d16, _ in sides16]),
                assign_err=ratio(torch.where(out.valid, out.mconf.float(), 1.0)),
                assign_err_bf16=ratio(_at_matches(_assignment(ref, out, sides16, bf16), out)),
                select_gap=select_gap(ref, P, out), corr_gap=corr_gap(out))


def pose_numbers(reg: SixDRegReference, K0, K1, image0_reg, image1_reg, out,
                 uniforms: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The solver's and the regressor's numbers, as ``judge_mapfree.judge``
    reads them, on the program's correspondences."""
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
    rt_err, r_max, t_max = _pose_gap(out.R.float(), out.t.float(), rotation_6d_to_matrix(r6), t)

    def regressor_gaps(pred_x, gate_x, R_x, tag=""):
        gap = (pred_x.float() - pred).abs().amax(-1)
        return {"reg_err" + tag: float((gap / pred.abs().amax(-1).clamp(min=1e-30)).amax()),
                "gate_err" + tag: float((gate_x.float() - gate).abs().amax()),
                "r6_err" + tag: rows_gap(R_x.float(), r6, r6.abs().amax(-1))}

    feats16 = reg.features(image0_reg, image1_reg, bf16)
    pred16 = reg.regress(feats16, bf16)
    R16, _, gate16 = reg.blend(feats16, pred16, solver_rt, counts, bf16)
    return dict(inlier_recount=inlier_recount, solver_gap=solver_gap, rt_err=rt_err,
                r_max=r_max, t_max=t_max, **regressor_gaps(out.regressed_9d, out.gating, out.R),
                **regressor_gaps(pred16, gate16, R16, "_bf16"))


@torch.no_grad()
def judge(ref: SuperPointSuperGlueReference, reg: SixDRegReference, image0, image1, K0, K1,
          image0_reg, image1_reg, out, uniforms: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The numbers of one block of pairs (``out``: the program's output for
    them, with the fields of ``mapfree_forward``'s)."""
    return _finite({**matcher_numbers(ref, image0, image1, out),
                    **pose_numbers(reg, K0, K1, image0_reg, image1_reg, out, uniforms)})


def merge(parts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The widest reading of each number over blocks; each of ``RELATIVE``
    over the widest of the bf16 reference's own."""
    nums = {k: max(p[k] for p in parts) for k in NUMBERS}
    for k in RELATIVE:
        nums[k] /= max(max(p[k + "_bf16"] for p in parts), 1e-30)
    return nums
