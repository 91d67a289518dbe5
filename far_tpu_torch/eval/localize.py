"""Multi-reference absolute-pose localization (visloc-relapose eval).

Counterpart of ``far_tpu/eval/localize.py``, a numpy copy with the same
``__all__``. A query image is localized against the k reference
("train") images a retrieval stage paired it with: the network predicts
a relative pose (or an essential matrix) per pair, every 2-pair
combination triangulates an absolute-position hypothesis, and a RANSAC
with local optimisation picks the hypothesis most pairs agree with.  The
module also carries the no-RANSAC aggregation (geometric-median position
+ rotation averaging) and the precision/recall machinery used for both.

Reference: mapfree_6dreg/lib/utils/localize.py:1-1020 (vendored from
visloc-relapose), redesigned as the JAX package's copy is: per-query pair
sets are structure-of-arrays, all H = C(k,2) RANSAC hypotheses are
scored in one broadcast [H, k] pass instead of the reference's
per-hypothesis/per-pair/per-sign Python loops; local optimisation then
replays the reference's scan exactly, but only over the few hypotheses
whose precomputed inlier count beats the running best (identical final
model, a fraction of the model evaluations).  Rotation averaging is the
Markley quaternion eigen-mean, the closed form
of the reference's iterative ``scipy Rotation.mean()`` (localize.py:397).

Everything here runs on the host in float64 numpy: it aggregates a
handful of poses per query after the batched pipeline on the card has
produced them. ``generate_precision_recall_plots`` imports matplotlib
where it draws.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

__all__ = [
    "AbsPose", "RelaPose", "RelaPosePair", "EssPair",
    "vec_angle_error", "quat_angle_error",
    "quats_to_matrices", "matrices_to_quats", "average_quaternions",
    "geometric_median",
    "triangulate_views", "compose_projection_matrix",
    "hat", "project_onto_essential_space", "essential_matrix_from_pose",
    "decompose_essential_matrix",
    "find_inliers", "estimate_model", "local_optimisation", "ransac",
    "precision_recall", "precision_recall_pose_error",
    "precision_recall_repr_error",
    "cal_rela_pose_err", "cal_abs_pose_err_metric", "cal_abs_pose_err",
    "eval_pipeline_with_ransac", "eval_pipeline_without_ransac",
    "save_results_visualisation", "generate_precision_recall_plots",
]


# --------------------------------------------------------------------- #
# angle errors (reference localize.py:14-48 conventions)
# --------------------------------------------------------------------- #

def vec_angle_error(label: np.ndarray, pred: np.ndarray,
                    decimals: int = 4) -> np.ndarray:
    """Angle (degrees) between vectors, batched over leading axes.

    Keeps the reference's convention (localize.py:14-32) of rounding the
    cosine to 4 decimals before arccos (guaranteeing |d| <= 1) and
    mapping zero-vector NaNs to 0 error.
    """
    label = np.atleast_2d(np.asarray(label, np.float64))
    pred = np.atleast_2d(np.asarray(pred, np.float64))
    v1 = pred / np.linalg.norm(pred, axis=-1, keepdims=True)
    v2 = label / np.linalg.norm(label, axis=-1, keepdims=True)
    d = np.around(np.sum(v1 * v2, axis=-1, keepdims=True), decimals=decimals)
    err = np.degrees(np.arccos(np.clip(d, -1.0, 1.0)))
    return np.where(np.isnan(err), 0.0, err)


def quat_angle_error(label: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """2*acos(|<q1,q2>|) in degrees, batched (localize.py:35-48)."""
    label = np.atleast_2d(np.asarray(label, np.float64))
    pred = np.atleast_2d(np.asarray(pred, np.float64))
    q1 = pred / np.linalg.norm(pred, axis=-1, keepdims=True)
    q2 = label / np.linalg.norm(label, axis=-1, keepdims=True)
    d = np.clip(np.abs(np.sum(q1 * q2, axis=-1, keepdims=True)), -1.0, 1.0)
    return 2.0 * np.degrees(np.arccos(d))


def _sc(x) -> float:
    """Single-element array -> python float."""
    return float(np.asarray(x).ravel()[0])


# --------------------------------------------------------------------- #
# batched quaternion <-> matrix (w, x, y, z; w >= 0 like transforms3d)
# --------------------------------------------------------------------- #

def quats_to_matrices(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def matrices_to_quats(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0 (transforms3d sign
    convention, which the reference's plain-mean quaternion averaging
    depends on)."""
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    t = np.einsum("...ii->...", m)
    # four Shepperd candidates; pick the numerically largest pivot
    cand = np.stack([
        1.0 + t,
        1.0 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
        1.0 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
        1.0 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2],
    ], axis=-1)
    best = np.argmax(cand, axis=-1)
    q = np.empty((m.shape[0], 4), np.float64)
    for i, b in enumerate(best):
        s = 2.0 * np.sqrt(max(cand[i, b], 1e-12))
        a = m[i]
        if b == 0:
            q[i] = [0.25 * s, (a[2, 1] - a[1, 2]) / s,
                    (a[0, 2] - a[2, 0]) / s, (a[1, 0] - a[0, 1]) / s]
        elif b == 1:
            q[i] = [(a[2, 1] - a[1, 2]) / s, 0.25 * s,
                    (a[0, 1] + a[1, 0]) / s, (a[0, 2] + a[2, 0]) / s]
        elif b == 2:
            q[i] = [(a[0, 2] - a[2, 0]) / s, (a[0, 1] + a[1, 0]) / s,
                    0.25 * s, (a[1, 2] + a[2, 1]) / s]
        else:
            q[i] = [(a[1, 0] - a[0, 1]) / s, (a[0, 2] + a[2, 0]) / s,
                    (a[1, 2] + a[2, 1]) / s, 0.25 * s]
    q = np.where(q[:, :1] < 0, -q, q)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.reshape(R.shape[:-2] + (4,))


def average_quaternions(qs: np.ndarray) -> np.ndarray:
    """L2 chordal rotation mean of (N, 4) quaternions (Markley et al.):
    the principal eigenvector of sum(q q^T).  Closed form of the
    reference's ``Rotation.from_matrix(...).mean()`` (localize.py:395-398);
    sign-invariant because q enters quadratically."""
    qs = np.asarray(qs, np.float64)
    qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    M = np.einsum("ni,nj->ij", qs, qs)
    _w, v = np.linalg.eigh(M)
    q = v[:, -1]
    return q if q[0] >= 0 else -q


def geometric_median(X: np.ndarray, eps: float = 1e-5,
                     axis: int = 0) -> np.ndarray:
    """Weiszfeld geometric median of (N, D) points, returned as (1, D)
    (reference localize.py:228-254, including the Vardi-Zhang update for
    iterates that land on a sample point)."""
    X = np.asarray(X, np.float64)
    y = X.mean(axis=0)
    while True:
        D = np.linalg.norm(X - y, axis=1)
        nonzero = D > 0
        if not nonzero.any():
            return y.reshape(1, -1)
        Dinv = 1.0 / D[nonzero]
        W = Dinv / Dinv.sum()
        T = (W[:, None] * X[nonzero]).sum(axis=0)
        num_zeros = len(X) - int(nonzero.sum())
        if num_zeros == 0:
            y1 = T
        else:
            Rv = (T - y) * Dinv.sum()
            r = np.linalg.norm(Rv)
            rinv = 0.0 if r == 0 else num_zeros / r
            y1 = max(0.0, 1.0 - rinv) * T + min(1.0, rinv) * y
        if np.linalg.norm(y - y1) < eps:
            return y1.reshape(1, -1)
        y = y1


# --------------------------------------------------------------------- #
# epipolar pieces (reference localize.py:763-889)
# --------------------------------------------------------------------- #

def compose_projection_matrix(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """[R|t], (..., 3, 4)."""
    return np.concatenate([R, np.asarray(t)[..., None]], axis=-1)


def triangulate_views(x: np.ndarray, P: np.ndarray) -> np.ndarray:
    """DLT triangulation, batched over hypotheses.

    Args:
        x: (..., V, 2) image points in V views.
        P: (..., V, 3, 4) projection matrices.
    Returns the (..., 3) triangulated points.  Generalizes the
    reference's triangulate_two_views/triangulate_multi_views
    (localize.py:763-806): each view contributes the two DLT rows
    ``x*P[2] - P[0]`` and ``y*P[2] - P[1]``; the point is the null
    vector of the stacked system.
    """
    x = np.asarray(x, np.float64)
    P = np.asarray(P, np.float64)
    rows = x[..., :, :, None] * P[..., :, 2:3, :] - P[..., :, :2, :]
    A = rows.reshape(x.shape[:-2] + (2 * x.shape[-2], 4))
    _u, _s, vh = np.linalg.svd(A)
    X = vh[..., -1, :]
    return X[..., :3] / X[..., 3:]


def hat(vec: np.ndarray) -> np.ndarray:
    """Skew operator, (..., 3) -> (..., 3, 3)."""
    v = np.asarray(vec, np.float64)
    z = np.zeros_like(v[..., 0])
    return np.stack([
        np.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        np.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        np.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ], axis=-2)


def project_onto_essential_space(F: np.ndarray) -> np.ndarray:
    """Nearest essential matrix (localize.py:832-837)."""
    u, s, vh = np.linalg.svd(np.asarray(F, np.float64))
    a = (s[..., 0] + s[..., 1]) / 2.0
    s_ = np.stack([a, a, np.zeros_like(a)], axis=-1)
    return u @ (s_[..., :, None] * vh)


def essential_matrix_from_pose(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """E = [t]_x R with unit t (localize.py:840-851)."""
    t = np.asarray(t, np.float64)
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    return (hat(t) @ np.asarray(R, np.float64)).astype(np.float32)


def decompose_essential_matrix(
        E: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t, R1, R2) candidates, OpenCV sign conventions
    (localize.py:872-889)."""
    u, _s, vh = np.linalg.svd(np.asarray(E, np.float64))
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vh) < 0:
        vh = -vh
    w = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return u[:, 2], u @ w @ vh, u @ w.T @ vh


# --------------------------------------------------------------------- #
# pose / pair containers (reference localize.py:896-1020)
# --------------------------------------------------------------------- #

@dataclass
class AbsPose:
    """Absolute camera pose: q (4,) wxyz orientation, c (3,) position.
    Derived: r rotation, t = -r c, p = [r|t] (localize.py:896-918)."""

    q: np.ndarray
    c: np.ndarray
    r: np.ndarray = field(init=False)
    t: np.ndarray = field(init=False)
    p: np.ndarray = field(init=False)

    def __post_init__(self):
        self.q = np.asarray(self.q, np.float64).reshape(4)
        self.c = np.asarray(self.c, np.float64).reshape(3)
        self.r = quats_to_matrices(self.q)
        self.t = -self.r @ self.c
        self.p = compose_projection_matrix(self.r, self.t)


@dataclass
class RelaPose:
    """Relative pose: q (4,) wxyz, t (3,) (localize.py:921-936)."""

    q: np.ndarray
    t: np.ndarray
    r: np.ndarray = field(init=False)

    def __post_init__(self):
        self.q = np.asarray(self.q, np.float64).reshape(4)
        self.t = np.asarray(self.t, np.float64).reshape(3)
        self.r = quats_to_matrices(self.q)


class RelaPosePair:
    """One (query, reference) pair for relative-pose regression models
    (localize.py:939-964): caches the epipole x_te of the query in the
    reference view and the implied absolute pose of the query."""

    def __init__(self, test_im: str, train_abs_pose: AbsPose,
                 rela_pose_lbl: RelaPose, rela_pose_pred: RelaPose,
                 sim: float = 0.0, inliers: float = 0.0):
        self.test_im = test_im
        self.train_abs_pose = train_abs_pose
        self.rela_pose_lbl = rela_pose_lbl
        self.rela_pose_pred = rela_pose_pred
        x_te = -rela_pose_pred.r.T @ rela_pose_pred.t
        self.x_te = x_te[:2] / (x_te[2] if x_te[2] != 0 else 1.0)
        self.abs_r_pred = rela_pose_pred.r @ train_abs_pose.r
        self.abs_q_pred = matrices_to_quats(self.abs_r_pred)
        self.abs_c_pred = (train_abs_pose.c
                           - train_abs_pose.r.T @ rela_pose_pred.r.T
                           @ rela_pose_pred.t)
        self.sim = sim
        self.inliers = inliers  # correspondence-count confidence


class EssPair:
    """One (query, reference) pair for essential-matrix models
    (localize.py:967-1020): both rotation candidates are kept; RANSAC
    resolves the rotation index (rid) and the translation sign."""

    def __init__(self, test_im: str, train_im: str,
                 train_abs_pose: AbsPose, rela_pose_lbl: RelaPose,
                 t: np.ndarray, R0: np.ndarray, R1: np.ndarray,
                 inliers: float = 0.0):
        self.test_im = test_im
        self.train_im = train_im
        self.train_abs_pose = train_abs_pose
        self.rela_pose_lbl = rela_pose_lbl
        self.rela_pose_pred = None
        self.t = np.asarray(t, np.float64).reshape(3)
        self.R = np.stack([R0, R1]).astype(np.float64)
        self.abs_r_pred = self.R @ train_abs_pose.r  # r_query = R r_ref
        self.abs_q_pred = matrices_to_quats(self.abs_r_pred)
        x = -np.einsum("cij,j->ci", np.transpose(self.R, (0, 2, 1)), self.t)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.x_te = np.where(x[:, 2:] == 0, np.inf, x[:, :2] / x[:, 2:])
        self.rid = 0
        self.inliers = inliers

    def set_rid(self, rid: int):
        self.rid = int(rid)

    def set_opposite_trans_pred(self):
        self.t = -self.t

    def get_rela_q(self) -> np.ndarray:
        return matrices_to_quats(self.R[self.rid])

    def is_invalid(self) -> bool:
        return bool(np.any(np.isinf(self.x_te)))


class _PairArrays:
    """Structure-of-arrays view of one query's pair list — the form the
    broadcast RANSAC scoring operates on."""

    def __init__(self, pairs: Sequence, pair_type: str):
        self.pair_type = pair_type
        self.k = len(pairs)
        self.Rtr = np.stack([p.train_abs_pose.r for p in pairs])
        self.ctr = np.stack([p.train_abs_pose.c for p in pairs])
        self.Ptr = np.stack([p.train_abs_pose.p for p in pairs])
        if pair_type == "ess":
            self.qcand = np.stack([p.abs_q_pred for p in pairs])  # (k,2,4)
            self.Rcand = np.stack([p.R for p in pairs])           # (k,2,3,3)
            self.t = np.stack([p.t for p in pairs])               # (k,3)
            self.xte = np.stack([p.x_te for p in pairs])          # (k,2,2)
        else:
            self.qabs = np.stack([p.abs_q_pred for p in pairs])   # (k,4)
            self.Rrel = np.stack([p.rela_pose_pred.r for p in pairs])
            self.trel = np.stack([p.rela_pose_pred.t for p in pairs])
            self.xte = np.stack([p.x_te for p in pairs])          # (k,2)


def _angles_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle (deg) between broadcastable stacks of 3-vectors, with the
    reference's 4-decimal rounding.  Degenerate inputs (zero-length or
    non-finite vectors) score +inf, i.e. outlier: the reference's
    find_inliers runs with RuntimeWarnings promoted to errors
    (localize.py:708-725), which leaves err at its inf initializer for
    exactly these cases — unlike its public cal_vec_angle_error, which
    maps them to 0."""
    na = np.linalg.norm(a, axis=-1, keepdims=True)
    nb = np.linalg.norm(b, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.sum((a / na) * (b / nb), axis=-1)
    d = np.around(d, 4)
    err = np.degrees(np.arccos(np.clip(d, -1.0, 1.0)))
    return np.where(np.isnan(err), np.inf, err)


def _score_hypotheses(q_h: np.ndarray, c_h: np.ndarray, arr: _PairArrays,
                      thres: float):
    """Score H absolute-pose hypotheses against all k pairs at once.

    Replaces the reference's find_inliers inner loop
    (localize.py:683-731) with one [H, k] broadcast.  Returns
    (inlier mask [H,k], errors [H,k], rid [H,k], flip [H,k]).
    """
    q_h = np.atleast_2d(q_h)
    c_h = np.atleast_2d(c_h)
    # relative translation implied by the hypothesis, query -> train frame
    diff = c_h[:, None, :] - arr.ctr[None, :, :]          # (H,k,3)
    t_est = np.einsum("kab,hkb->hka", arr.Rtr, diff)
    if arr.pair_type == "ess":
        qn = q_h / np.linalg.norm(q_h, axis=-1, keepdims=True)
        qc = arr.qcand / np.linalg.norm(arr.qcand, axis=-1, keepdims=True)
        dots = np.abs(np.einsum("hq,kcq->hkc", qn, qc))   # (H,k,2)
        rid = np.argmax(dots, axis=-1)                    # min angle err
        Rsel = arr.Rcand[np.arange(arr.k)[None, :], rid]  # (H,k,3,3)
        t_opt = -np.einsum("hkab,ka->hkb", Rsel, arr.t)
        err_pos = _angles_deg(t_est, t_opt)
        err_neg = _angles_deg(t_est, -t_opt)
        flip = err_neg < err_pos
        err = np.where(flip, err_neg, err_pos)
    else:
        t_opt = -np.einsum("kab,ka->kb", arr.Rrel, arr.trel)
        err = _angles_deg(t_est, t_opt[None])
        rid = np.zeros(err.shape, np.int64)
        flip = np.zeros(err.shape, bool)
    # same-position query/train: reference treats as 0 error
    err = np.where(np.linalg.norm(t_est, axis=-1) == 0.0, 0.0, err)
    return err < thres, err, rid, flip


def find_inliers(hypo_abs_pose: AbsPose, test_pair_list: Sequence,
                 thres: float, pair_type: str = "ess",
                 update_trans: bool = False) -> List[int]:
    """Inlier pair indices for one hypothesis (localize.py:667-731).

    For 'ess' pairs the rotation candidate closest to the hypothesis is
    selected (and recorded via set_rid); with update_trans=True the
    translation sign giving the smaller angle error is written back."""
    arr = _PairArrays(test_pair_list, pair_type)
    mask, _err, rid, flip = _score_hypotheses(
        hypo_abs_pose.q[None], hypo_abs_pose.c[None], arr, thres)
    if pair_type == "ess":
        for i, p in enumerate(test_pair_list):
            p.set_rid(rid[0, i])
            if update_trans and flip[0, i]:
                p.set_opposite_trans_pred()
    return list(np.nonzero(mask[0])[0])


def estimate_model(test_pair_list: Sequence, inliers: Sequence[int],
                   pair_type: str) -> AbsPose:
    """Absolute pose from an inlier set: multi-view DLT position + mean
    quaternion (localize.py:734-756).  'ess' pairs contribute the
    epipole/rotation of their currently-set rid."""
    xs, Ps, qs = [], [], []
    for i in inliers:
        p = test_pair_list[i]
        if pair_type == "ess":
            xs.append(p.x_te[p.rid])
            qs.append(p.abs_q_pred[p.rid])
        else:
            xs.append(p.x_te)
            qs.append(p.abs_q_pred)
        Ps.append(p.train_abs_pose.p)
    c = triangulate_views(np.stack(xs), np.stack(Ps))
    q = np.mean(np.stack(qs).reshape(len(qs), 4), axis=0)
    return AbsPose(q, c)


def local_optimisation(test_pair_list: Sequence, abs_pose_best: AbsPose,
                       thres_multiplier: float, thres: float, in_iter: int,
                       pair_type: str,
                       rng: Optional[np.random.Generator] = None):
    """LO-RANSAC refinement (localize.py:638-664): re-estimate from a
    widened inlier set, then from in_iter random half-subsets, and keep
    the candidate with the most base-threshold inliers."""
    rng = rng or np.random.default_rng(0)
    inlier_mult = find_inliers(abs_pose_best, test_pair_list,
                               thres_multiplier * thres, pair_type=pair_type)
    all_poses = [abs_pose_best]
    if len(inlier_mult) >= 2:
        abs_pose_mult = estimate_model(test_pair_list, inlier_mult, pair_type)
        all_poses.append(abs_pose_mult)
        inlier_base = find_inliers(abs_pose_mult, test_pair_list, thres,
                                   pair_type=pair_type)
        n_sub = min(14, len(inlier_base) // 2)
        if n_sub > 2:
            base = np.asarray(inlier_base)
            for _ in range(in_iter):
                sub = rng.permutation(base)[:n_sub]
                all_poses.append(
                    estimate_model(test_pair_list, list(sub), pair_type))
    best_inl: List[int] = []
    best_pose = None
    for pose in all_poses:
        inl = find_inliers(pose, test_pair_list, thres, pair_type=pair_type)
        if len(inl) > len(best_inl):
            best_inl, best_pose = inl, pose
    return best_inl, best_pose


def _generate_hypotheses(arr: _PairArrays):
    """All C(k,2) minimal-sample hypotheses in one batch
    (localize.py:502-525).  Returns (q_h [H,4], c_h [H,3], combos)."""
    combos = list(itertools.combinations(range(arr.k), 2))
    a = np.array([c[0] for c in combos])
    b = np.array([c[1] for c in combos])
    if arr.pair_type == "ess":
        qn = arr.qcand / np.linalg.norm(arr.qcand, axis=-1, keepdims=True)
        # rotation-candidate pairing minimizing the mutual angle
        dots = np.abs(np.einsum("aiq,bjq->abij", qn, qn))    # (k,k,2,2)
        d = dots[a, b].reshape(len(combos), 4)
        pick = np.argmax(d, axis=-1)
        ia, ib = pick // 2, pick % 2
        q_h = 0.5 * (arr.qcand[a, ia] + arr.qcand[b, ib])    # raw mean
        x = np.stack([arr.xte[a, ia], arr.xte[b, ib]], axis=1)  # (H,2,2)
        finite = np.isfinite(x).all(axis=(1, 2))
        x = np.where(np.isfinite(x), x, 0.0)
    else:
        q_h = 0.5 * (arr.qabs[a] + arr.qabs[b])
        x = np.stack([arr.xte[a], arr.xte[b]], axis=1)
        finite = np.isfinite(x).all(axis=(1, 2))
    P = np.stack([arr.Ptr[a], arr.Ptr[b]], axis=1)           # (H,2,3,4)
    c_h = triangulate_views(x, P)
    return q_h, c_h, combos, finite


def ransac(pair_data: Dict, inlier_thres: float,
           thres_multiplier: float = 1.414, in_iter: int = 10,
           pair_type: str = "ess",
           err_thres: Sequence[Tuple[float, float]] = (
               (0.25, 2), (0.5, 5), (5, 10)),
           loc_results: Optional[Dict] = None,
           rng: Optional[np.random.Generator] = None):
    """Per-query absolute-pose RANSAC over 2-pair hypotheses
    (localize.py:471-635).

    All hypotheses are generated and scored in one broadcast; local
    optimisation runs from the raw best.  Queries with no pairs get the
    reference's sentinel errors (1000 m / 180 deg); queries where no
    hypothesis reaches 2 inliers fall back to the first reference
    image's pose ("approximated").
    Returns (num_tested, approx_queries, pass_rate, medians) with
    medians = (rela_t_deg, rela_q_deg, abs_c_m, abs_c_deg, abs_q_deg).
    """
    rng = rng or np.random.default_rng(0)
    abs_c_dist_err, abs_c_ang_err, abs_q_err = [], [], []
    rela_t_err, rela_q_err = [], []
    passed = [0 for _ in err_thres]
    approx_queries = []
    for test_im, entry in pair_data.items():
        test_abs_pose = entry["test_abs_pose"]
        test_pair_list = entry["test_pairs"]
        if len(test_pair_list) == 0:
            cerr, qerr = 1000.0, 180.0
            abs_c_dist_err.append(cerr)
            abs_c_ang_err.append(qerr)
            abs_q_err.append(qerr)
            rela_t_err.append(qerr)
            rela_q_err.append(qerr)
            if loc_results is not None:
                loc_results[test_im] = None
        else:
            arr = _PairArrays(test_pair_list, pair_type)
            inlier_best: List[int] = []
            abs_pose_best = None
            approximated = False
            if arr.k >= 2:
                q_h, c_h, _combos, finite = _generate_hypotheses(arr)
                mask, _e, _r, _f = _score_hypotheses(
                    q_h, c_h, arr, inlier_thres)
                counts = np.where(finite, mask.sum(axis=1), -1)
                # Replay the reference scan (localize.py:503-539): LO
                # fires at every hypothesis that beats the running best.
                # The precomputed counts let us skip straight to those.
                for h in np.nonzero(counts >= 2)[0]:
                    if counts[h] <= len(inlier_best):
                        continue
                    abs_pose_best = AbsPose(q_h[h], c_h[h])
                    inlier_best = list(np.nonzero(mask[h])[0])
                    lo_inl, lo_pose = local_optimisation(
                        test_pair_list, abs_pose_best, thres_multiplier,
                        inlier_thres, in_iter, pair_type, rng=rng)
                    if len(lo_inl) > len(inlier_best):
                        inlier_best, abs_pose_best = lo_inl, lo_pose
            if abs_pose_best is None or len(inlier_best) == 0:
                pair = test_pair_list[0]
                abs_pose_best = pair.train_abs_pose
                inlier_best = [0]
                approx_queries.append(test_im)
                approximated = True
            if pair_type == "ess":
                # resolve each pair's rotation id + translation sign
                find_inliers(abs_pose_best, test_pair_list, inlier_thres,
                             pair_type=pair_type, update_trans=True)

            t_err, q_err = [], []
            train_abs_c_list = []
            cumulative_inliers = 0.0
            for i in inlier_best:
                p = test_pair_list[i]
                train_abs_c_list.append(p.train_abs_pose.c)
                if pair_type == "ess":
                    t_err.append(_sc(
                        vec_angle_error(p.rela_pose_lbl.t, p.t)))
                    q_err.append(_sc(quat_angle_error(
                        p.rela_pose_lbl.q, p.get_rela_q())))
                else:
                    t_err.append(_sc(vec_angle_error(
                        p.rela_pose_lbl.t, p.rela_pose_pred.t)))
                    q_err.append(_sc(quat_angle_error(
                        p.rela_pose_lbl.q, p.rela_pose_pred.q)))
                cumulative_inliers += getattr(p, "inliers", 0.0)
            rela_t_err.append(float(np.mean(t_err)))
            rela_q_err.append(float(np.mean(q_err)))

            train_abs_c = np.vstack(train_abs_c_list)
            cerr = float(np.linalg.norm(test_abs_pose.c - abs_pose_best.c))
            abs_c_dist_err.append(cerr)
            if approximated:
                abs_c_ang_err.append(0.0)
            else:
                abs_c_ang_err.append(float(np.mean(vec_angle_error(
                    test_abs_pose.c - train_abs_c,
                    abs_pose_best.c - train_abs_c))))
            qerr = _sc(quat_angle_error(test_abs_pose.q, abs_pose_best.q))
            abs_q_err.append(qerr)

            if loc_results is not None:
                loc_results[test_im] = {
                    "abs_pose_lbl": test_abs_pose,
                    "abs_pose_pred": abs_pose_best,
                    "relv_pose_list": test_pair_list,
                    "inliers": cumulative_inliers,
                    "approximated": approximated,
                    "abs_t_err": cerr,
                    "abs_r_err": qerr,
                }
        for i, (c_thr, q_thr) in enumerate(err_thres):
            if cerr < c_thr and qerr < q_thr:
                passed[i] += 1
    num_tested = len(abs_c_dist_err)
    pass_rate = [100.0 * c / num_tested for c in passed]
    medians = (float(np.median(rela_t_err)), float(np.median(rela_q_err)),
               float(np.median(abs_c_dist_err)),
               float(np.median(abs_c_ang_err)), float(np.median(abs_q_err)))
    return num_tested, approx_queries, pass_rate, medians


# --------------------------------------------------------------------- #
# precision / recall (reference localize.py:257-349)
# --------------------------------------------------------------------- #

def precision_recall(inliers, tp, failures):
    """Precision/recall over confidence ("inliers") thresholds plus the
    AUC average precision (localize.py:301-349 semantics: recall counts
    failures in the denominator; ties collapse to one point)."""
    inliers = np.asarray(inliers, np.float64).reshape(-1)
    tp = np.asarray(tp).reshape(-1)
    assert len(inliers) == len(tp), "unequal shapes"
    order = np.argsort(inliers)[::-1]
    inliers = inliers[order]
    tp = tp[order]
    distinct = np.where(np.diff(inliers))[0]
    thr_idx = np.r_[distinct, inliers.size - 1]
    N = inliers.shape[0]
    rec = np.arange(N, dtype=np.float32) + 1
    prec = np.cumsum(tp)[thr_idx] / rec[thr_idx]
    rec = rec[thr_idx] / (float(N) + float(failures))
    last = rec.searchsorted(rec[-1])
    sl = slice(last, None, -1)
    prec = np.r_[prec[sl], 1]
    rec = np.r_[rec[sl], 0]
    ap = float(np.abs(np.sum(np.diff(rec) * np.asarray(prec)[:-1])))
    return prec, rec, ap


def precision_recall_pose_error(inliers, terr, rerr, failures,
                                pose_threshold):
    """PR where a pose is a true positive if both translation and
    rotation errors are inside pose_threshold (localize.py:257-278)."""
    terr = np.asarray(terr, np.float64).reshape(-1)
    rerr = np.asarray(rerr, np.float64).reshape(-1)
    assert len(inliers) == len(terr) == len(rerr), "unequal shapes"
    assert len(pose_threshold) == 2, "invalid pose_threshold"
    tp = (terr <= pose_threshold[0]) & (rerr <= pose_threshold[1])
    return precision_recall(inliers, tp, failures)


def precision_recall_repr_error(inliers, reprerr, failures, repr_threshold):
    """PR with a reprojection-error TP criterion (localize.py:281-298)."""
    reprerr = np.asarray(reprerr, np.float64).reshape(-1)
    assert len(inliers) == len(reprerr), "unequal shapes"
    return precision_recall(inliers, reprerr < repr_threshold, failures)


# --------------------------------------------------------------------- #
# no-RANSAC metrics (reference localize.py:164-225, 352-465)
# --------------------------------------------------------------------- #

def cal_rela_pose_err(pair_data: Dict) -> Tuple[float, float]:
    """Median relative translation-angle / rotation errors over all
    pairs (localize.py:211-225)."""
    t_err, q_err = [], []
    for entry in pair_data.values():
        for p in entry["test_pairs"]:
            t_err.append(_sc(vec_angle_error(
                p.rela_pose_lbl.t, p.rela_pose_pred.t)))
            q_err.append(_sc(quat_angle_error(
                p.rela_pose_lbl.q, p.rela_pose_pred.q)))
    return float(np.median(t_err)), float(np.median(q_err))


def cal_abs_pose_err_metric(pair_data: Dict,
                            err_thres=((0.25, 2), (0.5, 5)),
                            loc_results: Optional[Dict] = None):
    """Direct (no-RANSAC) absolute pose from metric relative poses:
    geometric-median position + rotation averaging (localize.py:352-421).
    Returns (median cerr, median c-angle err, median qerr,
    pass rates %, average precision)."""
    abs_c_dist_err, abs_c_ang_err, abs_q_err, inliers = [], [], [], []
    passed = [0] * len(err_thres)
    failures = 0
    for test_im, entry in pair_data.items():
        test_abs_pose = entry["test_abs_pose"]
        pairs = entry["test_pairs"]
        if len(pairs) == 0:
            failures += 1
            if loc_results is not None:
                loc_results[test_im] = None
            continue
        abs_c_pred = geometric_median(
            np.vstack([p.abs_c_pred for p in pairs]))
        cerr = _sc(np.linalg.norm(test_abs_pose.c - abs_c_pred, axis=1))
        abs_c_dist_err.append(cerr)
        train_abs_c = np.vstack([p.train_abs_pose.c for p in pairs])
        abs_c_ang_err.append(float(np.median(vec_angle_error(
            test_abs_pose.c - train_abs_c, abs_c_pred - train_abs_c))))
        inliers.append(pairs[0].inliers)  # single keyframe assumption
        abs_q_pred = average_quaternions(
            np.stack([p.abs_q_pred for p in pairs]))
        qerr = _sc(quat_angle_error(test_abs_pose.q, abs_q_pred))
        abs_q_err.append(qerr)
        for i, (c_thr, q_thr) in enumerate(err_thres):
            if cerr < c_thr and qerr < q_thr:
                passed[i] += 1
        if loc_results is not None:
            loc_results[test_im] = {
                "abs_pose_lbl": test_abs_pose,
                "abs_pose_pred": AbsPose(abs_q_pred.reshape(-1),
                                         abs_c_pred.reshape(-1)),
                "abs_t_err": cerr,
                "abs_r_err": qerr,
                "inliers": pairs[0].inliers,
            }
    _p, _r, ap = precision_recall_pose_error(
        inliers, abs_c_dist_err, abs_q_err, failures,
        pose_threshold=err_thres[1])
    rates = 100.0 * np.asarray(passed, np.float64) / max(len(pair_data), 1)
    return (float(np.median(abs_c_dist_err)),
            float(np.median(abs_c_ang_err)),
            float(np.median(abs_q_err)), rates, ap)


def cal_abs_pose_err(pair_data: Dict, err_thres=(2, 5)):
    """Direct absolute pose via multi-view triangulation (non-metric
    relative poses; localize.py:426-465)."""
    abs_c_dist_err, abs_c_ang_err, abs_q_err = [], [], []
    passed = 0
    for entry in pair_data.values():
        test_abs_pose = entry["test_abs_pose"]
        pairs = entry["test_pairs"]
        if len(pairs) < 2:
            continue
        x = np.stack([p.x_te for p in pairs])
        P = np.stack([p.train_abs_pose.p for p in pairs])
        abs_c_pred = triangulate_views(x, P)
        cerr = float(np.linalg.norm(test_abs_pose.c - abs_c_pred))
        abs_c_dist_err.append(cerr)
        train_abs_c = np.vstack([p.train_abs_pose.c for p in pairs])
        abs_c_ang_err.append(float(np.mean(vec_angle_error(
            test_abs_pose.c - train_abs_c, abs_c_pred - train_abs_c))))
        abs_q_pred = np.mean(np.stack([p.abs_q_pred for p in pairs]), axis=0)
        qerr = _sc(quat_angle_error(test_abs_pose.q, abs_q_pred))
        abs_q_err.append(qerr)
        if cerr < err_thres[0] and qerr < err_thres[1]:
            passed += 1
    return (float(np.median(abs_c_dist_err)),
            float(np.median(abs_c_ang_err)), float(np.median(abs_q_err)),
            100.0 * passed / max(len(abs_q_err), 1))


# --------------------------------------------------------------------- #
# evaluation pipelines (reference localize.py:120-208)
# --------------------------------------------------------------------- #

def eval_pipeline_with_ransac(result_dict: Dict, ransac_thres,
                              ransac_iter: int, ransac_miu: float,
                              pair_type: str, err_thres,
                              save_res_path: Optional[str] = None):
    """Run the RANSAC localizer per scene over a sweep of inlier
    thresholds (localize.py:120-161).  Returns (best (abs_t, abs_r)
    medians over thresholds, last pass rates)."""
    log.info("Evaluate with RANSAC (iter=%s, miu=%s) err_thres=%s",
             ransac_iter, ransac_miu, err_thres)
    t1 = time.time()
    best_abs_err = None
    avg_pass: Tuple = ()
    for thres in ransac_thres:
        avg_err, avg_pass_l = [], []
        loc_results_dict: Dict = {}
        for dataset, entry in result_dict.items():
            loc_results_dict[dataset] = {} if save_res_path else None
            pt = "relapose" if pair_type == "angess" else pair_type
            tested, approx, pass_rate, errs = ransac(
                entry["pair_data"], thres, thres_multiplier=ransac_miu,
                in_iter=ransac_iter, pair_type=pt, err_thres=err_thres,
                loc_results=loc_results_dict[dataset])
            avg_err.append(errs)
            avg_pass_l.append(pass_rate)
            log.info(
                "Dataset:%s Bad/All:%d/%d Rela:(t%.2fdeg, r%.2fdeg) "
                "Abs:(t%.2fm/%.2fdeg, r%.2fdeg) Pass:%s",
                dataset[:10], len(approx), tested, *errs,
                "/".join(f"{v:.2f}%" for v in pass_rate))
        avg_err = tuple(np.mean(avg_err, axis=0))
        avg_pass = (tuple(np.mean(avg_pass_l, axis=0))
                    if len(err_thres) > 1 else tuple(avg_pass_l))
        # the reference's running-best tracker (localize.py:149-153) has
        # an inverted comparison and is marked "not used"; since this
        # port documents the return as the best sweep point, track the
        # actual minimum abs-translation median
        if best_abs_err is None or avg_err[2] < best_abs_err[0]:
            best_abs_err = (avg_err[2], avg_err[4])
        log.info("Avg: Rela:(t%.2fdeg, r%.2fdeg) Abs:(t%.2fm/%.2fdeg, "
                 "r%.2fdeg)", *avg_err)
        if save_res_path:
            np.save(save_res_path, loc_results_dict)  # noqa: allow pickle
    log.info("RANSAC testing time: %.1fs", time.time() - t1)
    return best_abs_err, avg_pass


def eval_pipeline_without_ransac(result_dict: Dict, err_thres=((0.25, 2),
                                                               (0.5, 5)),
                                 save_res_path: Optional[str] = None):
    """Direct (no-RANSAC) evaluation per scene (localize.py:164-208).
    Returns ((rela_t, rela_q, abs_c_m, abs_c_deg, abs_q_deg) means over
    scenes, mean pass rates)."""
    rela_t, rela_q = [], []
    abs_c_dist, abs_c_ang, abs_q = [], [], []
    all_passed = []
    loc_results_dict: Dict = {}
    for dataset, entry in result_dict.items():
        loc_results_dict[dataset] = {} if save_res_path else None
        pair_data = entry["pair_data"]
        failures = entry.get("no_pt_pairs", [])
        log.info("Testing dataset %s: %d samples, %d failures",
                 dataset, len(pair_data), len(failures))
        rt, rq = cal_rela_pose_err(pair_data)
        rela_t.append(rt)
        rela_q.append(rq)
        cd, ca, qe, passed, ap = cal_abs_pose_err_metric(
            pair_data, err_thres, loc_results_dict[dataset])
        abs_c_dist.append(cd)
        abs_c_ang.append(ca)
        abs_q.append(qe)
        all_passed.append(passed)
        log.info("rela (t%.2fdeg, r%.2fdeg) abs (t%.2fm/%.2fdeg, "
                 "r%.2fdeg) AP %.2f", rt, rq, cd, ca, qe, ap)
    if save_res_path:
        np.save(save_res_path, loc_results_dict)
    avg_passed = np.stack(all_passed).mean(axis=0)
    eval_val = (float(np.mean(rela_t)), float(np.mean(rela_q)),
                float(np.mean(abs_c_dist)), float(np.mean(abs_c_ang)),
                float(np.mean(abs_q)))
    return eval_val, avg_passed


# --------------------------------------------------------------------- #
# result artifacts (reference localize.py:51-117)
# --------------------------------------------------------------------- #

def save_results_visualisation(file_path: str):
    """Dump per-scene `pose_<scene>.txt` files (test_im, q, t, inliers)
    from a saved loc-results dict (localize.py:51-69)."""
    results_dict = np.load(file_path, allow_pickle=True).item()
    out_prefix = os.path.join(os.path.split(file_path)[0], "pose_")
    for scene, scene_res in results_dict.items():
        with open(out_prefix + scene + ".txt", "w") as f:
            for test_im, res in scene_res.items():
                if res is None:
                    continue
                pose = res["abs_pose_pred"]
                q_str = " ".join(f"{v:.6f}" for v in pose.q)
                t_str = " ".join(f"{v:.6f}" for v in pose.t)
                f.write(f"{test_im} {q_str} {t_str} {res['inliers']} \n")


def generate_precision_recall_plots(file_path: str, pose_threshold):
    """Per-scene + whole-dataset PR curves saved as jpgs next to the
    results file (localize.py:72-117)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results_dict = np.load(file_path, allow_pickle=True).item()
    out_prefix = os.path.join(os.path.split(file_path)[0], "pr_")

    def plot(prec, rec, title, path):
        plt.figure()
        plt.plot(rec, prec, drawstyle="steps-post")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.xlim(0, 1)
        plt.ylim(0, 1.1)
        plt.title(title)
        plt.tight_layout()
        plt.savefig(path)
        plt.close()

    all_inliers, all_terr, all_rerr = [], [], []
    all_failures = 0
    for scene, scene_res in results_dict.items():
        vals = [r for r in scene_res.values() if r is not None]
        terr = np.array([r["abs_t_err"] for r in vals])
        rerr = np.array([r["abs_r_err"] for r in vals])
        inliers = np.array([r["inliers"] for r in vals])
        failures = sum(1 for r in scene_res.values() if r is None)
        all_terr.append(terr)
        all_rerr.append(rerr)
        all_inliers.append(inliers)
        all_failures += failures
        prec, rec, ap = precision_recall_pose_error(
            inliers, terr, rerr, failures, pose_threshold)
        plot(prec, rec, f"Scene {scene}. AP={ap:.2f}",
             out_prefix + scene + ".jpg")
    prec, rec, ap = precision_recall_pose_error(
        np.concatenate(all_inliers), np.concatenate(all_terr),
        np.concatenate(all_rerr), all_failures, pose_threshold)
    plot(prec, rec, f"Dataset. AP={ap:.2f}", out_prefix + "all.jpg")
