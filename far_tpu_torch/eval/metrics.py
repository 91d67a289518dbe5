"""Pose and matching metrics, reduced on the host in numpy.

The port's own copy of ``far_tpu/eval/metrics.py``, function for function
(a test holds each to the JAX package's on the same arrays):
``relative_pose_error``, ``rotation_angles_deg``, ``geodesic_deg``,
``pose_error``, ``a_metrics``, ``error_auc``, ``epidist_prec``,
``aggregate_metrics`` (the Matterport table), its InteriorNet/StreetLearn
split ``aggregate_metrics_interiornet_streetlearn`` and
``MetricsAccumulator``. The per-match epipolar residuals come from
``far_tpu_torch.geometry`` on the device; everything here is a cheap
reduction over the gathered per-pair results.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Sequence

import numpy as np


# ---- per-pair errors -------------------------------------------------------


def relative_pose_error(T_0to1: np.ndarray, R: np.ndarray, t: np.ndarray,
                        ignore_gt_t_thr: float = 0.0):
    """(t angular deg, R angular deg, t absolute) errors of one pair.

    The translation angle treats +-t as one (the essential matrix's sign
    ambiguity) and is 0 where the ground truth's translation is shorter
    than ``ignore_gt_t_thr`` (near-pure rotation)."""
    T_0to1 = np.asarray(T_0to1)
    t_gt = T_0to1[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    t_err = np.degrees(np.arccos(np.clip(np.dot(t, t_gt) / (n + 1e-15), -1, 1)))
    t_err = np.minimum(t_err, 180.0 - t_err)
    if np.linalg.norm(t_gt) < ignore_gt_t_thr:
        t_err = 0.0
    t_err_abs = np.linalg.norm(np.asarray(t) - t_gt)

    R_gt = T_0to1[:3, :3]
    cos = np.clip((np.trace(np.asarray(R).T @ R_gt) - 1) / 2, -1.0, 1.0)
    R_err = np.degrees(np.abs(np.arccos(cos)))
    return float(t_err), float(R_err), float(t_err_abs)


def rotation_angles_deg(Rs: np.ndarray) -> np.ndarray:
    """Batched rotation magnitudes in degrees."""
    tr = np.trace(Rs, axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def geodesic_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    return rotation_angles_deg(R1 @ np.swapaxes(R2, -1, -2))


def pose_error(R_gt, t_gt, R_est, t_est) -> Dict[str, np.ndarray]:
    """Map-free batched pose errors: the translation's angle, scale ratio
    and euclidean error, and the rotation's angle."""
    R_gt, t_gt = np.asarray(R_gt), np.asarray(t_gt)
    R_est, t_est = np.asarray(R_est), np.asarray(t_est)
    n = np.linalg.norm(t_est, axis=-1) * np.linalg.norm(t_gt, axis=-1)
    cos = np.sum(t_est * t_gt, -1) / (n + 1e-15)
    t_ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    scale = np.linalg.norm(t_est, axis=-1) / (np.linalg.norm(t_gt, axis=-1) + 1e-15)
    t_euc = np.linalg.norm(t_est - t_gt, axis=-1)
    r_ang = geodesic_deg(R_est, R_gt)
    return {"t_err_ang": t_ang, "t_err_scale": scale,
            "t_err_euc": t_euc, "R_err": r_ang}


def a_metrics(scale_ratio: np.ndarray) -> Dict[str, float]:
    """Scale accuracy a1/a2/a3: the share within 1.25^k of the true norm."""
    ratio = np.maximum(scale_ratio, 1.0 / (scale_ratio + 1e-15))
    return {
        "a1": float(np.mean(ratio < 1.25)),
        "a2": float(np.mean(ratio < 1.25 ** 2)),
        "a3": float(np.mean(ratio < 1.25 ** 3)),
    }


# ---- aggregation -----------------------------------------------------------


def error_auc(errors: Sequence[float],
              thresholds: Sequence[float] = (5, 10, 20)) -> Dict[str, float]:
    """Area under the recall-against-error curve up to each threshold."""
    errors = [0.0] + sorted(float(e) for e in errors)
    recall = list(np.linspace(0, 1, len(errors)))
    aucs = {}
    for thr in thresholds:
        last = np.searchsorted(errors, thr)
        y = recall[:last] + [recall[last - 1]]
        x = errors[:last] + [thr]
        aucs[f"auc@{int(thr)}"] = float(np.trapezoid(y, x) / thr)
    return aucs


def epidist_prec(errors_per_pair, thresholds, ret_dict: bool = False):
    """Mean matching precision at epipolar-distance thresholds (a pair with
    no match counts 0)."""
    precs = []
    for thr in thresholds:
        per_pair = [
            float(np.mean(np.asarray(e) < thr)) if len(np.asarray(e)) else 0.0
            for e in errors_per_pair
        ]
        precs.append(float(np.mean(per_pair)) if per_pair else 0.0)
    if ret_dict:
        return {f"prec@{t:.0e}": p for t, p in zip(thresholds, precs)}
    return precs


def _dedup_ids(identifiers) -> List[int]:
    """Indices of the last occurrence of each identifier, in first-seen
    order: the dedup of a padded sampler's repeated pairs."""
    unq = OrderedDict((iden, i) for i, iden in enumerate(identifiers))
    return list(unq.values())


def aggregate_metrics(metrics: Dict, epi_err_thr: float = 5e-4) -> Dict:
    """The Matterport table: translation and rotation errors, fit rate,
    pose AUCs and epipolar precision over the deduplicated pairs."""
    unq = _dedup_ids(metrics["identifiers"])

    R_errs = np.asarray(metrics["R_errs"], np.float64)
    t_errs = np.asarray(metrics["t_errs"], np.float64)
    t_abs = np.asarray(metrics["t_errs_abs"], np.float64)
    fits = np.asarray(metrics["successful_fits"], np.float64)

    pose_errors = np.maximum(R_errs, t_errs)[unq]
    aucs = error_auc(pose_errors, (5, 10, 20))
    precs = epidist_prec([metrics["epi_errs"][i] for i in unq], [epi_err_thr], True)

    t_errs, R_errs, t_abs, fits = t_errs[unq], R_errs[unq], t_abs[unq], fits[unq]
    table = {
        "tr rot mean err": round(float(np.mean(t_errs)), 2),
        "tr rot median err": round(float(np.median(t_errs)), 2),
        "tr rot pct < 30": round(100 * float(np.mean(t_errs < 30)), 1),
        "tr abs mean err": round(float(np.mean(t_abs)), 2),
        "tr abs median err": round(float(np.median(t_abs)), 2),
        "tr abs pct < 1": round(100 * float(np.mean(t_abs < 1)), 1),
        "rot mean err": round(float(np.mean(R_errs)), 2),
        "rot median err": round(float(np.median(R_errs)), 2),
        "rot pct < 30": round(100 * float(np.mean(R_errs < 30)), 1),
        "pct successful fits": round(100 * float(np.mean(fits)), 1),
        "dset size": int(len(t_errs)),
    }
    return {**table, **aucs, **precs}


def aggregate_metrics_interiornet_streetlearn(metrics: Dict,
                                              epi_err_thr: float = 5e-4) -> Dict:
    """Geodesic rotation errors split by the ground truth's overlap:
    'large' below a 45 deg rotation, 'small' from 45 to 90 deg."""
    unq = _dedup_ids(metrics["identifiers"])
    precs = epidist_prec([metrics["epi_errs"][i] for i in unq], [epi_err_thr], True)

    gt_R = np.asarray(metrics["gt_R"], np.float64).reshape(-1, 3, 3)[unq]
    pred_R = np.asarray(metrics["pred_R"], np.float64).reshape(-1, 3, 3)[unq]
    geo = geodesic_deg(pred_R, gt_R)
    gt_mag = rotation_angles_deg(gt_R)

    large = geo[gt_mag < 45.0]
    small = geo[(gt_mag >= 45.0) & (gt_mag < 90.0)]
    fits = np.asarray(metrics["successful_fits"], np.float64)[unq]

    def stats(x, name):
        if len(x) == 0:
            return {f"{name}, rot mean err": float("nan"),
                    f"{name}, rot median err": float("nan"),
                    f"{name}, rot pct < 10": float("nan")}
        return {
            f"{name}, rot mean err": round(float(np.mean(x)), 2),
            f"{name}, rot median err": round(float(np.median(x)), 2),
            f"{name}, rot pct < 10": round(100 * float(np.mean(x < 10)), 1),
        }

    return {
        **stats(large, "large overlap"),
        **stats(small, "small overlap"),
        "pct successful fits": round(100 * float(np.mean(fits)), 1),
        **precs,
    }


class MetricsAccumulator:
    """Collects batched metric arrays over steps; ``accumulate`` joins each
    along axis 0."""

    def __init__(self):
        self._data = defaultdict(list)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self._data[k].append(np.asarray(v))

    def accumulate(self) -> Dict[str, np.ndarray]:
        return {k: np.concatenate(v, axis=0) for k, v in self._data.items()}
