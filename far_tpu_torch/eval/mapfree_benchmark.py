"""Offline Map-free Relocalization scorer.

The port's copy of ``far_tpu/eval/mapfree_benchmark.py``, a
re-implementation of crockwell/far: mapfree_6dreg/benchmark/ (mapfree.py,
metrics.py, reprojection.py, utils.py, config.py): scores a submission
(a zip of per-scene pose files, or an in-memory dict) against the ground
truth poses with the official thresholds (pose 25 cm and 5 deg, VCRE
90 px), reporting precision and confidence-ranked AUC. Numpy only::

    python -m far_tpu_torch.eval.mapfree_benchmark submission.zip \
        --dataset_path <mapfree_root> --split val
"""

from __future__ import annotations

import io
import json
import zipfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# official thresholds (reference benchmark/config.py:1-8)
T_THRESHOLD = 0.25     # meters
R_THRESHOLD = 5.0      # degrees
VCRE_THRESHOLD = 90.0  # pixels

VARIANT_ANGLE_SIN = "sin"
VARIANT_ANGLE_COS = "cos"


# --------------------------------------------------------------------- #
# quaternion utilities (w, x, y, z)
# --------------------------------------------------------------------- #

def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inverse(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return conj / np.dot(q, q)


def quat_angle_error(label: np.ndarray, pred: np.ndarray,
                     variant: str = VARIANT_ANGLE_SIN) -> float:
    """Angle between two quaternions in degrees.

    Two variants as in the reference (benchmark/utils.py:106-140): 'sin'
    (numerically exact for tiny angles — the official one) and 'cos'.
    """
    q1 = np.asarray(pred, np.float64)
    q2 = np.asarray(label, np.float64)
    q1 = q1 / np.linalg.norm(q1)
    q2 = q2 / np.linalg.norm(q2)
    if variant == VARIANT_ANGLE_COS:
        d = np.clip(np.abs(np.dot(q1, q2)), -1.0, 1.0)
        return float(2.0 * np.degrees(np.arccos(d)))
    diff = quat_multiply(q1, quat_inverse(q2))
    sine = np.linalg.norm(diff[1:])
    return float(np.degrees(2.0 * np.arcsin(np.clip(sine, -1.0, 1.0))))


# --------------------------------------------------------------------- #
# VCRE (virtual correspondence reprojection error)
# --------------------------------------------------------------------- #

def _ar_grid() -> np.ndarray:
    """7x4x7 AR-content grid of virtual 3D points in front of the camera
    (reference reprojection.py:33-60), homogeneous (N, 4)."""
    step, nx, ny, nz = 0.3, 7, 4, 7
    xs = (np.arange(nx) - (nx - 1) / 2) * step
    ys = (np.arange(ny) - (ny - 1) / 2) * step
    zs = np.arange(nz, dtype=float) * step + 1.8
    xx, yy, zz = np.meshgrid(xs, ys, zs)
    ones = np.ones(xx.size)
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel(), ones], axis=-1)


_EYE_COORDS = _ar_grid()


def project(pts: np.ndarray, K: np.ndarray,
            img_size: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Project (N, 3/4) camera-space points with K, optionally clamping
    to image borders."""
    uv_h = (K @ pts[:, :3].T).T
    uv = uv_h[:, :2] / uv_h[:, -1:]
    if img_size is not None:
        uv[:, 0] = np.clip(uv[:, 0], 0, img_size[0])
        uv[:, 1] = np.clip(uv[:, 1], 0, img_size[1])
    return uv


def reprojection_error(q_est, t_est, q_gt, t_gt, K, W, H) -> float:
    """Mean reprojection error of the AR grid under the residual pose."""
    eye = _EYE_COORDS
    uv_gt = project(eye, K, (W, H))
    cam2w_est = np.eye(4)
    cam2w_est[:3, :3] = quat_to_matrix(q_est)
    cam2w_est[:3, 3] = t_est
    cam2w_gt = np.eye(4)
    cam2w_gt[:3, :3] = quat_to_matrix(q_gt)
    cam2w_gt[:3, 3] = t_gt
    residual = (np.linalg.inv(cam2w_est) @ cam2w_gt @ eye.T).T
    uv_pred = project(residual, K, (W, H))
    return float(np.linalg.norm(uv_gt - uv_pred, axis=1).mean())


# --------------------------------------------------------------------- #
# per-frame metrics + aggregation
# --------------------------------------------------------------------- #

def frame_metrics(q_gt, t_gt, q_est, t_est, confidence, K, W, H) -> Dict:
    return {
        "trans_err": float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt))),
        "rot_err": quat_angle_error(label=q_est, pred=q_gt),
        "reproj_err": reprojection_error(q_est, t_est, q_gt, t_gt, K, W, H),
        "confidence": float(confidence),
    }


def precision_recall(inliers, tp, failures):
    """Confidence-ranked precision/recall + average precision
    (reference benchmark/utils.py:143-196)."""
    inliers = np.asarray(inliers, np.float64)
    tp = np.asarray(tp).reshape(-1)
    assert len(inliers) == len(tp)
    order = np.argsort(inliers)[::-1]
    inliers = inliers[order]
    tp = tp[order]

    distinct = np.where(np.diff(inliers))[0]
    thr_idx = np.r_[distinct, inliers.size - 1]

    N = inliers.shape[0]
    rec_all = np.arange(N, dtype=np.float64) + 1
    cum_tp = np.cumsum(tp)
    prec = cum_tp[thr_idx] / rec_all[thr_idx]
    rec = rec_all[thr_idx] / (float(N) + float(failures))

    last_ind = rec_all[thr_idx].searchsorted(cum_tp[-1])
    sl = slice(last_ind, None, -1)
    prec = np.r_[prec[sl], 1]
    rec = np.r_[rec[sl], 0]
    average_precision = -np.sum(np.diff(rec) * prec[:-1])
    return prec, rec, average_precision


def aggregate_results(all_results: Dict[str, Dict[str, list]],
                      all_failures: int) -> Dict[str, float]:
    """Official aggregation: avg-of-scene-medians + precision/AUC at the
    fixed thresholds (reference mapfree.py:115-170)."""
    median_metrics = defaultdict(list)
    all_metrics = defaultdict(list)
    for scene_results in all_results.values():
        for metric, values in scene_results.items():
            median_metrics[metric].append(np.median(values))
            all_metrics[metric].extend(values)
    all_metrics = {k: np.asarray(v) for k, v in all_metrics.items()}

    avg_median = {m: float(np.mean(v)) for m, v in median_metrics.items()}
    accepted_poses = (all_metrics["trans_err"] < T_THRESHOLD) * (
        all_metrics["rot_err"] < R_THRESHOLD)
    accepted_vcre = all_metrics["reproj_err"] < VCRE_THRESHOLD
    total = len(next(iter(all_metrics.values()))) + all_failures

    _, _, auc_pose = precision_recall(
        all_metrics["confidence"], accepted_poses, all_failures)
    _, _, auc_vcre = precision_recall(
        all_metrics["confidence"], accepted_vcre, all_failures)

    return {
        "Average Median Translation Error": avg_median["trans_err"],
        "Average Median Rotation Error": avg_median["rot_err"],
        "Average Median Reprojection Error": avg_median["reproj_err"],
        f"Precision @ Pose Error < ({T_THRESHOLD*100:.0f}cm, {R_THRESHOLD:.0f}deg)":
            float(np.sum(accepted_poses) / total),
        f"AUC @ Pose Error < ({T_THRESHOLD*100:.0f}cm, {R_THRESHOLD:.0f}deg)":
            float(auc_pose),
        f"Precision @ VCRE < {VCRE_THRESHOLD:.0f}px":
            float(np.sum(accepted_vcre) / total),
        f"AUC @ VCRE < {VCRE_THRESHOLD:.0f}px": float(auc_vcre),
        "Estimates for % of frames":
            float(len(all_metrics["trans_err"]) / total),
    }


# --------------------------------------------------------------------- #
# pose file / submission IO
# --------------------------------------------------------------------- #

def load_poses(lines, load_confidence: bool = False) -> Dict[int, tuple]:
    """Parse a poses.txt: 'name qw qx qy qz tx ty tz [confidence]'."""
    expected = 9 if load_confidence else 8
    poses = {}
    for line in lines:
        if line.startswith("#") or line.strip() == "":
            continue
        parts = line.strip().split(" ")
        if len(parts) < expected:
            continue
        frame = int(parts[0][-9:-4])  # .../frame_00005.jpg -> 5
        qt = np.array(list(map(float, parts[1:expected])))
        q, t = qt[:4], qt[4:7]
        conf = float(qt[7]) if load_confidence else None
        if np.isnan(qt).any() or np.isinf(qt).any():
            continue
        poses[frame] = (q, t, conf)
    return poses


def load_K(path) -> Tuple[Dict[int, np.ndarray], float, float]:
    """Parse intrinsics.txt: 'name fx fy cx cy W H' per frame."""
    K, W, H = {}, None, None
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if "#" in line or not line.strip():
                continue
            parts = line.strip().split(" ")
            frame = int(parts[0][-9:-4])
            fx, fy, cx, cy, W, H = map(float, parts[1:])
            K[frame] = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return K, W, H


def subsample_poses(poses: Dict, subsample: int = 1) -> Dict:
    return {k: v for i, (k, v) in enumerate(poses.items())
            if i % subsample == 0}


def compute_scene_metrics(
    dataset_path: Path, submission: zipfile.ZipFile | Dict, scene: str,
    subsample: int = 5,
) -> Tuple[Dict[str, list], int]:
    """Per-frame metrics for one scene; returns (results, failures)."""
    K, W, H = load_K(Path(dataset_path) / scene / "intrinsics.txt")
    with (Path(dataset_path) / scene / "poses.txt").open(
        "r", encoding="utf-8"
    ) as f:
        gt_poses = load_poses(f, load_confidence=False)

    if isinstance(submission, zipfile.ZipFile):
        try:
            with submission.open(f"pose_{scene}.txt") as fh:
                est = load_poses(
                    io.TextIOWrapper(fh, encoding="utf-8"),
                    load_confidence=True,
                )
        except KeyError:
            return dict(), len(gt_poses)
    else:
        est = submission[scene]

    gt_poses = subsample_poses(gt_poses, subsample=subsample)
    failures = 0
    results = defaultdict(list)
    for frame, (q_gt, t_gt, _) in gt_poses.items():
        if frame not in est:
            failures += 1
            continue
        q_est, t_est, conf = est[frame]
        for k, v in frame_metrics(q_gt, t_gt, q_est, t_est, conf,
                                  K[frame], W, H).items():
            results[k].append(v)
    return results, failures


def evaluate_submission(dataset_path, submission_path, scenes=None,
                        subsample: int = 5) -> Dict[str, float]:
    """Score a submission zip against a dataset split directory."""
    dataset_path = Path(dataset_path)
    if scenes is None:
        scenes = sorted(
            f.name for f in dataset_path.iterdir() if f.is_dir())
    zf = zipfile.ZipFile(submission_path)
    all_results, all_failures = {}, 0
    for scene in scenes:
        res, fails = compute_scene_metrics(dataset_path, zf, scene,
                                           subsample)
        if res:
            all_results[scene] = res
        all_failures += fails
    return aggregate_results(all_results, all_failures)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Map-free benchmark scorer")
    p.add_argument("submission_path")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--split", default="val")
    args = p.parse_args(argv)
    out = evaluate_submission(
        Path(args.dataset_path) / args.split, args.submission_path)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
