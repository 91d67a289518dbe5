"""Per-scene result videos with per-frame pose-error overlays.

Counterpart of ``far_tpu/eval/visualise.py`` (reference:
mapfree_6dreg/lib/utils/visualisation.py:8-80, save_video via
vidgear/ffmpeg). Frames are annotated with OpenCV, imported where it is
used, and written with cv2.VideoWriter (mp4v), falling back to a
directory of PNG frames when no codec opens: the artifact content
(side-by-side pair + green/red metric banner) is the same. Images may
be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Optional

import numpy as np

import torch

from far_tpu_torch.eval.localize import quat_angle_error, vec_angle_error

log = logging.getLogger(__name__)


def _to_uint8_bgr(img) -> np.ndarray:
    """(H, W, C) float [0,1] (NHWC batches, numpy or a tensor) -> uint8 BGR."""
    img = img.detach().float().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img[:, :, ::-1].copy()  # RGB -> BGR


def _annotate(frame: np.ndarray, text: str, good: bool) -> np.ndarray:
    import cv2

    h = frame.shape[0]
    font_size = 1.0 if h > 500 else 0.5
    tx = 100 if h > 500 else 10
    ty = h - 30
    color = (0, 255, 0) if good else (0, 0, 255)
    cv2.putText(frame, text, (tx, ty), cv2.FONT_HERSHEY_DUPLEX,
                font_size, (0, 0, 0), 4, cv2.LINE_AA)
    cv2.putText(frame, text, (tx, ty), cv2.FONT_HERSHEY_DUPLEX,
                font_size, color, 1, cv2.LINE_AA)
    return frame


def _write_scene(odir: str, scene: str, frames: Dict[str, np.ndarray],
                 fps: float) -> str:
    """Write one scene's frames (sorted by name) as mp4, or PNGs if the
    codec is unavailable.  Returns the artifact path."""
    import cv2

    names = sorted(frames)
    h, w = frames[names[0]].shape[:2]
    path = os.path.join(odir, f"{scene}.mp4")
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if writer.isOpened():
        for name in names:
            writer.write(frames[name])
        writer.release()
        return path
    writer.release()
    log.warning("no mp4 codec available; writing PNG frames for %s", scene)
    frame_dir = os.path.join(odir, scene)
    os.makedirs(frame_dir, exist_ok=True)
    for i, name in enumerate(names):
        cv2.imwrite(os.path.join(frame_dir, f"{i:05d}.png"), frames[name])
    return frame_dir


def save_video(save_res_path: str, batches: Iterable[dict], odir: str,
               fps: float = 15.0,
               good_thresholds: tuple = (5.0, 0.25)) -> Dict[str, str]:
    """Generate one annotated video per scene (visualisation.py:8-80).

    Args:
        save_res_path: .npy loc-results dict saved by
            eval_pipeline_with/without_ransac (scene -> test_im -> res).
        batches: iterable of samples with 'scene_id',
            'pair_names' and NHWC float 'image0'/'image1'.
        odir: output directory.
        good_thresholds: (rot deg, trans m) for the green/red banner —
            the reference hardcodes (5, 0.25).
    Returns {scene: artifact path}.
    """
    os.makedirs(odir, exist_ok=True)
    results = np.load(save_res_path, allow_pickle=True).item()
    per_scene: Dict[str, Dict[str, np.ndarray]] = {}
    for data in batches:
        scene = data["scene_id"]
        if isinstance(scene, (list, tuple)):
            scene = scene[0]
        names = data["pair_names"]
        test_img_path = names[1][0] if isinstance(names[1], (list, tuple)) \
            else names[1]
        res: Optional[dict] = None
        scene_res = results.get(scene)
        if scene_res is not None:
            res = scene_res.get(test_img_path)
        if res is not None:
            lbl, pred = res["abs_pose_lbl"], res["abs_pose_pred"]
            r_err = float(quat_angle_error(lbl.q, pred.q).ravel()[0])
            t_ang_err = float(vec_angle_error(lbl.t, pred.t).ravel()[0])
            t_err = float(np.linalg.norm(lbl.c - pred.c))
        else:
            r_err = t_ang_err = t_err = float("inf")

        c0 = _to_uint8_bgr(data["image0"])
        c1 = _to_uint8_bgr(data["image1"])
        frame = np.concatenate([c0, c1], axis=1)
        text = (f"R_err: {r_err:.1f}deg. t_ang_err: {t_ang_err:.1f}deg. "
                f"t_err: {t_err:.2f}m")
        good = (r_err <= good_thresholds[0] and t_err <= good_thresholds[1])
        frame = _annotate(frame, text, good)
        frame = frame[::2, ::2]  # the reference's 0.5x resize
        per_scene.setdefault(scene, {})[test_img_path] = frame

    return {scene: _write_scene(odir, scene, frames, fps)
            for scene, frames in per_scene.items()}
