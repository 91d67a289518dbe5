"""Image, depth and pose IO and the datasets' camera conventions.

The port's copy of ``far_tpu/data/io.py`` (after crockwell/far:
mp3d_loftr/src/utils/dataset.py). Images decode through PIL, imported
where a file is read (the card's machine has it; the package imports
none at load). Resizing goes only through the native library
(``far_tpu_torch.data.native``): a build failure raises rather than
resizing another way, which would give other pixels. The pose and
intrinsics conventions are numpy, as the JAX package has them.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from far_tpu_torch.data import native


def _resize(img: np.ndarray, resize_wh: Tuple[int, int]) -> np.ndarray:
    return native.resize_bilinear_u8(img, resize_wh[1], resize_wh[0])


def _decode(path, mode: Optional[str]) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im if mode is None else im.convert(mode))


def read_gray(
    path, resize_wh: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 1], (H, W, 1)."""
    img = _decode(path, "L")
    if resize_wh is not None:
        img = _resize(img, resize_wh)
    return (img.astype(np.float32) / 255.0)[..., None]


def read_color(
    path, resize_wh: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Load an RGB image as float32 in [0, 1], (H, W, 3)."""
    img = _decode(path, "RGB")
    if resize_wh is not None:
        img = _resize(img, resize_wh)
    return img.astype(np.float32) / 255.0


def pad_bottom_right(img: np.ndarray, size_hw: Tuple[int, int]):
    """Zero-pad to (H, W), returning (padded, mask)."""
    H, W = size_hw
    h, w = img.shape[:2]
    out = np.zeros((H, W) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    mask = np.zeros((H, W), bool)
    mask[:h, :w] = True
    return out, mask


def read_mp3d_depth(depth_dir, scene_name, img_name) -> np.ndarray:
    """Matterport depth stored as pickled dict per view (the dataset's
    own format)."""
    view = Path(img_name).stem
    with open(Path(depth_dir) / scene_name / f"{view}.pkl", "rb") as f:
        return np.asarray(pickle.load(f)["depth_sensor"], np.float32)


def get_mp3d_intrinsics() -> np.ndarray:
    """Matterport pinhole intrinsics (sparseplane convention)."""
    f = 517.97
    return np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1.0]], np.float64)


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def get_mp3d_T_0to1(rel_pose: dict) -> np.ndarray:
    """Matterport relative pose with the sparseplane axis-flip.

    rel_pose = {'position': [3], 'rotation': quaternion (w, x, y, z)};
    T = F^-1 [R|t] F with F = diag(1, -1, -1, 1).
    """
    T = np.eye(4)
    T[:3, :3] = _quat_to_matrix_np(rel_pose["rotation"])
    T[:3, 3] = rel_pose["position"]
    F = np.diag([1.0, -1.0, -1.0, 1.0])
    return np.linalg.inv(F) @ T @ F


def get_interiornet_streetlearn_intrinsics() -> np.ndarray:
    """InteriorNet/StreetLearn 640x480 intrinsics."""
    return np.array([[320.0, 0, 320.0], [0, 240.0, 240.0], [0, 0, 1.0]],
                    np.float64)


def rotation_from_viewpoint(rx: float, ry: float) -> np.ndarray:
    """Viewpoint angles -> rotation matrix (InteriorNet convention:
    pitch rx, negated yaw ry)."""
    c1, s1 = np.cos(rx), np.sin(rx)
    c2, s2 = np.cos(-ry), np.sin(-ry)
    return np.array([
        [c2, s1 * s2, c1 * s2],
        [0.0, c1, -s1],
        [-s2, s1 * c2, c1 * c2],
    ])


def relative_rotation_from_viewpoints(vp1, vp2) -> np.ndarray:
    """GT relative rotation R = R2 R1^T from two (x, y) viewpoints."""
    R1 = rotation_from_viewpoint(vp1[0], vp1[1])
    R2 = rotation_from_viewpoint(vp2[0], vp2[1])
    return R2 @ R1.T


def load_mapfree_poses(path) -> dict:
    """poses.txt: 'frame qw qx qy qz tx ty tz' -> {frame: (q, t)} (w2c)."""
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(" ")
            frame = parts[0]
            vals = np.array(list(map(float, parts[1:8])))
            out[frame] = (vals[:4], vals[4:7])
    return out


def correct_intrinsic_scale(K: np.ndarray, scale_x: float,
                            scale_y: float) -> np.ndarray:
    """Rescale a pinhole K for resized pixel coordinates
    x' = scale_x * x, including the half-pixel center shift
    (reference mapfree_6dreg/lib/datasets/utils.py:176-189)."""
    T = np.eye(3)
    T[0, 0], T[0, 2] = scale_x, scale_x / 2 - 0.5
    T[1, 1], T[1, 2] = scale_y, scale_y / 2 - 0.5
    return T @ K


def load_mapfree_intrinsics(path, resize_wh: Optional[Tuple[int, int]] = None
                            ) -> dict:
    """intrinsics.txt: 'frame fx fy cx cy W H' -> {frame: K}.

    With ``resize_wh`` = (w, h), each K is rescaled from the file's
    native (W, H) via correct_intrinsic_scale (reference
    mapfree.py:37-53 read_intrinsics).
    """
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(" ")
            fx, fy, cx, cy, W, H = map(float, parts[1:7])
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
            if resize_wh is not None:
                K = correct_intrinsic_scale(
                    K, resize_wh[0] / W, resize_wh[1] / H)
            out[parts[0]] = K
    return out


def read_depth_png(path) -> np.ndarray:
    """Millimeter uint16 depth PNG -> float32 meters (reference
    mapfree_6dreg/lib/datasets/utils.py:135-139 read_depth_image)."""
    return _decode(path, None).astype(np.float32) / 1000.0


def mapfree_relative_pose(q0, t0, q1, t1) -> np.ndarray:
    """World-to-cam (q, t) pairs -> 4x4 T_0to1 (reference
    mapfree_6dreg/lib/datasets/mapfree.py:152-167)."""
    T0 = np.eye(4)
    T0[:3, :3] = _quat_to_matrix_np(q0)
    T0[:3, 3] = t0
    T1 = np.eye(4)
    T1[:3, :3] = _quat_to_matrix_np(q1)
    T1[:3, 3] = t1
    return T1 @ np.linalg.inv(T0)
