"""Dataset-level pose normalization constants (Matterport val split).

Counterpart of ``far_tpu/models/constants.py``. Order:
(t_x, t_y, t_z, r_00, r_01, r_02, r_10, r_11, r_12).
"""

from __future__ import annotations

import numpy as np
import torch

from far_tpu_torch.geometry.rotations import (
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)

POSE_MEAN_6D = np.asarray(
    [-0.34898765, 0.17085525, -0.87944315,
     0.50275223, 0.03533648, -0.18179045,
     -0.03533648, 0.98189617, 0.09313615],
    np.float32,
)
POSE_STD_6D = np.asarray(
    [1.94014405, 0.36770130, 1.88317520,
     0.51837117, 0.12717603, 0.65426397,
     0.12717603, 0.0188729, 0.09709263],
    np.float32,
)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def compute_normalized_6d(pose34: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) pose -> normalized 9D (t, first two rotation rows)."""
    raw = torch.cat([pose34[..., :3, 3],
                     matrix_to_rotation_6d(pose34[..., :3, :3])], dim=-1)
    return (raw - _const(POSE_MEAN_6D, raw)) / _const(POSE_STD_6D, raw)


def denormalize_9d(pose9d: torch.Tensor) -> torch.Tensor:
    """Normalized 9D -> (..., 3, 4) pose matrix."""
    raw = pose9d * _const(POSE_STD_6D, pose9d) + _const(POSE_MEAN_6D, pose9d)
    R = rotation_6d_to_matrix(raw[..., 3:])
    return torch.cat([R, raw[..., :3, None]], dim=-1)
