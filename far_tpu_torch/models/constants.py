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
from far_tpu_torch.utils.tables import device_table

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


def _pose_stat_table(name: str) -> np.ndarray:
    return {"mean": POSE_MEAN_6D, "std": POSE_STD_6D}[name]


def pose_stat(name: str, like: torch.Tensor) -> torch.Tensor:
    """``POSE_MEAN_6D`` (``"mean"``) or ``POSE_STD_6D`` (``"std"``) on
    ``like``'s device in its dtype, one cached tensor per (device, dtype)."""
    return device_table(_pose_stat_table, name, device=like.device, dtype=like.dtype)


def compute_normalized_6d(pose34: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) pose -> normalized 9D (t, first two rotation rows)."""
    raw = torch.cat([pose34[..., :3, 3],
                     matrix_to_rotation_6d(pose34[..., :3, :3])], dim=-1)
    return (raw - pose_stat("mean", raw)) / pose_stat("std", raw)


def denormalize_9d(pose9d: torch.Tensor) -> torch.Tensor:
    """Normalized 9D -> (..., 3, 4) pose matrix."""
    raw = pose9d * pose_stat("std", pose9d) + pose_stat("mean", pose9d)
    R = rotation_6d_to_matrix(raw[..., 3:])
    return torch.cat([R, raw[..., :3, None]], dim=-1)
