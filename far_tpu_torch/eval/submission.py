"""Map-free submission writer.

The port's copy of ``far_tpu/eval/submission.py`` (after crockwell/far:
mapfree_6dreg/submission.py:44-82): per-frame pose estimates
(world-to-cam quaternion, translation, confidence) collected per scene
and written as the official ``pose_<scene>.txt`` files of a zip.
"""

from __future__ import annotations

import zipfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from far_tpu_torch.geometry.rotations import matrix_to_quaternion


class SubmissionWriter:
    """Accumulate (scene, frame) -> pose records, then zip them."""

    def __init__(self):
        self._scenes: Dict[str, List[str]] = defaultdict(list)

    def add(self, scene: str, frame_path: str, q: np.ndarray,
            t: np.ndarray, confidence: float = 0.0) -> None:
        q = np.asarray(q, np.float64)
        t = np.asarray(t, np.float64)
        if not (np.isfinite(q).all() and np.isfinite(t).all()):
            return  # reference drops NaN/Inf predictions (submission.py:62-63)
        vals = " ".join(f"{v:.6f}" for v in (*q, *t, confidence))
        self._scenes[scene].append(f"{frame_path} {vals}")

    def add_pose_matrix(self, scene: str, frame_path: str, R: np.ndarray,
                        t: np.ndarray, confidence: float = 0.0) -> None:
        """A rotation matrix, as a float32 quaternion (w, x, y, z), w >= 0."""
        q = matrix_to_quaternion(torch.as_tensor(np.asarray(R, np.float32))).numpy()
        self.add(scene, frame_path, q, t, confidence)

    def write(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            for scene, lines in self._scenes.items():
                zf.writestr(f"pose_{scene}.txt", "\n".join(lines) + "\n")
