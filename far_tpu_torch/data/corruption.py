"""Correspondence corruption ablations.

The port's copy of ``far_tpu/data/corruption.py`` (after crockwell/far:
mp3d_loftr/src/datasets/mp3d.py:269-298): the robustness study's fault
injection on cached correspondences (outlier replacement, pixel noise,
missing matches, random dropout), numpy, the same draws from the same
``np.random.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def corrupt_correspondences(
    corr: np.ndarray,
    valid: np.ndarray,
    rng: np.random.Generator,
    outlier_pct: float = 0.0,
    noise_pix: float = 0.0,
    missing_pct: float = 0.0,
    corr_dropout: float = 0.0,
    image_hw: Tuple[int, int] = (480, 640),
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the four reference ablations to a padded match set.

    Args:
        corr: (K, 2, 2) matches <x, y> per image.
        valid: (K,) bool.
    Returns:
        (corr, valid) corrupted copies.
    """
    corr = corr.copy()
    valid = valid.copy()
    K = len(corr)
    H, W = image_hw
    idx = np.where(valid)[0]

    if outlier_pct > 0 and len(idx):
        n = int(round(len(idx) * outlier_pct))
        sel = rng.choice(idx, size=n, replace=False)
        corr[sel, 1, 0] = rng.uniform(0, W, size=n)
        corr[sel, 1, 1] = rng.uniform(0, H, size=n)

    if noise_pix > 0 and len(idx):
        corr[idx, 1] += rng.normal(0, noise_pix, size=(len(idx), 2))
        corr[idx, 1, 0] = np.clip(corr[idx, 1, 0], 0, W - 1)
        corr[idx, 1, 1] = np.clip(corr[idx, 1, 1], 0, H - 1)

    if missing_pct > 0 and len(idx):
        n = int(round(len(idx) * missing_pct))
        sel = rng.choice(idx, size=n, replace=False)
        valid[sel] = False

    if corr_dropout > 0 and len(idx):
        drop = rng.uniform(size=len(idx)) < corr_dropout
        valid[idx[drop]] = False

    corr[~valid] = 0.0
    return corr, valid
