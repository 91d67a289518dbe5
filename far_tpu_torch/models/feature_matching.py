"""Precomputed correspondences for the classical map-free baseline.

Counterpart of ``pad_matches`` and ``PrecomputedMatching`` in
``far_tpu/models/feature_matching.py``: matches stored per pair in an
``.npz`` store, padded to a static (K, 2) shape with a mask so they go
into the static-shape solvers unchanged. (The JAX package's
``SIFTMatching`` rides OpenCV on the host and is not ported.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_matches(pts0: np.ndarray, pts1: np.ndarray,
                max_matches: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The first ``max_matches`` of each (N, 2), zero-padded, and the (K,) mask."""
    k = min(len(pts0), max_matches)
    out0 = np.zeros((max_matches, 2), np.float32)
    out1 = np.zeros((max_matches, 2), np.float32)
    valid = np.zeros(max_matches, bool)
    out0[:k] = pts0[:k]
    out1[:k] = pts1[:k]
    valid[:k] = True
    return out0, out1, valid


class PrecomputedMatching:
    """Correspondences looked up in an ``.npz`` store:
    ``np.savez(path, **{f"{name0}-{name1}": (N, 4) rows [x0, y0, x1, y1]})``,
    the layout of the reference's correspondence files. A pair missing
    from the store has no valid match."""

    def __init__(self, npz_path, max_matches: int = 1024):
        self.store = np.load(npz_path, allow_pickle=True)
        self.max_matches = max_matches

    def match(self, name0: str, name1: str):
        key = f"{name0}-{name1}"
        if key not in self.store:
            empty = np.zeros((0, 2), np.float32)
            return pad_matches(empty, empty, self.max_matches)
        corr = np.asarray(self.store[key], np.float32)
        return pad_matches(corr[:, :2], corr[:, 2:4], self.max_matches)
