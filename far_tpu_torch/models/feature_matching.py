"""Precomputed correspondences: the store, and the matcher that fills it.

Counterpart of ``far_tpu/models/feature_matching.py``: matches stored per
pair in an ``.npz`` store (``PrecomputedMatching``), padded to a static
(K, 2) shape with a mask so they go into the static-shape solvers
unchanged; ``precompute_matches`` runs a matcher over a dataset's pairs
into such a store (after crockwell/far:
mapfree_6dreg/etc/feature_matching_baselines/compute.py), and
``loftr_matcher_fn`` is its on-device matcher, ``FARLoFTR.match``.
``SIFTMatching`` is the host baseline (rootSIFT and a ratio test on
OpenCV's native SIFT, imported where it is used), ``superglue_matcher_fn``
the SuperPoint + SuperGlue pair on the models' device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from far_tpu_torch.types import PairBatch


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


class SIFTMatching:
    """rootSIFT + ratio-test matching with OpenCV on the host."""

    def __init__(self, num_features: int = 2048,
                 ratio_threshold: float = 0.8, max_matches: int = 1024):
        import cv2

        self.cv2 = cv2
        self.sift = cv2.SIFT_create(num_features)
        self.ratio = ratio_threshold
        self.max_matches = max_matches

    def _root_sift(self, desc: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if desc is None:
            return None
        desc = desc / (np.abs(desc).sum(axis=1, keepdims=True) + 1e-7)
        return np.sqrt(desc)

    def match(self, img0: np.ndarray, img1: np.ndarray):
        """img: float [0, 1] (H, W[, 1]) or uint8 grayscale -> the padded
        (pts0, pts1, valid) of ``pad_matches``."""
        cv2 = self.cv2

        def prep(im):
            im = np.asarray(im).squeeze()
            if im.dtype != np.uint8:
                im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
            return im

        k0, d0 = self.sift.detectAndCompute(prep(img0), None)
        k1, d1 = self.sift.detectAndCompute(prep(img1), None)
        d0, d1 = self._root_sift(d0), self._root_sift(d1)
        empty = np.zeros((0, 2), np.float32)
        if d0 is None or d1 is None or len(d0) < 2 or len(d1) < 2:
            return pad_matches(empty, empty, self.max_matches)
        knn = cv2.BFMatcher().knnMatch(d0, d1, k=2)
        good = [m for m, n in knn if m.distance < self.ratio * n.distance]
        if not good:
            return pad_matches(empty, empty, self.max_matches)
        pts0 = np.float32([k0[m.queryIdx].pt for m in good])
        pts1 = np.float32([k1[m.trainIdx].pt for m in good])
        return pad_matches(pts0, pts1, self.max_matches)


def precompute_matches(
    dataset, indices, matcher_fn, out_path,
) -> Dict[str, np.ndarray]:
    """Run ``matcher_fn(sample) -> (pts0 (N, 2), pts1 (N, 2))`` over the
    dataset's pairs at ``indices`` and store them as an ``.npz``, one
    (N, 4) array a pair under ``"<name0>-<name1>"``."""
    store = {}
    for i in indices:
        s = dataset[int(i)]
        pts0, pts1 = matcher_fn(s)
        n0, n1 = s["pair_names"]
        store[f"{n0}-{n1}"] = np.concatenate(
            [np.asarray(pts0, np.float32), np.asarray(pts1, np.float32)], -1)
    np.savez_compressed(out_path, **store)
    return store


def loftr_matcher_fn(model) -> Callable:
    """``matcher_fn`` of ``FARLoFTR.match`` on one pair, on the model's
    device under ``torch.inference_mode``: the valid matches' refined
    keypoints, on the host."""
    device = next(model.parameters()).device

    def as_batch(sample):
        t = lambda k: torch.from_numpy(np.asarray(sample[k], np.float32))[None].to(device)
        return PairBatch(image0=t("image0"), image1=t("image1"), K0=t("K0"), K1=t("K1"))

    def fn(sample):
        with torch.inference_mode():
            m = model.match(as_batch(sample)).matches
        valid = m.valid[0].cpu().numpy()
        return (m.mkpts0_f[0].float().cpu().numpy()[valid],
                m.mkpts1_f[0].float().cpu().numpy()[valid])

    return fn


def sift_matcher_fn(max_matches: int) -> Callable:
    """``matcher_fn`` of ``SIFTMatching``: the valid matches on the host."""
    m = SIFTMatching(max_matches=max_matches)

    def fn(sample):
        p0, p1, v = m.match(sample["image0"], sample["image1"])
        return p0[v], p1[v]

    return fn


def superglue_matcher_fn(sp_model, sg_model) -> Callable:
    """``matcher_fn`` of ``match_pair_superglue`` on one pair, on the
    models' device under ``torch.inference_mode``: the matched keypoints,
    on the host."""
    from far_tpu_torch.models.superglue import match_pair_superglue

    device = next(sp_model.parameters()).device

    def fn(sample):
        im = lambda k: torch.from_numpy(np.asarray(sample[k], np.float32))[None].to(device)
        with torch.inference_mode():
            p0, p1, ok = match_pair_superglue(sp_model, sg_model, im("image0"), im("image1"))
        ok = ok[0].cpu().numpy()
        return p0[0].cpu().numpy()[ok], p1[0].cpu().numpy()[ok]

    return fn
