"""Plain dataclasses passed between the stages of the port.

Counterparts of ``far_tpu/types.py``, with the same fields and layouts:
images are (B, H, W, 1) in [0, 1], match sets hold exactly K slots with
a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class PairBatch:
    """A batch of image pairs; NHWC grayscale images in [0, 1]. Depth and
    pose are needed only for training's supervision."""

    image0: torch.Tensor                     # (B, H, W, 1)
    image1: torch.Tensor                     # (B, H, W, 1)
    K0: torch.Tensor                         # (B, 3, 3)
    K1: torch.Tensor                         # (B, 3, 3)
    T_0to1: Optional[torch.Tensor] = None    # (B, 4, 4) or (B, 3, 4)
    T_1to0: Optional[torch.Tensor] = None
    depth0: Optional[torch.Tensor] = None    # (B, H, W)
    depth1: Optional[torch.Tensor] = None
    scale0: Optional[torch.Tensor] = None    # (B, 2) resize scale <w, h>
    scale1: Optional[torch.Tensor] = None
    pair_id: Optional[torch.Tensor] = None   # (B,) int64


@dataclasses.dataclass
class MatchResult:
    """Fixed-size coarse + fine correspondence set (K slots, masked)."""

    i_ids: torch.Tensor     # (B, K) int64 coarse grid index in image 0
    j_ids: torch.Tensor     # (B, K) int64 coarse grid index in image 1
    mconf: torch.Tensor     # (B, K) confidence (0 where invalid)
    valid: torch.Tensor     # (B, K) bool
    mkpts0: torch.Tensor    # (B, K, 2) coarse pixel coords in image 0
    mkpts1: torch.Tensor    # (B, K, 2)
    mkpts0_f: torch.Tensor  # (B, K, 2) refined pixel coords
    mkpts1_f: torch.Tensor  # (B, K, 2)
    expec_f: torch.Tensor   # (B, K, 3) fine <x, y, std> in window units


@dataclasses.dataclass
class MatcherOutput:
    matches: MatchResult
    feat_c0: torch.Tensor   # (B, L, C) transformed coarse features
    feat_c1: torch.Tensor   # (B, S, C)
    conf_matrix: Optional[torch.Tensor] = None        # (B, L, S), training only
    translation_scale: Optional[torch.Tensor] = None  # (B,)


@dataclasses.dataclass
class KeypointMatches:
    """Detected keypoints of both images and their matches (K slots a
    side, masked): SuperPoint's detections and SuperGlue's mutual
    matches, the correspondences in ``MatchResult``'s fields the solver
    reads (``mkpts0_f``, ``mkpts1_f``, ``valid``)."""

    kpts0: torch.Tensor     # (B, K, 2) keypoints <x, y> of image 0
    kpts1: torch.Tensor     # (B, K, 2)
    scores0: torch.Tensor   # (B, K) detection scores
    scores1: torch.Tensor   # (B, K)
    kvalid0: torch.Tensor   # (B, K) bool: a detected keypoint
    kvalid1: torch.Tensor   # (B, K)
    desc0: torch.Tensor     # (B, K, D) float32 unit descriptors
    desc1: torch.Tensor     # (B, K, D)
    matches0: torch.Tensor  # (B, K) int64 index into kpts1, -1 where none
    mconf: torch.Tensor     # (B, K) assignment at the match (0 where none)
    valid: torch.Tensor     # (B, K) bool: slot i of image 0 matched
    mkpts0_f: torch.Tensor  # (B, K, 2) kpts0, zero where not valid
    mkpts1_f: torch.Tensor  # (B, K, 2) the matched kpts1, zero where not valid


@dataclasses.dataclass
class KeypointMatcherOutput:
    matches: KeypointMatches


@dataclasses.dataclass
class SolverSummary:
    """Solver-side scalars fed to the MoE gate (counts, unscaled)."""

    rt: torch.Tensor                # (B, 3, 4) solver pose
    num_before: torch.Tensor        # (B,) matches before RANSAC
    num_after: torch.Tensor         # (B,) inliers after RANSAC
    num_tight: torch.Tensor         # (B,)
    num_ultra_tight: torch.Tensor   # (B,)
    success: torch.Tensor           # (B,) bool


@dataclasses.dataclass
class FarOutput:
    """Final output of one FAR inference step."""

    R: torch.Tensor                 # (B, 3, 3) fused rotation
    t: torch.Tensor                 # (B, 3) fused translation
    solver_rt: torch.Tensor         # (B, 3, 4) last solver pose
    regressed_9d: torch.Tensor      # (B, 9) last regressor output
    prior_rt: torch.Tensor          # (B, 3, 4) prior of the last round
    matches: MatchResult
    num_inliers: torch.Tensor       # (B,)
    success: torch.Tensor           # (B,)
    E: torch.Tensor                 # (B, 3, 3) last solver essential matrix
    gating: Optional[torch.Tensor] = None
    translation_scale: Optional[torch.Tensor] = None  # (B,)


@dataclasses.dataclass
class MapfreeOutput:
    """Final output of one map-free 6DReg inference step."""

    R: torch.Tensor                 # (B, 3, 3) fused rotation
    t: torch.Tensor                 # (B, 3) fused metric translation
    gating: Optional[torch.Tensor]  # (B, 2) MoE gate (t, R); None without solver preds
    regressed_9d: torch.Tensor      # (B, 9) the regressor's (t, 6D) pose before the blend
    solver_rt: torch.Tensor         # (B, 3, 4) last solver pose
    E: torch.Tensor                 # (B, 3, 3) last solver essential matrix
    num_inliers: torch.Tensor       # (B,) last round's counts
    num_tight: torch.Tensor         # (B,)
    num_ultra_tight: torch.Tensor   # (B,)
    matches: Union[MatchResult, KeypointMatches]
