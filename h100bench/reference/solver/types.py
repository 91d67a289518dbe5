# Frozen copy of far_tpu_torch/solvers/types.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Solver inputs and outputs (counterpart of ``far_tpu/solvers/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PoseEstimate:
    """Result of a robust two-view pose solve; all fields batched (B, ...)."""

    E: torch.Tensor            # (B, 3, 3)
    R: torch.Tensor            # (B, 3, 3)
    t: torch.Tensor            # (B, 3) unit norm
    inliers: torch.Tensor      # (B, N) bool
    num_inliers: torch.Tensor  # (B,) matches after RANSAC
    num_tight: torch.Tensor    # (B,) inliers at thr / 10
    num_ultra_tight: torch.Tensor  # (B,) inliers at thr / 100
    success: torch.Tensor      # (B,) bool: enough valid correspondences

    @property
    def rt34(self) -> torch.Tensor:
        """(B, 3, 4) pose matrix [R | t]."""
        return torch.cat([self.R, self.t[..., None]], dim=-1)


@dataclasses.dataclass
class PriorParams:
    """Pose prior for biased sampling and hypothesis scoring."""

    rt: torch.Tensor   # (B, 3, 4) prior pose (t gets unit-normalized)
    pcl: torch.Tensor  # (P, 3) probe point cloud of the transport error
