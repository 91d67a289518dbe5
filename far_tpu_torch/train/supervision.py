"""Ground-truth supervision: the coarse confidence matrix and fine offsets.

Counterpart of ``far_tpu/train/supervision.py``: the coarse grid of each
image is warped into the other by depth and pose, rounded to cells, and
(i, j) is positive where the two warps form a mutual loop; the fine GT is
gathered at the predicted match slots. Both run without gradient (the
trainer calls them under ``torch.no_grad``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from far_tpu_torch.geometry.warp import warp_kpts
from far_tpu_torch.types import PairBatch


def _grid_pts(h: int, w: int, scale: float, B: int, device) -> torch.Tensor:
    """(B, h*w, 2) <x, y> pixel coordinates of the coarse cell corners."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return (torch.stack([gx, gy], dim=-1).reshape(1, h * w, 2) * scale).expand(B, -1, -1)


def coarse_supervision(batch: PairBatch, coarse_hw: Tuple[int, int],
                       coarse_scale: float):
    """(conf_gt (B, L, S) float 0/1, w_pt0 (B, L, 2) image-0 grid warped into
    image 1, pt1 (B, S, 2) image-1 grid), in pixels."""
    if batch.depth0 is None or batch.T_0to1 is None:
        raise ValueError("coarse supervision needs depth0/1 and T_0to1/T_1to0")
    B = batch.image0.shape[0]
    h, w = coarse_hw
    L = h * w
    dev = batch.image0.device
    grid0 = _grid_pts(h, w, coarse_scale, B, dev)
    grid1 = _grid_pts(h, w, coarse_scale, B, dev)
    if batch.scale0 is not None:
        grid0 = grid0 * batch.scale0[:, None, :]
    if batch.scale1 is not None:
        grid1 = grid1 * batch.scale1[:, None, :]
    _, w_pt0 = warp_kpts(grid0, batch.depth0, batch.depth1, batch.T_0to1,
                         batch.K0, batch.K1)
    _, w_pt1 = warp_kpts(grid1, batch.depth1, batch.depth0, batch.T_1to0,
                         batch.K1, batch.K0)
    # warped points to cells (the per-pair resize divided out first)
    w_pt0_c = w_pt0 / coarse_scale
    w_pt1_c = w_pt1 / coarse_scale
    if batch.scale1 is not None:
        w_pt0_c = w_pt0_c / batch.scale1[:, None, :]
    if batch.scale0 is not None:
        w_pt1_c = w_pt1_c / batch.scale0[:, None, :]

    def nearest_index(pts_c):
        r = torch.round(pts_c).to(torch.int32)
        oob = (r[..., 0] < 0) | (r[..., 0] >= w) | (r[..., 1] < 0) | (r[..., 1] >= h)
        idx = (r[..., 0] + r[..., 1] * w).long()
        return torch.where(oob, torch.zeros_like(idx), idx)

    nearest1 = nearest_index(w_pt0_c)   # (B, L) image-0 cell -> image-1 cell
    nearest0 = nearest_index(w_pt1_c)   # (B, S) image-1 cell -> image-0 cell
    loop = torch.gather(nearest0, 1, nearest1)
    correct = loop == torch.arange(L, device=dev)[None]
    correct[:, 0] = False   # cell 0 collects every out-of-image point
    conf_gt = torch.zeros((B, L, L), dtype=torch.float32, device=dev)
    conf_gt.scatter_reduce_(2, nearest1[..., None], correct[..., None].float(), "amax")
    return conf_gt, w_pt0, grid1


def fine_supervision(w_pt0: torch.Tensor, pt1: torch.Tensor, i_ids: torch.Tensor,
                     j_ids: torch.Tensor, fine_scale: float, window: int,
                     scale1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GT sub-cell offsets (B, K, 2) at the predicted match slots:
    (w_pt0[i] - pt1[j]) / fine_scale / (window // 2)."""
    wp = torch.gather(w_pt0, 1, i_ids[..., None].expand(-1, -1, 2))
    p1 = torch.gather(pt1, 1, j_ids[..., None].expand(-1, -1, 2))
    scale = fine_scale if scale1 is None else fine_scale * scale1[:, None, :]
    return (wp - p1) / scale / (window // 2)
