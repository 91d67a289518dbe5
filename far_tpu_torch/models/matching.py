"""Coarse matching with static top-k selection.

Counterpart of ``far_tpu/models/matching.py``. In eval the row/column
reductions of the dual-softmax confidences come from kernel K2
(``ops/matching_kernel.py``) without storing the (L, S) matrix; in
training (``return_conf``) the dense (B, L, S) matrix is computed in
plain torch, as the loss needs it, and K2 does not run. Either way the
border, threshold and mutual-nearest-neighbour tests and a static top-k
over rows make exactly K match slots per pair. The Sinkhorn option
(``log_sinkhorn``, ``sinkhorn_confidence``: optimal transport with a
learned dustbin) is plain torch in both modes, as in the JAX package, and
goes through the dense selection; K2 does not run on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol
from far_tpu_torch.utils.config import MatchConfig

MASKED = -1e9  # the log score of a padded slot


def border_mask(h: int, w: int, b: int, device=None) -> torch.Tensor:
    """(h*w,) bool mask, False within b cells of the image border."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    ok = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    return ok.reshape(-1)


def ids_to_coords(ids: torch.Tensor, w: int, scale: float,
                  rescale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grid index -> pixel coordinates <x, y> at original resolution."""
    x = (ids % w).float() * scale
    y = torch.div(ids, w, rounding_mode="floor").float() * scale
    pts = torch.stack([x, y], dim=-1)
    if rescale is not None:  # per-pair resize factor (B, 2)
        pts = pts * rescale[:, None, :]
    return pts


def topk_stable(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``jax.lax.top_k``'s slot order: the
    lower index first among equal scores (every empty slot scores 0)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dual_softmax_confidence(feat0: torch.Tensor, feat1: torch.Tensor,
                            temperature: float) -> torch.Tensor:
    """conf = softmax_rows(sim) * softmax_cols(sim), sim = <f0, f1> / C / T
    (each side scaled by C^-1/2 first). Returns (B, L, S) float32."""
    C = feat0.shape[-1]
    f0 = (feat0 / C ** 0.5).float()
    f1 = (feat1 / C ** 0.5).float()
    sim = torch.einsum("nlc,nsc->nls", f0, f1) / temperature
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def log_sinkhorn(scores: torch.Tensor, bin_score: torch.Tensor, iters: int,
                 valid0: Optional[torch.Tensor] = None,
                 valid1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-domain Sinkhorn with a dustbin row and column (SuperGlue's).

    scores (B, L, S) float32, bin_score a scalar -> the (B, L+1, S+1) log
    assignment matrix after ``iters`` row/column normalisations. The
    marginals are SuperGlue's over m valid rows and n valid columns (the
    masks ``valid0`` (B, L) and ``valid1`` (B, S), all true by default,
    the JAX package's form): 1 / (m + n) a slot, n / (m + n) the dustbin
    row, m / (m + n) the dustbin column. A padded slot's log mass and
    dustbin entries are ``MASKED`` (``scores`` must be ``MASKED`` where
    either slot is padded), so every iteration on the valid slots is
    magicleap's ``log_optimal_transport`` on them alone."""
    B, L, S = scores.shape
    if valid0 is None:
        valid0 = scores.new_ones((B, L), dtype=torch.bool)
    if valid1 is None:
        valid1 = scores.new_ones((B, S), dtype=torch.bool)
    b = bin_score.to(scores.dtype).expand(B, 1, 1)
    bins0 = torch.where(valid0[..., None], b.expand(B, L, 1), MASKED)
    bins1 = torch.where(valid1[:, None], b.expand(B, 1, S), MASKED)
    couplings = torch.cat([torch.cat([scores, bins0], dim=2),
                           torch.cat([bins1, b], dim=2)], dim=1)
    m = valid0.sum(-1, keepdim=True).to(scores.dtype)
    n = valid1.sum(-1, keepdim=True).to(scores.dtype)
    norm = -(m + n).log()
    log_mu = torch.cat([torch.where(valid0, norm, MASKED), n.log() + norm], 1)
    log_nu = torch.cat([torch.where(valid1, norm, MASKED), m.log() + norm], 1)
    u = scores.new_zeros((B, L + 1))
    v = scores.new_zeros((B, S + 1))
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[..., None]


def sinkhorn_confidence(feat0: torch.Tensor, feat1: torch.Tensor,
                        bin_score: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """The Sinkhorn confidence matrix (B, L, S) float32 of sim = <f0, f1> / C
    (each side scaled by C^-1/2 first), the dustbin row and column
    dropped."""
    C = feat0.shape[-1]
    f0 = (feat0 / C ** 0.5).float()
    f1 = (feat1 / C ** 0.5).float()
    sim = torch.einsum("nlc,nsc->nls", f0, f1)
    return torch.exp(log_sinkhorn(sim, bin_score, iters))[:, :-1, :-1]


def select_topk_matches(conf: torch.Tensor, hw0: Tuple[int, int],
                        hw1: Tuple[int, int], cfg: MatchConfig):
    """Static-K mutual-NN match selection from a dense confidence matrix.

    Returns (i_ids, j_ids, mconf, valid), all (B, K)."""
    L = conf.shape[1]
    bm0 = border_mask(*hw0, cfg.border_rm, device=conf.device)
    bm1 = border_mask(*hw1, cfg.border_rm, device=conf.device)
    mutual = (conf == conf.amax(dim=2, keepdim=True)) \
        & (conf == conf.amax(dim=1, keepdim=True))
    ok = mutual & (conf > cfg.thr) & bm0[None, :, None] & bm1[None, None, :]
    score = torch.where(ok, conf, torch.zeros_like(conf))
    row_score, j_ids = score.max(dim=2)   # first index among ties, as argmax
    k = min(cfg.max_matches, L)
    mconf, i_ids = topk_stable(row_score, k)
    return i_ids, torch.gather(j_ids, 1, i_ids), mconf, mconf > 0.0


def select_topk_matches_streamed(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    hw0: Tuple[int, int],
    hw1: Tuple[int, int],
    cfg: MatchConfig,
):
    """Static-K mutual-NN match selection from K2's row/column reductions.

    Returns (i_ids, j_ids, mconf, valid), all (B, K)."""
    B, L, C = feat0.shape
    scale = torch.tensor(1.0 / C ** 0.5, dtype=torch.float32).to(torch.bfloat16)
    # rounded to bf16 even in an f32 model, as the JAX package does; a CPU
    # scalar multiplies a CUDA tensor without a copy to the card
    f0 = (feat0.to(torch.bfloat16) * scale).contiguous()
    f1 = (feat1.to(torch.bfloat16) * scale).contiguous()
    row_val, row_idx, col_max = dual_softmax_rowcol(
        f0, f1, 1.0 / cfg.dsmax_temperature)

    bm0 = border_mask(*hw0, cfg.border_rm, device=feat0.device)
    bm1 = border_mask(*hw1, cfg.border_rm, device=feat0.device)
    cm_at = torch.gather(col_max, 1, row_idx)
    ok = (row_val >= cm_at) & (row_val > cfg.thr) & bm0[None, :] & bm1[row_idx]
    score = torch.where(ok, row_val, torch.zeros_like(row_val))
    k = min(cfg.max_matches, L)
    mconf, i_ids = topk_stable(score, k)
    j_ids = torch.gather(row_idx, 1, i_ids)
    valid = mconf > 0.0
    return i_ids, j_ids, mconf, valid


def coarse_match(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    hw0: Tuple[int, int],
    hw1: Tuple[int, int],
    coarse_scale: float,
    cfg: MatchConfig,
    scale0: Optional[torch.Tensor] = None,
    scale1: Optional[torch.Tensor] = None,
    return_conf: bool = False,
):
    """Coarse matching stage.

    Returns (i_ids, j_ids, mconf, valid, mkpts0, mkpts1[, conf]): with
    ``return_conf`` (training) through the dense confidence matrix, which
    is returned too; else through K2."""
    conf = None
    if return_conf:
        conf = dual_softmax_confidence(feat0, feat1, cfg.dsmax_temperature)
        i_ids, j_ids, mconf, valid = select_topk_matches(conf, hw0, hw1, cfg)
    else:
        i_ids, j_ids, mconf, valid = select_topk_matches_streamed(
            feat0, feat1, hw0, hw1, cfg)
    mkpts0 = ids_to_coords(i_ids, hw0[1], coarse_scale, scale0)
    mkpts1 = ids_to_coords(j_ids, hw1[1], coarse_scale, scale1)
    mkpts0 = mkpts0 * valid[..., None]
    mkpts1 = mkpts1 * valid[..., None]
    if return_conf:
        return i_ids, j_ids, mconf, valid, mkpts0, mkpts1, conf
    return i_ids, j_ids, mconf, valid, mkpts0, mkpts1
