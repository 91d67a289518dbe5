"""Fine-level refinement: window gather, fine transformer, soft-argmax.

Counterpart of ``far_tpu/models/fine.py``. Exactly K windows of W x W
fine-map cells are gathered at the selected matches (masked slots
included), the coarse context is merged in, the fine transformer runs
over the windows (kernel K3, through ``LocalFeatureTransformer``), and a
centre-vs-window soft-argmax refines the match in image 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.models.transformer import LocalFeatureTransformer
from far_tpu_torch.utils.config import FineConfig


def _window_origins(ids: torch.Tensor, wc: int, stride: int):
    y0 = torch.div(ids, wc, rounding_mode="floor") * stride
    x0 = (ids % wc) * stride
    return y0, x0


def gather_windows_pointwise(feat_f: torch.Tensor, ids: torch.Tensor,
                             coarse_hw: Tuple[int, int], stride: int,
                             window: int) -> torch.Tensor:
    """Oracle of ``gather_windows``: per-element clamped gather + zero mask."""
    B, Hf, Wf, C = feat_f.shape
    _, wc = coarse_hw
    r = window // 2
    yc, xc = _window_origins(ids, wc, stride)
    d = torch.arange(-r, r + 1, device=ids.device)
    oy = d.repeat_interleave(window)
    ox = d.repeat(window)
    y = yc[..., None] + oy
    x = xc[..., None] + ox
    inb = (y >= 0) & (y < Hf) & (x >= 0) & (x < Wf)
    idx = (y.clamp(0, Hf - 1) * Wf + x.clamp(0, Wf - 1)).reshape(B, -1)
    flat = feat_f.reshape(B, Hf * Wf, C)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
    out = out.reshape(B, ids.shape[1], window * window, C)
    return out * inb[..., None]


def gather_windows(feat_f: torch.Tensor, ids: torch.Tensor,
                   coarse_hw: Tuple[int, int], stride: int,
                   window: int) -> torch.Tensor:
    """W x W windows of the fine map centred at coarse cells, zero outside.

    Args:
        feat_f: (B, Hf, Wf, C) fine features; ids: (B, K) coarse indices.
    Returns:
        (B, K, W*W, C)
    """
    B, Hf, Wf, C = feat_f.shape
    hc, wc = coarse_hw
    r = window // 2
    K = ids.shape[1]
    Hp, Wp = Hf + 2 * r, Wf + 2 * r
    ph = max(0, stride * (hc - 1) + window - Hp)
    pw = max(0, stride * (wc - 1) + window - Wp)
    fpad = F.pad(feat_f, (0, 0, r, r + pw, r, r + ph))
    y0, x0 = _window_origins(ids, wc, stride)
    ar = torch.arange(window, device=ids.device)
    yy = (y0[..., None] + ar)[:, :, :, None]            # (B, K, W, 1)
    xx = (x0[..., None] + ar)[:, :, None, :]            # (B, K, 1, W)
    bb = torch.arange(B, device=ids.device)[:, None, None, None]
    out = fpad[bb, yy, xx]                              # (B, K, W, W, C)
    return out.reshape(B, K, window * window, C)


class FinePreprocess(nn.Module):
    """Window gather + coarse-context merge (reference fine_preprocess).

    ``merge_feat`` over [window || coarse] runs as a split product, so the
    (B, K, WW, 2C) concat never exists: same weights, same math."""

    def __init__(self, cfg: FineConfig, d_model_c: int):
        super().__init__()
        self.cfg = cfg
        if cfg.concat_coarse_feat:
            self.down_proj = nn.Linear(d_model_c, cfg.d_model)
            self.merge_feat = nn.Linear(2 * cfg.d_model, cfg.d_model)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1, i_ids, j_ids,
                coarse_hw: Tuple[int, int], stride: int):
        W = self.cfg.window_size
        f0 = gather_windows(feat_f0, i_ids, coarse_hw, stride, W)
        f1 = gather_windows(feat_f1, j_ids, coarse_hw, stride, W)
        if not self.cfg.concat_coarse_feat:
            return f0, f1
        dt = f0.dtype
        Cf = self.cfg.d_model
        wd = self.down_proj.weight.to(dt)
        bd = self.down_proj.bias.to(dt)
        wm = self.merge_feat.weight.to(dt)
        bm = self.merge_feat.bias.to(dt)

        def merge(f, c_tok, ids):
            c = torch.gather(c_tok, 1, ids[..., None].expand(-1, -1, c_tok.shape[-1]))
            c = F.linear(c.to(dt), wd, bd)                     # (B, K, Cf)
            ctx = F.linear(c, wm[:, Cf:], bm)                  # (B, K, Cf)
            return F.linear(f, wm[:, :Cf]) + ctx[..., None, :]

        return merge(f0, feat_c0, i_ids), merge(f1, feat_c1, j_ids)


def fine_softargmax(f0t: torch.Tensor, f1t: torch.Tensor,
                    window: int) -> torch.Tensor:
    """Centre-vs-window soft-argmax: expectation and std over the heatmap.

    (B, K, WW, C) x 2 -> (B, K, 3) <x, y, std> in window units."""
    B, K, WW, C = f0t.shape
    center = f0t[:, :, WW // 2, :]
    sim = torch.einsum("bkc,bkrc->bkr", center, f1t) / C ** 0.5
    heatmap = torch.softmax(sim.float(), dim=-1)
    ax = torch.linspace(-1.0, 1.0, window, device=f0t.device)
    grid = torch.stack([ax.repeat(window), ax.repeat_interleave(window)], -1)
    coords = heatmap @ grid                                  # (B, K, 2)
    var = heatmap @ grid ** 2 - coords ** 2
    std = torch.sqrt(var.clamp(min=1e-10)).sum(-1)
    return torch.cat([coords, std[..., None]], dim=-1)


def fine_matching(transformer: LocalFeatureTransformer, f0: torch.Tensor,
                  f1: torch.Tensor, window: int) -> torch.Tensor:
    """``FineMatching``: the fine transformer over the (B, K, WW, C)
    windows of both images, then the soft-argmax -> (B, K, 3)."""
    B, K, WW, C = f0.shape
    f0t, f1t = transformer(f0.reshape(B * K, WW, C), f1.reshape(B * K, WW, C))
    return fine_softargmax(f0t.reshape(B, K, WW, C),
                           f1t.reshape(B, K, WW, C), window)


def fine_coords_to_kpts(expec_f: torch.Tensor, mkpts1_c: torch.Tensor,
                        window: int, fine_scale: float,
                        scale1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mkpts1_f = mkpts1_c + coords * (W // 2) * fine_scale [* scale1]."""
    delta = expec_f[..., :2] * (window // 2) * fine_scale
    if scale1 is not None:
        delta = delta * scale1[:, None, :]
    return mkpts1_c + delta
