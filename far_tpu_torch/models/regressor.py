"""FAR pose regressor: epipolar bilinear attention (EMM) + MoE fusion.

Counterpart of ``far_tpu/models/regressor.py`` with the reference's
module names (``emm.cross_attn.qkv``, ``encoder.0``, ``moe_predictor.4``,
...). The dual-softmax bilinear form v^T (softmax_r(S) * softmax_c(S)) v
is kernel K4 (``ops/bilinear_attention.py``), called twice per pair
through ``bilinear_dual_softmax_auto``, which gives it a gradient.
Parameters stay float32 and are cast to the activations' dtype where
they are used, as Flax does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.models.constants import pose_stat
from far_tpu_torch.models.transformer import LocalFeatureTransformer
from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_auto
from far_tpu_torch.utils.config import RegressConfig
from far_tpu_torch.utils.tables import device_table


def lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """nn.Linear computed in x's dtype."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), b)


def ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """nn.LayerNorm with f32 statistics, output in x's dtype."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(x.dtype)


@functools.lru_cache(maxsize=8)
def epipolar_positional_basis(h: int = 60, w: int = 80,
                              fx: float = 517.0 / 9.0,
                              fy: float = 517.0 / 8.0,
                              cx: float = 40.0, cy: float = 30.0,
                              xy_first: bool = False) -> np.ndarray:
    """6-dim epipolar basis per coarse cell, in y-major token order, from
    the K^-1-normalized grid coordinates: [y^2, x^2, xy, y, x, 1] (mp3d),
    or with ``xy_first`` [x^2, y^2, xy, x, y, 1] (the 8-point ViT's
    trained convention).

    Returns (h*w, 6) float32."""
    hpix, wpix = cy * 2.0, cx * 2.0
    fx_norm = (fx / wpix) * 2.0
    fy_norm = (fy / hpix) * 2.0
    us = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    vs = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    x = np.tile(us[None, :], (h, 1)) / fx_norm
    y = np.tile(vs[:, None], (1, w)) / fy_norm
    if xy_first:
        feats = [x * x, y * y, x * y, x, y, np.ones_like(x)]
    else:
        feats = [y * y, x * x, x * y, y, x, np.ones_like(x)]
    return np.stack(feats, axis=-1).reshape(h * w, 6).astype(np.float32)


class CrossAttentionEMM(nn.Module):
    """Epipolar bilinear cross-attention (reference CrossAttention)."""

    def __init__(self, dim: int, num_heads: int,
                 grid_hw: Tuple[int, int] = (60, 80),
                 grid_f: Tuple[float, float] = (517.0 / 9.0, 517.0 / 8.0),
                 basis_xy_first: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.grid_hw = grid_hw
        self.grid_f = grid_f
        self.basis_xy_first = basis_xy_first
        Dv = dim // num_heads + 6
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj_fundamental = nn.Linear(num_heads * Dv, dim)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        B, N, C = x1.shape
        H = self.num_heads
        D = C // H
        Dv = D + 6
        dt = x1.dtype

        def split(x):
            t = lin(self.qkv, x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
            return t[0].contiguous(), t[1].contiguous(), t[2]

        q1, k1, v1 = split(x1)
        q2, k2, v2 = split(x2)
        h, w = self.grid_hw
        fx, fy = self.grid_f
        pos = device_table(epipolar_positional_basis, h, w, fx, fy, w / 2.0, h / 2.0,
                           self.basis_xy_first, device=x1.device, dtype=dt)
        pos = pos[None, None].expand(B, H, N, 6)
        v1p = torch.cat([v1, pos], dim=-1).contiguous()
        v2p = torch.cat([v2, pos], dim=-1).contiguous()
        # f1: image-2 queries over image-1 keys and values; f2 the reverse
        f1 = bilinear_dual_softmax_auto(q2, k1, v1p, D ** -0.5)  # (B, H, Dv, Dv)
        f2 = bilinear_dual_softmax_auto(q1, k2, v2p, D ** -0.5)

        def proj(fh):
            fh = fh.to(dt).reshape(B, H * Dv, Dv).transpose(-1, -2)
            return lin(self.proj_fundamental, fh)   # (B, Dv, C)

        return proj(f2), proj(f1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin(self.fc2, F.gelu(lin(self.fc1, x)))


class CrossBlockEMM(nn.Module):
    """Norm + EMM cross-attention + MLP residual (reference CrossBlock).

    The defaults are mp3d's (LayerNorm eps 1e-5, basis [y^2, x^2, ...]);
    ViTEss's block takes ``ln_eps=1e-6`` (timm's) and ``basis_xy_first``."""

    def __init__(self, dim: int, num_heads: int,
                 grid_hw: Tuple[int, int] = (60, 80),
                 grid_f: Tuple[float, float] = (517.0 / 9.0, 517.0 / 8.0),
                 use_pos_embedding: bool = False, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-5, basis_xy_first: bool = False):
        super().__init__()
        if use_pos_embedding:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, grid_hw[0] * grid_hw[1], dim))
        else:
            self.pos_embed = None
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.cross_attn = CrossAttentionEMM(dim, num_heads, grid_hw, grid_f,
                                            basis_xy_first)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor) -> torch.Tensor:
        if self.pos_embed is not None:
            pe = self.pos_embed.to(feat0.dtype)
            feat0 = feat0 + pe
            feat1 = feat1 + pe
        f1, f2 = self.cross_attn(ln(self.norm1, feat0), ln(self.norm1, feat1))
        fund = torch.cat([f1, f2], dim=1)            # (B, 2*Dv, C)
        return fund + self.mlp(ln(self.norm2, fund))


def _seq(*dims: int) -> nn.Sequential:
    """Linear, ReLU, Linear, ... (reference index layout 0, 2, 4)."""
    mods = []
    for i in range(len(dims) - 1):
        if i:
            mods.append(nn.ReLU())
        mods.append(nn.Linear(dims[i], dims[i + 1]))
    return nn.Sequential(*mods)


def run_seq(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A ``_seq`` MLP computed in x's dtype."""
    for m in seq:
        x = lin(m, x) if isinstance(m, nn.Linear) else torch.relu(x)
    return x


class PoseRegressorEMM(nn.Module):
    """LocalFeatureTransformerRegressor: EMM + encoder + MoE gating."""

    def __init__(self, cfg: RegressConfig, grid_hw: Tuple[int, int] = (60, 80)):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_model
        if cfg.num_loftr_layers > 0:
            self.loftr = LocalFeatureTransformer(
                C, cfg.nhead_stack,
                tuple(cfg.layer_names) * cfg.num_loftr_layers, attention=cfg.attention)
        self.emm = CrossBlockEMM(C, cfg.emm_heads, grid_hw,
                                 (cfg.grid_fx, cfg.grid_fy),
                                 cfg.use_pos_embedding)
        self.norm = nn.LayerNorm(C, eps=1e-6)
        feat = 2 * (C // cfg.emm_heads + 6) * C
        hid = cfg.hidden
        n_solver_in = (9 + int(cfg.use_num_corres)
                       + 3 * int(cfg.use_many_ransac_thr))
        if cfg.use_simple_moe:
            n_wt = 1 if cfg.use_1wt else (2 if cfg.use_2wt else 9)
            self.encoder = _seq(feat, hid, hid)
            self.pose_regressor_simple_moe = _seq(hid, hid, 9)
            self.moe_predictor = _seq(feat + 9 + n_solver_in, hid, hid, n_wt)
        else:
            self.pose_regressor = _seq(feat, hid, hid, 9)

    def features_only(self, feat0: torch.Tensor, feat1: torch.Tensor):
        """EMM bilinear features, flattened (B, 2*Dv*C); solver-independent."""
        B = feat0.shape[0]
        if self.cfg.num_loftr_layers > 0:
            feat0, feat1 = self.loftr(feat0, feat1)
        x = ln(self.norm, self.emm(feat0, feat1))
        return x.reshape(B, -1)

    def fuse(self, features: torch.Tensor,
             solver_pose_in: Optional[torch.Tensor] = None):
        """Pose regression + MoE gating -> (pose_9d, gate)."""
        cfg = self.cfg
        if not cfg.use_simple_moe:
            return run_seq(self.pose_regressor, features).float(), None

        enc = run_seq(self.encoder, features)
        pred_reg_9d = run_seq(self.pose_regressor_simple_moe, enc).float()
        if solver_pose_in is None:
            raise ValueError("the MoE path needs the solver pose")
        sp = solver_pose_in.float()
        reg_t = pred_reg_9d[..., :3]
        solver_t = sp[..., :3]
        solver_rot = sp[..., 3:9]
        if cfg.scale_8pt:
            mean_t = pose_stat("mean", sp)[:3]
            std_t = pose_stat("std", sp)[:3]
            solver_t_un = solver_t * std_t + mean_t
            reg_t_un = reg_t * std_t + mean_t
            norm_reg = torch.linalg.norm(reg_t_un, dim=-1, keepdim=True)
            norm_sol = torch.linalg.norm(solver_t_un, dim=-1,
                                         keepdim=True).clamp(1e-3, 100.0)
            solver_t = (solver_t_un * norm_reg / norm_sol - mean_t) / std_t

        gate_in = torch.cat([features.float(), pred_reg_9d, sp], dim=-1)
        gate = torch.sigmoid(run_seq(self.moe_predictor,
                                 gate_in.to(features.dtype))).float()
        if cfg.use_2wt:
            w_t, w_r = gate[..., 0:1], gate[..., 1:2]
        elif cfg.use_1wt:
            w_t = w_r = gate[..., 0:1]
        else:
            w_t, w_r = gate[..., :3], gate[..., 3:]
        pred_t = w_t * reg_t + (1.0 - w_t) * solver_t
        pred_r = w_r * pred_reg_9d[..., 3:] + (1.0 - w_r) * solver_rot
        return torch.cat([pred_t, pred_r], dim=-1), gate
