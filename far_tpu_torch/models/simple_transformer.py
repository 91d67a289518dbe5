"""SimpleTransformer: the correspondence-token pose regression baseline.

Counterpart of ``far_tpu/models/simple_transformer.py``
(``SimpleTransformerConfig``, ``nerf_positional_encoding``,
``SimpleTransformer``; after crockwell/far:
mp3d_loftr/src/baselines/simple_transformer.py): a NeRF-style frequency
encoding of each match's four coordinates (optionally with per-match
features), a post-LN transformer encoder over the K match tokens
(``models/sixdreg.py:TorchTransformerEncoderLayer``), an average pool over
the valid tokens, and the FAR head's MoE fusion with the solver pose.
As in the JAX package, padding tokens are zeroed before the encoder but
not masked inside its attention, so they still move the valid tokens a
little. Plain torch: no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from far_tpu_torch.models.constants import compute_normalized_6d
from far_tpu_torch.models.regressor import lin
from far_tpu_torch.models.sixdreg import TorchTransformerEncoderLayer

MATCH_FEAT_DIM = 2 * 256  # per-match features: (B, K, 2, 256) LoFTR features


@dataclasses.dataclass(frozen=True)
class SimpleTransformerConfig:
    feat_size: int = 256
    num_heads: int = 8
    num_layers: int = 6
    num_bands: int = 10            # NeRF frequency bands
    use_pos_encoding: bool = True
    use_feats: bool = False        # append per-match LoFTR features
    cat_feats: bool = False
    use_2wt: bool = True
    use_1wt: bool = False
    scale_8pt: bool = True
    use_num_corres: bool = True
    hidden: int = 512
    dtype: str = "float32"


def nerf_positional_encoding(x: torch.Tensor, num_bands: int) -> torch.Tensor:
    """[x, sin(2^k x), cos(2^k x)] for k in 0..num_bands-1."""
    parts = [x]
    for f in 2.0 ** np.arange(num_bands, dtype=np.float32):
        parts.append(torch.sin(x * float(f)))
        parts.append(torch.cos(x * float(f)))
    return torch.cat(parts, dim=-1)


class SimpleTransformer(nn.Module):
    def __init__(self, cfg: SimpleTransformerConfig):
        super().__init__()
        self.cfg = cfg
        F_ = cfg.feat_size
        pos_in = 4 * (1 + 2 * cfg.num_bands) if cfg.use_pos_encoding else 4
        self.pos_proj = nn.Linear(pos_in, F_ * 3 // 4 if cfg.cat_feats else F_)
        if cfg.use_feats:
            enc = F_ // 4 if cfg.cat_feats else F_
            self.feat_enc_0 = nn.Linear(MATCH_FEAT_DIM, enc)
            self.feat_enc_1 = nn.Linear(enc, enc)
        self.encoder = nn.ModuleList(
            [TorchTransformerEncoderLayer(F_, cfg.num_heads) for _ in range(cfg.num_layers)])
        n_sp = 9 + int(cfg.use_num_corres)
        H = cfg.hidden
        self.moe_enc_0 = nn.Linear(F_, H)
        self.moe_enc_1 = nn.Linear(H, H)
        self.pose_0 = nn.Linear(H, H)
        self.pose_1 = nn.Linear(H, 9)
        self.moe_0 = nn.Linear(F_ + 9 + n_sp, H)
        self.moe_1 = nn.Linear(H, H)
        self.moe_2 = nn.Linear(H, 1 if cfg.use_1wt else (2 if cfg.use_2wt else 9))

    def forward(self, corr: torch.Tensor, valid: torch.Tensor, solver_rt: torch.Tensor,
                num_corr: torch.Tensor, feats: Optional[torch.Tensor] = None):
        """corr (B, K, 2, 2) match coordinates <x, y> in each image, valid
        (B, K) bool, solver_rt (B, 3, 4), num_corr (B,), feats optional
        (B, K, 2, 256) -> (fused normalised 9D pose (B, 9), gate)."""
        cfg = self.cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        dense = lambda m, x: lin(m, x.to(dt))  # Flax's Dense(dtype=dt)
        B, K = corr.shape[:2]
        pos = corr.reshape(B, K, 4).float()
        if cfg.use_pos_encoding:
            pos = nerf_positional_encoding(pos, cfg.num_bands)
        src = dense(self.pos_proj, pos)
        if cfg.use_feats and feats is not None:
            f = dense(self.feat_enc_1, torch.relu(dense(self.feat_enc_0, feats.reshape(B, K, -1))))
            src = torch.cat([src, f], -1) if cfg.cat_feats else src + f

        x = src * valid[..., None].to(dt)
        for layer in self.encoder:
            x = layer(x)
        vf = valid.float()[..., None]
        pooled = (x.float() * vf).sum(dim=1) / (vf.sum(dim=1) + 1e-6)

        sp = compute_normalized_6d(solver_rt)
        if cfg.use_num_corres:
            sp = torch.cat([sp, num_corr[..., None] / 500.0], -1)
        enc = dense(self.moe_enc_1, torch.relu(dense(self.moe_enc_0, pooled)))
        pred = dense(self.pose_1, torch.relu(dense(self.pose_0, enc))).float()
        gin = torch.cat([pooled, pred, sp.float()], -1)
        g = torch.relu(dense(self.moe_1, torch.relu(dense(self.moe_0, gin))))
        gate = torch.sigmoid(dense(self.moe_2, g)).float()

        sp_t = sp[..., :3]
        if cfg.scale_8pt:
            sp_t = sp_t * (torch.linalg.norm(pred[..., :3], dim=-1, keepdim=True)
                           / (torch.linalg.norm(sp_t, dim=-1, keepdim=True) + 1e-8))
        if cfg.use_2wt:
            w_t, w_r = gate[..., :1], gate[..., 1:2]
        elif cfg.use_1wt:
            w_t = w_r = gate[..., :1]
        else:
            w_t, w_r = gate[..., :3], gate[..., 3:]
        t = w_t * pred[..., :3] + (1 - w_t) * sp_t
        r = w_r * pred[..., 3:] + (1 - w_r) * sp[..., 3:9]
        return torch.cat([t, r], -1), gate
