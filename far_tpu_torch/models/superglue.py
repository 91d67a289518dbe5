"""SuperGlue-style attentional matcher with Sinkhorn assignment.

Counterpart of ``far_tpu/models/superglue.py`` (``SuperGlueConfig``,
``_MHA``, ``_GNNLayer``, ``SuperGlueTPU`` as ``SuperGlue``,
``match_pair_superglue``): a keypoint MLP encoder added to the
descriptors, alternating self and cross attention over the K keypoint
tokens of both images (masked to the valid keypoints at -1e9 in
float32), a final projection, the (B, K, K) score matrix, the
log-domain Sinkhorn with a learned dustbin (``models/matching.py:
log_sinkhorn``) over each pair's valid keypoints and a mutual-argmax
selection over a threshold. Sinkhorn's marginals follow magicleap's
``log_optimal_transport`` on the valid keypoints (m and n of them), where
the JAX package counts every slot (K + K): the two agree where every slot
is valid. The keypoint encoder's image size is two Python numbers, so a
request copies nothing from the host (a CUDA graph captures it). The
attention products and the score matrix are plain ``torch.einsum``: the
JAX package computes them outside any Pallas kernel. Module names are
the JAX package's (``kenc_0``, ``self_3.attn.q``, ``cross_3.fc1``,
``final_proj2``); magicleap's Conv1d + BatchNorm1d checkpoints load
through ``utils/convert_weights.py:convert_superglue_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from far_tpu_torch.models.matching import MASKED, log_sinkhorn
from far_tpu_torch.models.regressor import lin

KENC_WIDTHS = (32, 64, 128, 256)  # the keypoint encoder's hidden widths


@dataclasses.dataclass(frozen=True)
class SuperGlueConfig:
    desc_dim: int = 256
    num_layers: int = 9          # self+cross rounds
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    dtype: str = "float32"


class _MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)

    def forward(self, x, source, s_valid):
        B, N, C = x.shape
        h, d = self.heads, C // self.heads
        q = lin(self.q, x).reshape(B, N, h, d).transpose(1, 2)
        k = lin(self.k, source).reshape(B, -1, h, d).transpose(1, 2)
        v = lin(self.v, source).reshape(B, -1, h, d).transpose(1, 2)
        logits = (torch.einsum("bhnd,bhmd->bhnm", q, k) * d ** -0.5).float()
        logits = logits.masked_fill(~s_valid[:, None, None, :], MASKED)
        a = torch.softmax(logits, -1).to(x.dtype)
        o = torch.einsum("bhnm,bhmd->bhnd", a, v).transpose(1, 2)
        return lin(self.merge, o.reshape(B, N, C))


class _GNNLayer(nn.Module):
    """x + fc2(relu(fc1([x, attn(x, source)])))."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = _MHA(dim, heads)
        self.fc1 = nn.Linear(2 * dim, 2 * dim)
        self.fc2 = nn.Linear(2 * dim, dim)

    def forward(self, x, source, s_valid):
        y = torch.cat([x, self.attn(x, source, s_valid)], -1)
        return x + lin(self.fc2, torch.relu(lin(self.fc1, y)))


class SuperGlue(nn.Module):
    """Counterpart of ``SuperGlueTPU``."""

    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.desc_dim
        widths = (3,) + KENC_WIDTHS + (D,)
        for i in range(len(widths) - 1):
            self.add_module(f"kenc_{i}", nn.Linear(widths[i], widths[i + 1]))
        for i in range(cfg.num_layers):
            self.add_module(f"self_{i}", _GNNLayer(D, cfg.num_heads))
            self.add_module(f"cross_{i}", _GNNLayer(D, cfg.num_heads))
        self.final_proj = nn.Linear(D, D)
        self.final_proj2 = nn.Linear(D, D)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def _encode(self, kpts, scores, desc, image_hw, dt):
        H, W = image_hw
        # 0.7 * max(W, H) rounded once to float32, as a float32 product
        scale = float(torch.tensor(0.7, device="cpu") * max(W, H))
        p = torch.stack([kpts[..., 0] - W / 2, kpts[..., 1] - H / 2], -1) / scale
        enc = torch.cat([p, scores[..., None]], -1).to(dt)
        n = len(KENC_WIDTHS) + 1
        for i in range(n):
            enc = lin(getattr(self, f"kenc_{i}"), enc)
            if i < n - 1:
                enc = torch.relu(enc)
        return desc.to(dt) + enc

    def scores(self, kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1,
               image_hw: Tuple[int, int]) -> torch.Tensor:
        """The keypoint encoder, the GNN and the final projections: the
        (B, K, K) float32 score matrix, ``MASKED`` where either keypoint is
        not valid."""
        cfg = self.cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        x0 = self._encode(kpts0, scores0, desc0, image_hw, dt)
        x1 = self._encode(kpts1, scores1, desc1, image_hw, dt)
        for i in range(cfg.num_layers):
            self_l, cross_l = getattr(self, f"self_{i}"), getattr(self, f"cross_{i}")
            x0 = self_l(x0, x0, valid0)
            x1 = self_l(x1, x1, valid1)
            x0, x1 = cross_l(x0, x1, valid1), cross_l(x1, x0, valid0)

        f0 = lin(self.final_proj, x0).float()
        f1 = lin(self.final_proj2, x1).float()
        scores = torch.einsum("bnd,bmd->bnm", f0, f1) / cfg.desc_dim ** 0.5
        return scores.masked_fill(~(valid0[:, :, None] & valid1[:, None, :]), MASKED)

    def transport(self, scores, valid0, valid1) -> torch.Tensor:
        """Sinkhorn over the valid keypoints: the assignment (B, K, K)
        float32 without its dustbins."""
        Z = log_sinkhorn(scores, self.bin_score, self.cfg.sinkhorn_iterations, valid0, valid1)
        return torch.exp(Z)[:, :-1, :-1]

    def assignment(self, kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1,
                   image_hw: Tuple[int, int]) -> torch.Tensor:
        """The Sinkhorn assignment (B, K, K) float32 without its dustbins."""
        s = self.scores(kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1, image_hw)
        return self.transport(s, valid0, valid1)

    def forward(self, kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1,
                image_hw: Tuple[int, int]):
        """Returns (matches0 (B, K) int32: an index into kpts1 or -1,
        mscores0 (B, K) float32 confidence)."""
        P = self.assignment(kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1,
                            image_hw)
        return select_matches(P, valid0, self.cfg.match_threshold)


def select_matches(P: torch.Tensor, valid0: torch.Tensor, threshold: float):
    """Mutual argmax of the assignment (the first maximum on ties, as
    ``jnp.argmax``) over ``threshold`` -> (matches0 int32, mscores0)."""
    j = P.argmax(dim=2)
    i_back = P.argmax(dim=1)
    arange = torch.arange(P.shape[1], device=P.device)[None]
    mutual = torch.gather(i_back, 1, j) == arange
    conf = P.amax(dim=2)
    ok = mutual & (conf > threshold) & valid0
    matches0 = torch.where(ok, j, torch.full_like(j, -1)).int()
    return matches0, torch.where(ok, conf, torch.zeros_like(conf))


def match_pair_superglue(sp_model, sg_model, image0: torch.Tensor, image1: torch.Tensor):
    """Detector + matcher on a (B, H, W, 1) pair -> padded correspondences
    (pts0 (B, K, 2), pts1 (B, K, 2), valid (B, K)), zero where not valid."""
    k0, s0, v0, d0 = sp_model(image0)
    k1, s1, v1, d1 = sp_model(image1)
    m0, _ = sg_model(k0, s0, v0, d0, k1, s1, v1, d1, image_hw=tuple(image0.shape[1:3]))
    ok = m0 >= 0
    pts1 = torch.gather(k1, 1, m0.clamp(min=0).long()[..., None].expand(-1, -1, 2))
    return k0 * ok[..., None], pts1 * ok[..., None], ok
