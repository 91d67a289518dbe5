"""LoFTR encoder layers and the self/cross attention stack.

Counterpart of ``far_tpu/models/transformer.py``. Every coarse layer runs
through kernel K1 (``ops/loftr_layer.py``, differentiable through
``loftr_layer_auto``); in eval a stack over independent windows (the fine
stage) runs whole through kernel K3 (``ops/fine_layer.py``,
``fine_transformer_auto``). In training the window stack runs layer by
layer on the dense path, as the JAX package does (:192-216): plain torch
over ``models/attention.py``. Module names follow the reference
(``layers.3.q_proj``, ``layers.3.mlp.0``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from far_tpu_torch.models.attention import linear_attention
from far_tpu_torch.ops.fine_layer import fine_transformer_auto
from far_tpu_torch.ops.loftr_layer import loftr_layer_auto


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's dense-path LayerNorm: statistics in float32 (the
    variance as E[x^2] - mu^2), the normalising arithmetic in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    dt = x.dtype
    inv = torch.rsqrt(var + eps).to(dt)
    return (x - mu.to(dt)) * inv * weight.to(dt) + bias.to(dt)


class LoFTREncoderLayer(nn.Module):
    """message = norm1(merge(attn(q(x), k(src), v(src))));
    out = x + norm2(mlp([x, message]))."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        C = d_model
        self.nhead = nhead
        self.q_proj = nn.Linear(C, C, bias=False)
        self.k_proj = nn.Linear(C, C, bias=False)
        self.v_proj = nn.Linear(C, C, bias=False)
        self.merge = nn.Linear(C, C, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * C, 2 * C, bias=False),
                                 nn.ReLU(), nn.Linear(2 * C, C, bias=False))
        self.norm1 = nn.LayerNorm(C)
        self.norm2 = nn.LayerNorm(C)

    def raw(self) -> Dict[str, torch.Tensor]:
        """The layer's weights in the layout the kernels take."""
        return {
            "wq": self.q_proj.weight, "wk": self.k_proj.weight,
            "wv": self.v_proj.weight, "wm": self.merge.weight,
            "w0": self.mlp[0].weight, "w1": self.mlp[2].weight,
            "ln1": torch.stack([self.norm1.weight, self.norm1.bias]),
            "ln2": torch.stack([self.norm2.weight, self.norm2.bias]),
        }

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        return loftr_layer_auto(x, source, self.raw(), self.nhead)

    def dense(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """The layer in plain torch, in x's dtype (the JAX package's XLA
        path, :123-149, with linear attention and no masks): one wide
        projection product where x is source."""
        B, L, C = x.shape
        H = self.nhead
        dt = x.dtype
        p = self.raw()

        def dense(a, w):
            return a.to(dt) @ w.to(dt).t()

        if x is source:
            q, k, v = dense(x, torch.cat([p["wq"], p["wk"], p["wv"]])).chunk(3, dim=-1)
        else:
            q = dense(x, p["wq"])
            k, v = dense(source, torch.cat([p["wk"], p["wv"]])).chunk(2, dim=-1)
        q = q.reshape(B, L, H, C // H)
        k = k.reshape(B, -1, H, C // H)
        v = v.reshape(B, -1, H, C // H)
        message = linear_attention(q, k, v)
        message = _layer_norm(dense(message.reshape(B, L, C), p["wm"]), *p["ln1"])
        y = torch.relu(dense(torch.cat([x.to(dt), message], dim=-1), p["w0"]))
        y = _layer_norm(dense(y, p["w1"]), *p["ln2"])
        return x + y


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross stack over two token sets; cross layers are
    sequential (feat1's update consumes the updated feat0).

    With ``window_tokens`` set, the (N, s, C) inputs are independent
    windows of s tokens: in eval the whole stack is one K3 launch, in
    training a loop over the layers' dense path."""

    def __init__(self, d_model: int, nhead: int, layer_names: Sequence[str],
                 window_tokens: Optional[int] = None):
        super().__init__()
        for name in layer_names:
            if name not in ("self", "cross"):
                raise KeyError(name)
        self.nhead = nhead
        self.layer_names = tuple(layer_names)
        self.window_tokens = window_tokens
        self.layers = nn.ModuleList(
            [LoFTREncoderLayer(d_model, nhead) for _ in layer_names])

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        windows = self.window_tokens is not None
        if windows and not self.training:
            return fine_transformer_auto(
                feat0.contiguous(), feat1.contiguous(),
                [layer.raw() for layer in self.layers], self.layer_names,
                self.nhead)
        for name, layer in zip(self.layer_names, self.layers):
            run = layer.dense if windows else layer
            if name == "self":
                feat0 = run(feat0, feat0)
                feat1 = run(feat1, feat1)
            else:
                feat0 = run(feat0, feat1)
                feat1 = run(feat1, feat0)
        return feat0, feat1
