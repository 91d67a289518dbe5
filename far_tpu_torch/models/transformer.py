"""LoFTR encoder layers and the self/cross attention stack.

Counterpart of ``far_tpu/models/transformer.py`` (eval, linear
attention, no masks). Every coarse layer runs through kernel K1
(``ops/loftr_layer.py``); a stack over independent windows (the fine
stage) runs whole through kernel K3 (``ops/fine_layer.py``). Module
names follow the reference (``layers.3.q_proj``, ``layers.3.mlp.0``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from far_tpu_torch.ops.fine_layer import fine_transformer
from far_tpu_torch.ops.loftr_layer import loftr_layer


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
        return loftr_layer(x, source, self.raw(), self.nhead)


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross stack over two token sets; cross layers are
    sequential (feat1's update consumes the updated feat0).

    With ``window_tokens`` set, the (N, s, C) inputs are independent
    windows of s tokens and the whole stack is one K3 launch."""

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
        if self.window_tokens is not None:
            return fine_transformer(
                feat0.contiguous(), feat1.contiguous(),
                [layer.raw() for layer in self.layers], self.layer_names,
                self.nhead)
        for name, layer in zip(self.layer_names, self.layers):
            if name == "self":
                feat0 = layer(feat0, feat0)
                feat1 = layer(feat1, feat1)
            else:
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
        return feat0, feat1
