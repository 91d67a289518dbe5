"""Linear (elu + 1 feature map) and full attention, with masks.

Counterpart of ``far_tpu/models/attention.py``. ``linear_attention``
serves the layer's dense path (``models/transformer.py``), which the fine
windows take in training; ``full_attention`` the LoFTR stacks under
``attention="full"``, the self-attention of ViTEss's ViT blocks, of
6DReg's transformer and of SimpleTransformer; the masks are the JAX
package's options, which no model of the port passes here (SuperGlue
masks its own attention, ``models/superglue.py``). The JAX
package's tiny-window branch (its :52-83, a TPU layout workaround)
computes the same function as the generic form below.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_mask: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) linear attention ("Transformers are RNNs").

    Args:
        q: (B, L, H, D); k, v: (B, S, H, D); q_mask (B, L), kv_mask (B, S) bool.
    Returns:
        (B, L, H, D)
    """
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None]
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None]
        v = v * kv_mask[:, :, None, None]
    v_length = v.shape[1]
    v = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_mask: Optional[torch.Tensor] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention (the reference's FullAttention option); the
    softmax in float32, the rest in q's dtype."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=q.dtype))
    logits = torch.einsum("nlhd,nshd->nlsh", q, k) * scale  # a CPU scalar: no copy
    if q_mask is not None and kv_mask is not None:
        mask = q_mask[:, :, None, None] & kv_mask[:, None, :, None]
        logits = logits.masked_fill(~mask, -1e9)
    A = torch.softmax(logits.float(), dim=2).to(q.dtype)
    return torch.einsum("nlsh,nshd->nlhd", A, v)
