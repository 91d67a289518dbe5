"""K3: the whole fine LoFTR transformer over independent windows.

Replaces ``far_tpu/ops/fine_layer.py:_fused`` (its ``pl.pallas_call`` at
:246). Every layer application (self, cross; both directions; cross is
sequential, so f1 attends to the updated f0) runs with linear attention
confined to each s-token window. The CUDA kernel is
``far_tpu_torch/csrc/fine_layer.cu``; its note says what bounds it
(operations: ~35 GFLOP per pair at K=1024 windows, C=128) and how a
block keeps its windows in shared memory through all four applications.

Each layer's weights are a dict in the layout of ``ops/loftr_layer.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from far_tpu_torch.ops import _build
from far_tpu_torch.ops.loftr_layer import loftr_layer_plain

Params = Dict[str, torch.Tensor]
_MAX_LAYERS = 30  # bits of the kernel's cross-layer mask


def fine_transformer_plain(f0: torch.Tensor, f1: torch.Tensor,
                           params: Sequence[Params],
                           layer_names: Sequence[str], nhead: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (port of ``fine_transformer_reference``) on
    (n, s, C) windows."""
    for name, p in zip(layer_names, params):
        if name == "self":
            f0 = loftr_layer_plain(f0, f0, p, nhead)
            f1 = loftr_layer_plain(f1, f1, p, nhead)
        else:
            f0 = loftr_layer_plain(f0, f1, p, nhead)
            f1 = loftr_layer_plain(f1, f0, p, nhead)
    return f0, f1


def fine_transformer(f0: torch.Tensor, f1: torch.Tensor,
                     params: Sequence[Params], layer_names: Sequence[str],
                     nhead: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fine transformer over (n, s, C) windows of both images."""
    for name in layer_names:
        if name not in ("self", "cross"):
            raise KeyError(name)
    if _build.on_cpu(f0, f1):
        return fine_transformer_plain(f0, f1, params, layer_names, nhead)
    n, s, C = f0.shape
    code = _build.dtype_code(f0)
    _build.require(f1.dtype == f0.dtype and f1.shape == f0.shape,
                   "f0 and f1 must match in shape and dtype")
    _build.require(f0.is_contiguous() and f1.is_contiguous(),
                   "f0 and f1 must be contiguous")
    _build.require(C % nhead == 0, f"C={C} not divisible by nhead={nhead}")
    _build.require(len(params) == len(layer_names) <= _MAX_LAYERS,
                   "one weight dict per layer name, at most 30 layers")
    dt = f0.dtype
    w = torch.cat([torch.cat([p[k].to(dt).reshape(-1) for k in
                              ("wq", "wk", "wv", "wm", "w0", "w1")])
                   for p in params]).contiguous()
    _build.require(w.numel() == 10 * C * C * len(params),
                   "layer weights do not fit C")
    ln = torch.cat([torch.cat([p["ln1"].float().reshape(-1),
                               p["ln2"].float().reshape(-1)])
                    for p in params]).contiguous()
    cross = sum(1 << i for i, nm in enumerate(layer_names) if nm == "cross")
    fn = _build.bind("fine_layer", "far_fine_transformer", 6, 7)
    out0 = torch.empty_like(f0)
    out1 = torch.empty_like(f1)
    err = fn(f0.data_ptr(), f1.data_ptr(), w.data_ptr(), ln.data_ptr(),
             out0.data_ptr(), out1.data_ptr(), n, s, C, nhead, len(params),
             cross, code, _build.stream_of(f0))
    _build.check(err, "fine_transformer")
    fine_transformer.launches += 1
    return out0, out1


fine_transformer.launches = 0
