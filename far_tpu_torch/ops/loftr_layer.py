"""K1: one LoFTR encoder layer with linear attention.

Replaces ``far_tpu/ops/loftr_layer.py:fused_loftr_layer`` (its
``pl.pallas_call`` at :147). The CUDA kernel is
``far_tpu_torch/csrc/loftr_layer.cu``; its note says what bounds it on the
card (operations: ~6.5 GFLOP per pair at L=S=4800, C=256) and how the
layer is split into launches because an SM cannot hold what the TPU
kernel keeps in VMEM.

Weights use torch's Linear layout (out, in), the layout of the modules
that own them (``models/transformer.py``):
    wq, wk, wv, wm (C, C); w0 (2C, 2C) = mlp.0; w1 (C, 2C) = mlp.2;
    ln1, ln2 (2, C) = [weight; bias].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from far_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis as the JAX kernels write it: mean, then
    the mean square of the centred values, then rsqrt."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


def loftr_layer_plain(x: torch.Tensor, source: torch.Tensor, params: Params,
                      nhead: int) -> torch.Tensor:
    """Plain PyTorch version (port of ``fused_loftr_layer_reference``)."""
    dt = x.dtype
    n = source.shape[1]
    B, L, C = x.shape
    d = C // nhead

    def dense(a, w):
        return a @ w.to(dt).t()

    q = (F.elu(dense(x, params["wq"])) + 1.0).reshape(B, L, nhead, d)
    k = (F.elu(dense(source, params["wk"])) + 1.0).reshape(B, n, nhead, d)
    v = (dense(source, params["wv"]) / n).reshape(B, n, nhead, d)
    kv = torch.einsum("nshd,nshv->nhdv", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
    msg = torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * n
    msg = dense(msg.reshape(B, L, C).to(dt), params["wm"])
    ln1, ln2 = params["ln1"].float(), params["ln2"].float()
    m = layer_norm(msg.float(), ln1[0], ln1[1])
    w0 = params["w0"]
    y = dense(x, w0[:, :C]) + dense(m.to(dt), w0[:, C:])
    y = torch.relu(y)
    y = layer_norm(dense(y.to(dt), params["w1"]).float(), ln2[0], ln2[1])
    return (x.float() + y).to(dt)


def loftr_layer(x: torch.Tensor, source: torch.Tensor, params: Params,
                nhead: int) -> torch.Tensor:
    """One LoFTR encoder layer: ``x`` (B, L, C) attends to ``source``
    (B, S, C). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if _build.on_cpu(x, source):
        return loftr_layer_plain(x, source, params, nhead)
    B, L, C = x.shape
    S = source.shape[1]
    code = _build.dtype_code(x)
    _build.require(source.dtype == x.dtype, "x and source dtypes differ")
    _build.require(source.shape[0] == B and source.shape[2] == C,
                   f"source {tuple(source.shape)} does not fit x "
                   f"{tuple(x.shape)}")
    _build.require(C % nhead == 0, f"C={C} not divisible by nhead={nhead}")
    _build.require(x.is_contiguous() and source.is_contiguous(),
                   "x and source must be contiguous")
    w = {k: params[k].to(x.dtype).contiguous()
         for k in ("wq", "wk", "wv", "wm", "w0", "w1")}
    for k, shape in (("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)),
                     ("wm", (C, C)), ("w0", (2 * C, 2 * C)),
                     ("w1", (C, 2 * C))):
        _build.require(tuple(w[k].shape) == shape,
                       f"{k} has shape {tuple(w[k].shape)}, not {shape}")
    ln1 = params["ln1"].float().contiguous()
    ln2 = params["ln2"].float().contiguous()
    _build.require(tuple(ln1.shape) == (2, C) and tuple(ln2.shape) == (2, C),
                   "ln1/ln2 must be (2, C)")
    size = _build.bind_size("loftr_layer", "far_loftr_layer_scratch", 6)
    fn = _build.bind("loftr_layer", "far_loftr_layer", 12, 6)
    out = torch.empty_like(x)
    scratch = _build.scratch(size(code, B, L, S, C, nhead), x)
    err = fn(x.data_ptr(), source.data_ptr(), w["wq"].data_ptr(),
             w["wk"].data_ptr(), w["wv"].data_ptr(), w["wm"].data_ptr(),
             w["w0"].data_ptr(), w["w1"].data_ptr(), ln1.data_ptr(),
             ln2.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             B, L, S, C, nhead, code, _build.stream_of(x))
    _build.check(err, "loftr_layer")
    loftr_layer.launches += 1
    return out


loftr_layer.launches = 0
