"""K1: one LoFTR encoder layer with linear attention.

Replaces ``far_tpu/ops/loftr_layer.py:fused_loftr_layer`` (its
``pl.pallas_call`` at :147). The CUDA source is
``far_tpu_torch/csrc/loftr_layer.cu``. The layer is bound by operations
(~6.5 GFLOP per pair at L=S=4800, C=256). Two routes:

- float32: 11 launches on the CUDA cores (tiled products, a k^T v
  reduction, a message kernel, LayerNorms), intermediates in device
  memory.
- bfloat16: 3 launches on the tensor cores (wgmma, cp.async): a k^T v
  pass over 64-row chunks of src, a fixed-order reduction, and a row
  pass per 128 rows that keeps the x tile, msg and m in shared memory,
  q, y and every accumulator in registers, and streams the weights
  through two 32 KB stages. What holds it back is that each tile's
  wgmma, wait and epilogue run in series within a block. It rounds k, v,
  KV, q, msg, m, y and out to bf16, where the TPU kernel casts them;
  sum(k), z and the LayerNorms stay float32. It takes C in {64, 128, 192,
  256} with a head width C / nhead dividing 64 (``FAR_K1_TC_SHAPES`` in
  the source, asked through ``far_loftr_layer_tc_supports``); other
  shapes raise.

Weights use torch's Linear layout (out, in), the layout of the modules
that own them (``models/transformer.py``):
    wq, wk, wv, wm (C, C); w0 (2C, 2C) = mlp.0; w1 (C, 2C) = mlp.2;
    ln1, ln2 (2, C) = [weight; bias].
``pack_params`` casts them to the kernels' types (weights in the compute
dtype, LayerNorm in float32), contiguous. The wrapper calls it on every
launch; given a pack, it copies nothing.
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


WEIGHTS = ("wq", "wk", "wv", "wm", "w0", "w1")


def pack_params(params: Params, dtype: torch.dtype) -> Params:
    """The layer's weights in the layout the kernels take: the six
    matrices in ``dtype``, ln1/ln2 in float32, all contiguous."""
    out = {k: params[k].detach().to(dtype).contiguous() for k in WEIGHTS}
    for k in ("ln1", "ln2"):
        out[k] = params[k].detach().float().contiguous()
    return out


def loftr_layer(x: torch.Tensor, source: torch.Tensor, params: Params,
                nhead: int) -> torch.Tensor:
    """One LoFTR encoder layer: ``x`` (B, L, C) attends to ``source``
    (B, S, C). CPU tensors take the plain version; CUDA tensors launch
    the float32 or the bfloat16 route of the kernel."""
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
    tc = code == 1
    if tc:
        supports = _build.bind_size("loftr_layer", "far_loftr_layer_tc_supports", 2)
        _build.require(supports(C, nhead) == 1,
                       f"the bfloat16 route does not take x {tuple(x.shape)} "
                       f"with nhead={nhead} (its shapes: FAR_K1_TC_SHAPES in "
                       f"csrc/loftr_layer.cu)")
    w = pack_params(params, x.dtype)  # no copies when already packed
    for k, shape in (("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)),
                     ("wm", (C, C)), ("w0", (2 * C, 2 * C)),
                     ("w1", (C, 2 * C)), ("ln1", (2, C)), ("ln2", (2, C))):
        _build.require(tuple(w[k].shape) == shape,
                       f"{k} has shape {tuple(w[k].shape)}, not {shape}")
    name = "far_loftr_layer_tc" if tc else "far_loftr_layer"
    if tc:
        size = _build.bind_size("loftr_layer", "far_loftr_layer_tc_scratch", 4)
        nbytes = size(B, S, C, nhead)
    else:
        size = _build.bind_size("loftr_layer", "far_loftr_layer_scratch", 5)
        nbytes = size(B, L, S, C, nhead)
    fn = _build.bind("loftr_layer", name, 12, 5)
    out = torch.empty_like(x)
    scratch = _build.scratch(nbytes, x)
    err = fn(x.data_ptr(), source.data_ptr(),
             *(w[k].data_ptr() for k in WEIGHTS), w["ln1"].data_ptr(),
             w["ln2"].data_ptr(), out.data_ptr(), scratch.data_ptr(),
             B, L, S, C, nhead, _build.stream_of(x))
    _build.check(err, name)
    loftr_layer.launches += 1
    loftr_layer.launches_tc += int(tc)
    return out


loftr_layer.launches = 0     # launches of either route
loftr_layer.launches_tc = 0  # launches of the bfloat16 tensor-core route
