"""K1: one LoFTR encoder layer with linear attention.

Replaces ``far_tpu/ops/loftr_layer.py:fused_loftr_layer`` (its
``pl.pallas_call`` at :147). The CUDA source is
``far_tpu_torch/csrc/loftr_layer.cu``. The layer is bound by operations
(~6.5 GFLOP per pair at L=S=4800, C=256). Three routes:

- CUDA cores, 11 launches (tiled products, a k^T v reduction, a message
  kernel, LayerNorms), intermediates in device memory: the shapes the
  tensor-core routes are not built for (C = 32 or 96, a head width of
  24, ...), in either dtype, chosen by that shape check before any
  launch. In bfloat16 every product accumulates in float32 and q, k, v,
  KV, msg, m, y and out round to bf16 where the TPU kernel casts them.
- float32 on the tensor cores, 10 launches: the five dense products as
  3xTF32 wgmma GEMMs (``ops/tf32.py`` models the arithmetic: each
  operand split into two TF32 parts, three products, float32 accuracy)
  with elu + 1, 1/S, relu, and LayerNorm (+ residual) in their
  epilogues, the weights split once a call by a launch of their own;
  the per-head k^T v and q KV (~2.5 % of the operations) on the CUDA
  cores in float32, as above. Intermediates go through device
  memory: in float32 a fused row pass's split operands would not fit a
  block's shared memory or registers. It takes C in {128, 256}
  (``far_loftr_layer_tf32_supports``); ``launches_tf32`` counts it.
- bfloat16 on the tensor cores, 3 launches (wgmma, cp.async): a k^T v
  pass over 64-row chunks of src, a fixed-order reduction, and a row
  pass per 128 rows that keeps the x tile, msg and m in shared memory,
  q, y and every accumulator in registers, and streams the weights
  through two 32 KB stages. What holds it back is that each tile's
  wgmma, wait and epilogue run in series within a block. It rounds k, v,
  KV, q, msg, m, y and out to bf16, where the TPU kernel casts them;
  sum(k), z and the LayerNorms stay float32. It takes C in {64, 128, 192,
  256} with a head width C / nhead dividing 64 (``FAR_K1_TC_SHAPES`` in
  the source, asked through ``far_loftr_layer_tc_supports``).

Weights use torch's Linear layout (out, in), the layout of the modules
that own them (``models/transformer.py``):
    wq, wk, wv, wm (C, C); w0 (2C, 2C) = mlp.0; w1 (C, 2C) = mlp.2;
    ln1, ln2 (2, C) = [weight; bias].
``pack_params`` casts them to the kernels' types (weights in the compute
dtype, LayerNorm in float32), contiguous. The wrapper calls it on every
launch; given a pack, it copies nothing.

``loftr_layer_auto`` is the differentiable layer (the counterpart of the
JAX package's ``loftr_layer_auto``, a ``jax.custom_vjp``): its forward is
the wrapper above, its backward recomputes ``loftr_layer_plain`` from the
saved inputs and weights and differentiates that, as the JAX VJP
differentiates its jnp reference. The JAX package has no backward kernel,
so neither has the port.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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
    the tensor-core route of their dtype (bfloat16: ``launches_tc``;
    float32, 3xTF32: ``launches_tf32``) for the shapes it is built for,
    else the CUDA-core route. On CUDA, inputs that require grad raise in
    grad mode (``loftr_layer_auto`` is the differentiable form)."""
    if _build.on_cpu(x, source):
        return loftr_layer_plain(x, source, params, nhead)
    _build.refuse_grad("loftr_layer", (x, source, *params.values()))
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
    # the tensor-core route of the dtype where it is built for (C, nhead)
    route = "tc" if code == 1 else "tf32"
    if _build.bind_size("loftr_layer", f"far_loftr_layer_{route}_supports", 2)(C, nhead) != 1:
        route = "cuda_cores"
    w = pack_params(params, x.dtype)  # no copies when already packed
    for k, shape in (("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)),
                     ("wm", (C, C)), ("w0", (2 * C, 2 * C)),
                     ("w1", (C, 2 * C)), ("ln1", (2, C)), ("ln2", (2, C))):
        _build.require(tuple(w[k].shape) == shape,
                       f"{k} has shape {tuple(w[k].shape)}, not {shape}")
    if route == "tc":
        name, tail = "far_loftr_layer_tc", ()
        size = _build.bind_size("loftr_layer", "far_loftr_layer_tc_scratch", 4)
        nbytes = size(B, S, C, nhead)
    elif route == "tf32":
        name, tail = "far_loftr_layer_tf32", ()
        size = _build.bind_size("loftr_layer", "far_loftr_layer_tf32_scratch", 5)
        nbytes = size(B, L, S, C, nhead)
    else:
        name, tail = "far_loftr_layer", (code,)
        size = _build.bind_size("loftr_layer", "far_loftr_layer_scratch", 6)
        nbytes = size(code, B, L, S, C, nhead)
    fn = _build.bind("loftr_layer", name, 12, 5 + len(tail))
    out = torch.empty_like(x)
    scratch = _build.scratch(nbytes, x)
    err = fn(x.data_ptr(), source.data_ptr(),
             *(w[k].data_ptr() for k in WEIGHTS), w["ln1"].data_ptr(),
             w["ln2"].data_ptr(), out.data_ptr(), scratch.data_ptr(),
             B, L, S, C, nhead, *tail, _build.stream_of(x))
    _build.check(err, name)
    _build.count_launch(loftr_layer, route)
    return out


loftr_layer.launches = 0       # launches of any route
loftr_layer.launches_tc = 0    # launches of the bfloat16 tensor-core route
loftr_layer.launches_tf32 = 0  # launches of the float32 tensor-core route (3xTF32)

PARAM_KEYS = WEIGHTS + ("ln1", "ln2")


def recompute_grads(plain, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
                    grad_out: Sequence[torch.Tensor]) -> List:
    """The gradients of ``plain(*inputs)`` (one output or a tuple, with
    ``grad_out`` one gradient for each) for the inputs in ``needs``, from
    a fresh recompute: each input becomes a leaf of its own (so an
    input passed twice, as x and source of a self layer, gets both of its
    gradients and autograd adds them up), in its own dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        out = plain(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, grad_out)) if wanted else iter(())
    return [next(grads) if n else None for n in needs]


class _LoftrLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, source, nhead, *weights):
        ctx.nhead = nhead
        ctx.save_for_backward(x, source, *weights)
        return loftr_layer(x, source, dict(zip(PARAM_KEYS, weights)), nhead)

    @staticmethod
    def backward(ctx, g):
        nhead = ctx.nhead

        def plain(x, source, *weights):
            return loftr_layer_plain(x, source, dict(zip(PARAM_KEYS, weights)), nhead)

        needs = ctx.needs_input_grad
        grads = recompute_grads(plain, ctx.saved_tensors, needs[:2] + needs[3:], (g,))
        return (grads[0], grads[1], None, *grads[2:])


def loftr_layer_auto(x: torch.Tensor, source: torch.Tensor, params: Params,
                     nhead: int) -> torch.Tensor:
    """``loftr_layer`` with a gradient: K1 (or, on the CPU, the plain
    version) forward; backward by recomputing the plain version. The
    weights enter as tensors of their own, so their gradients reach the
    modules' parameters through ``raw()``."""
    return _LoftrLayerFn.apply(x, source, nhead, *(params[k] for k in PARAM_KEYS))
