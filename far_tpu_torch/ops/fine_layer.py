"""K3: the whole fine LoFTR transformer over independent windows.

Replaces ``far_tpu/ops/fine_layer.py:_fused`` (its ``pl.pallas_call`` at
:246). Every layer application (self, cross; both directions; cross is
sequential, so f1 attends to the updated f0) runs with linear attention
confined to each s-token window. The kernel is bound by operations
(~35 GFLOP per pair at K=1024 windows, C=128). The CUDA source is
``far_tpu_torch/csrc/fine_layer.cu``; one launch a call in each route
(the float32 tensor-core route adds a small one that prepares the weights):

- bfloat16 with C in {64, 128}, a head width of 16, 32 or 64 and s <= 64
  (``FAR_K3_TC_SHAPES``, asked through
  ``far_fine_transformer_tc_supports`` before any launch): the tensor
  cores (wgmma, cp.async). A block holds 128 // s whole windows of both
  images in shared memory as bf16 for all four applications and computes
  the attention per head as the TPU kernel does, q k^T masked to the
  window, then . v. It rounds q, k, v, the masked S, msg, m, y and x to
  bf16 where the TPU kernel casts them; the denominators and LayerNorms
  stay float32. What holds it back: each weight tile's and each head's
  products run in series within a block.
- float32 at C = 128 with a head width of 16 or 32 and 64 // s whole
  windows a block (s = 25 on every path; ``far_fine_transformer_tf32_
  supports``): the tensor cores, 3xTF32 (every product three TF32 wgmma
  products of big / small splits, ``ops/tf32.py`` models them). A block
  of one warpgroup keeps 64 rows (2 windows at s = 25 and 14 zero rows)
  of both images in shared memory as float32 through all four
  applications. A small launch splits the weights into big and small once
  a call and lays each 128 x 32 tile out as shared memory holds it; one
  thread moves a tile with ``cp.async.bulk`` onto an mbarrier, two stages
  deep. A operands are split into TF32 fragments in registers as they are
  read; the window attention (k^T v, sum(k), q KV, ~2.4 % of the
  operations) runs on the CUDA cores in float32, the LayerNorms in the
  accumulators. ~210 KB of shared memory at the main shape, one block an
  SM. What holds it back (PERF.md): the one warpgroup runs each weight
  tile's chain (fragment splits, 12 wgmma, wait, barrier) in series, about
  half a block's time, and the CUDA-core window passes and epilogues,
  about a third, run with no tensor-core work beside them; waiting for
  weight tiles is about 5 %.
- other float32 shapes (C = 256, s = 81, head widths outside {16, 32}),
  and bfloat16 shapes outside the tensor-core set: the CUDA cores, a
  block keeping 2 windows in shared memory as f32 through all four
  applications, or 1 where 2 do not fit (C >= 192 at s = 25, C = 128 at
  s = 81; the kernel asks the card's per-block limit).

Each layer's weights are a dict in the layout of ``ops/loftr_layer.py``;
``pack_fine_params`` casts and concatenates them once for the kernel.

``fine_transformer_auto`` is the differentiable form (the JAX package's
``fine_transformer_auto``, a ``jax.custom_vjp``): K3 forward, backward by
recomputing ``fine_transformer_plain``. (Under differentiation the JAX
package runs its reference forward instead of the kernel; the port keeps
the kernel forward, and the gradients are the same.)
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from far_tpu_torch.ops import _build
from far_tpu_torch.ops.loftr_layer import (
    PARAM_KEYS,
    WEIGHTS,
    loftr_layer_plain,
    recompute_grads,
)

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


class FinePack(NamedTuple):
    """The stack's weights as the kernel takes them: ``w`` every layer's
    [wq wk wv wm | w0 | w1] flattened in the compute dtype, ``ln`` every
    layer's [ln1; ln2] in float32, both contiguous."""
    w: torch.Tensor
    ln: torch.Tensor


def pack_fine_params(params: Sequence[Params], dtype: torch.dtype) -> FinePack:
    """Cast and concatenate the layers' weights once, for callers that run
    the stack many times with the same weights."""
    w = torch.cat([torch.cat([p[k].detach().to(dtype).reshape(-1) for k in WEIGHTS])
                   for p in params]).contiguous()
    ln = torch.cat([torch.cat([p["ln1"].detach().float().reshape(-1),
                               p["ln2"].detach().float().reshape(-1)])
                    for p in params]).contiguous()
    return FinePack(w, ln)


def fine_transformer(f0: torch.Tensor, f1: torch.Tensor,
                     params: Sequence[Params], layer_names: Sequence[str],
                     nhead: int, pack: Optional[FinePack] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fine transformer over (n, s, C) windows of both images.

    ``pack`` (from ``pack_fine_params(params, f0.dtype)``) saves the
    kernel path its per-call cast of the weights; the plain version on
    the CPU reads ``params``. On CUDA, inputs that require grad raise in
    grad mode (``fine_transformer_auto`` is the differentiable form)."""
    for name in layer_names:
        if name not in ("self", "cross"):
            raise KeyError(name)
    if _build.on_cpu(f0, f1):
        return fine_transformer_plain(f0, f1, params, layer_names, nhead)
    _build.refuse_grad("fine_transformer",
                       (f0, f1, *(w for p in params for w in p.values())))
    n, s, C = f0.shape
    code = _build.dtype_code(f0)
    _build.require(f1.dtype == f0.dtype and f1.shape == f0.shape,
                   "f0 and f1 must match in shape and dtype")
    _build.require(f0.is_contiguous() and f1.is_contiguous(),
                   "f0 and f1 must be contiguous")
    _build.require(C % nhead == 0, f"C={C} not divisible by nhead={nhead}")
    _build.require(len(params) == len(layer_names) <= _MAX_LAYERS,
                   "one weight dict per layer name, at most 30 layers")
    w, ln = pack if pack is not None else pack_fine_params(params, f0.dtype)
    _build.require(w.dtype == f0.dtype and ln.dtype == torch.float32
                   and w.device == f0.device and ln.device == f0.device
                   and w.is_contiguous() and ln.is_contiguous(),
                   "the weight pack's dtypes or device do not fit f0, or it "
                   "is not contiguous")
    _build.require(w.numel() == 10 * C * C * len(params)
                   and ln.numel() == 4 * C * len(params),
                   "layer weights do not fit C")
    cross = sum(1 << i for i, nm in enumerate(layer_names) if nm == "cross")
    # the tensor-core route of the dtype where it is built for (C, nhead, s)
    route = "tc" if code == 1 else "tf32"
    if _build.bind_size("fine_layer", f"far_fine_transformer_{route}_supports",
                        3)(C, nhead, s) != 1:
        route = "cuda_cores"
    out0 = torch.empty_like(f0)
    out1 = torch.empty_like(f1)
    ptrs = [f0.data_ptr(), f1.data_ptr(), w.data_ptr(), ln.data_ptr(),
            out0.data_ptr(), out1.data_ptr()]
    ints = [n, s, C, nhead, len(params), cross]
    if route == "tc":
        fn = _build.bind("fine_layer", "far_fine_transformer_tc", 6, 6)
        err = fn(*ptrs, *ints, _build.stream_of(f0))
    elif route == "tf32":
        size = _build.bind_size("fine_layer", "far_fine_transformer_tf32_scratch", 1)
        scratch = _build.scratch(size(len(params)), f0)
        fn = _build.bind("fine_layer", "far_fine_transformer_tf32", 7, 6)
        err = fn(*ptrs, scratch.data_ptr(), *ints, _build.stream_of(f0))
    else:
        fn = _build.bind("fine_layer", "far_fine_transformer", 6, 7)
        err = fn(*ptrs, *ints, code, _build.stream_of(f0))
    _build.check(err, f"fine_transformer ({route})")
    _build.count_launch(fine_transformer, route)
    return out0, out1


fine_transformer.launches = 0       # launches of any route
fine_transformer.launches_tc = 0    # launches of the bfloat16 tensor-core route
fine_transformer.launches_tf32 = 0  # launches of the float32 tensor-core route (3xTF32)


def _layer_dicts(weights: Sequence[torch.Tensor]):
    n = len(PARAM_KEYS)
    return [dict(zip(PARAM_KEYS, weights[i:i + n])) for i in range(0, len(weights), n)]


class _FineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, layer_names, nhead, *weights):
        ctx.layer_names, ctx.nhead = layer_names, nhead
        ctx.save_for_backward(f0, f1, *weights)
        return fine_transformer(f0, f1, _layer_dicts(weights), layer_names, nhead)

    @staticmethod
    def backward(ctx, g0, g1):
        names, nhead = ctx.layer_names, ctx.nhead

        def plain(f0, f1, *weights):
            return fine_transformer_plain(f0, f1, _layer_dicts(weights), names, nhead)

        needs = ctx.needs_input_grad
        grads = recompute_grads(plain, ctx.saved_tensors, needs[:2] + needs[4:], (g0, g1))
        return (grads[0], grads[1], None, None, *grads[2:])


def fine_transformer_auto(f0: torch.Tensor, f1: torch.Tensor,
                          params: Sequence[Params], layer_names: Sequence[str],
                          nhead: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fine_transformer`` with a gradient (see the module note)."""
    flat = [p[k] for p in params for k in PARAM_KEYS]
    return _FineFn.apply(f0, f1, tuple(layer_names), nhead, *flat)
