"""K4: dual-softmax bilinear attention of the EMM regressor.

Replaces ``far_tpu/ops/bilinear_attention.py:bilinear_dual_softmax``
(its ``pl.pallas_call`` at :171). Per (batch, head):
F = v^T (softmax_rows(S) * softmax_cols(S)) v with S = scale q k^T, a
(Dv, Dv) float32 matrix; the (N, N) attention is never stored. The CUDA
source is ``far_tpu_torch/csrc/bilinear_attention.cu``. Three routes:

- CUDA cores: a row/column statistics pass over 64x64 tiles of S, then
  G = v^T A accumulated in shared memory per 64 columns. It takes the
  shapes the tensor-core routes are not built for (D > 64, Dv > 72 or
  scale <= 0, chosen by shape before any launch), in either dtype; in
  bfloat16 it rounds P and H = G / csum to bf16 as the TPU kernel does.
- float32, on the tensor cores as 3xTF32 (``ops/tf32.py`` models the
  arithmetic): the bfloat16 route's three launches, with every product
  (S = q k^T, G^T += P^T v, F = H v) as three TF32 wgmma products of
  split operands, so it keeps float32 accuracy. Tiles are split in
  shared memory as they arrive, P and H in registers. The tensor cores
  bound it (3 passes at 495 TFLOP/s), not the exponential unit. It takes
  D <= 64, Dv <= 72 and scale > 0 (``far_bilinear_tf32_supports``), with
  q, k and v padded as below and v^T's columns in the TF32 fragments' K
  order (``kperm_columns``); ``launches_tf32`` counts it.
- bfloat16, on the tensor cores (wgmma, cp.async), three launches: a
  row-statistics pass, a main pass that keeps the running column max
  and sum per key column with the TPU kernel's rescale and feeds
  P^T = softmax_r * exp(S - cmax) from registers into G^T += P^T v, and a
  fixed-order sum of per-warpgroup partials. On the card the exponential
  unit binds before the tensor cores (2 N^2 (D + Dv) operations): the
  function needs 2 exponentials per element of S, the route computes 3
  (1 in the statistics pass, 2 in the main pass). It rounds P and H = G / csum to bf16, where the TPU kernel
  casts them (:77, :91). It is built for D = 64 and v 72 wide (wgmma's N
  must be a multiple of 8; the library says, ``far_bilinear_tc_width``):
  the wrapper pads q and k with zero columns to 64 and v to 72
  (``pad_columns``) and passes v^T, so it takes D <= 64, Dv <= 72 and
  scale > 0.

``bilinear_dual_softmax_auto`` is the differentiable form (the JAX
package's ``bilinear_dual_softmax`` is a ``jax.custom_vjp``): K4 forward,
and a backward that differentiates the streaming twin
``bilinear_dual_softmax_streaming`` (row blocks, each recomputed under
``torch.utils.checkpoint``, so no (N, N) matrix is kept), or the plain
version below N = 1024, as the JAX VJP does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from far_tpu_torch.ops import _build
from far_tpu_torch.ops.loftr_layer import recompute_grads

_NEG_INF = -1e30


def bilinear_dual_softmax_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version (port of ``bilinear_dual_softmax_reference``).

    One (batch, head) at a time, so a (N, N) matrix at N=4800 stays
    ~90 MB instead of B*H times that."""
    B, H, N, _ = q.shape
    Dv = v.shape[-1]
    out = torch.empty((B, H, Dv, Dv), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            s = (q[b, h].float() @ k[b, h].float().t()) * scale
            A = torch.softmax(s, dim=-1) * torch.softmax(s, dim=-2)
            vf = v[b, h].float()
            out[b, h] = vf.t() @ (A @ vf)
    return out


def pick_block(n: int) -> int:
    """The row block of the streaming twin for N rows (the JAX package's
    ``_pick_block``: 480 at N = 4800), 0 where none divides N."""
    for b in (512, 480, 400, 320, 256, 240, 160, 128, 96, 64, 32, 16, 8):
        if n % b == 0:
            return b
    return 0


def _stream_block(G, cmax, csum, qb, kt, vb, scale: float):
    """One row block: its exact row softmax, the running column max and
    sum rescaled flash-style, and G += vb^T P."""
    s = (qb.float() @ kt) * scale                       # (B, H, block, N)
    rmax = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - rmax)
    rinv = 1.0 / e.sum(dim=-1, keepdim=True)
    cnew = torch.maximum(cmax, s.amax(dim=-2, keepdim=True))
    fix = torch.exp(cmax - cnew)
    E = torch.exp(s - cnew)
    csum = csum * fix + E.sum(dim=-2, keepdim=True)
    G = G * fix + vb.float().transpose(-1, -2) @ ((e * rinv) * E)
    return G, cnew, csum


def bilinear_dual_softmax_streaming(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, scale: float,
                                    block: int) -> torch.Tensor:
    """Plain twin of K4 over row blocks of ``block`` rows (port of
    ``bilinear_dual_softmax_streaming``): each block's body runs under
    ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``, so
    autograd through it keeps a (Dv, N) carry a block instead of the
    (N, N) attention."""
    B, H, N, _ = q.shape
    Dv = v.shape[-1]
    kt = k.float().transpose(-1, -2)
    G = q.new_zeros((B, H, Dv, N), dtype=torch.float32)
    cmax = q.new_full((B, H, 1, N), _NEG_INF, dtype=torch.float32)
    csum = q.new_zeros((B, H, 1, N), dtype=torch.float32)
    for i in range(N // block):
        rows = slice(i * block, (i + 1) * block)
        G, cmax, csum = checkpoint(_stream_block, G, cmax, csum, q[:, :, rows],
                                   kt, v[:, :, rows], scale, use_reentrant=False)
    return (G / csum) @ v.float()


class _BilinearFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return bilinear_dual_softmax(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        scale = ctx.scale
        q = ctx.saved_tensors[0]
        block = pick_block(q.shape[2])
        if q.shape[2] < 1024 or block == 0:
            def plain(a, b, c):
                return bilinear_dual_softmax_plain(a, b, c, scale)
        else:
            def plain(a, b, c):
                return bilinear_dual_softmax_streaming(a, b, c, scale, block)
        grads = recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


def bilinear_dual_softmax_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """``bilinear_dual_softmax`` with a gradient (see the module note)."""
    return _BilinearFn.apply(q, k, v, scale)


def pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (..., N, w) with zero columns appended up to ``width``. Zero
    columns of q and k change no element of S; those of v add zero rows
    and columns to F, so ``F(pad(q), pad(k), pad(v))[..., :Dv, :Dv] ==
    F(q, k, v)``."""
    return F.pad(t, (0, width - t.shape[-1]))


def kperm_columns(t: torch.Tensor) -> torch.Tensor:
    """t (..., n) with n a multiple of 8, each group of 8 columns in the
    order 0 2 4 6 1 3 5 7 (even k moves to k / 2, odd k to 4 + k / 2). The
    float32 route feeds P from its accumulators as TF32 A fragments,
    whose K order within a k8 step is that one (``frag_tf32`` and
    ``kperm_pos`` in ``csrc/hopper.cuh``), so v^T's columns come in it."""
    *lead, n = t.shape
    return t.reshape(*lead, n // 8, 4, 2).transpose(-1, -2).reshape(*lead, n)


def bilinear_dual_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """F[b, h] = v^T (softmax_r(S) * softmax_c(S)) v, S = scale q k^T.

    Args:
        q, k: (B, H, N, D); v: (B, H, N, Dv).
    Returns:
        (B, H, Dv, Dv) float32.

    CPU tensors take the plain version; CUDA tensors launch the
    tensor-core route of their dtype (bfloat16: ``launches_tc``; float32,
    3xTF32: ``launches_tf32``) for the shapes it is built for, else the
    CUDA-core route. On CUDA, inputs that require grad raise in grad mode
    (``bilinear_dual_softmax_auto`` is the differentiable form).
    """
    if _build.on_cpu(q, k, v):
        return bilinear_dual_softmax_plain(q, k, v, scale)
    _build.refuse_grad("bilinear_dual_softmax", (q, k, v))
    B, H, N, D = q.shape
    Dv = v.shape[-1]
    code = _build.dtype_code(q)
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype,
                   "q, k, v dtypes differ")
    _build.require(tuple(k.shape) == (B, H, N, D)
                   and tuple(v.shape[:3]) == (B, H, N),
                   f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                   f"v {tuple(v.shape)} do not fit")
    _build.require(q.is_contiguous() and k.is_contiguous()
                   and v.is_contiguous(), "q, k, v must be contiguous")
    out = torch.empty((B, H, Dv, Dv), dtype=torch.float32, device=q.device)
    # both tensor-core routes take q, k 64 wide and v 72 wide (padded)
    width = _build.bind_size("bilinear_attention", "far_bilinear_tc_width", 1)
    d_tc, dv_tc = width(0), width(1)
    if code == 1:
        route = "tc" if D <= d_tc and Dv <= dv_tc and scale > 0 else "cuda_cores"
    else:
        supports = _build.bind_size("bilinear_attention", "far_bilinear_tf32_supports", 2)
        route = "tf32" if supports(D, Dv) == 1 and scale > 0 else "cuda_cores"
    if route != "cuda_cores":
        if D < d_tc:
            q, k = pad_columns(q, d_tc), pad_columns(k, d_tc)
        # v^T (B, H, dv_tc, ldn), zero past Dv and past N (ldn: N to a
        # multiple of 8, for 16-byte rows); float32 in the K order of the
        # TF32 fragments
        vt = F.pad(pad_columns(v, dv_tc), (0, 0, 0, -N % 8)).transpose(-1, -2)
        vt = (kperm_columns(vt) if route == "tf32" else vt).contiguous()
        size = _build.bind_size("bilinear_attention", f"far_bilinear_{route}_scratch", 2)
        name = "far_bilinear_dual_softmax_" + route
        fn = _build.bind("bilinear_attention", name, 5, 3, 1)
        scratch = _build.scratch(size(B * H, N), q)
        err = fn(q.data_ptr(), k.data_ptr(), vt.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B * H, N, Dv, float(scale),
                 _build.stream_of(q))
        _build.check(err, name)
        _build.count_launch(bilinear_dual_softmax, route)
    else:
        size = _build.bind_size("bilinear_attention", "far_bilinear_scratch", 3)
        fn = _build.bind("bilinear_attention", "far_bilinear_dual_softmax",
                         5, 5, 1)
        scratch = _build.scratch(size(B * H, N, Dv), q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B * H, N, D, Dv, code, float(scale),
                 _build.stream_of(q))
        _build.check(err, "bilinear_dual_softmax")
        _build.count_launch(bilinear_dual_softmax)
    return out


bilinear_dual_softmax.launches = 0       # launches of any route
bilinear_dual_softmax.launches_tc = 0    # launches of the bfloat16 tensor-core route
bilinear_dual_softmax.launches_tf32 = 0  # launches of the float32 tensor-core route (3xTF32)
