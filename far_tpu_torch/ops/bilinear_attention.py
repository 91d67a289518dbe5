"""K4: dual-softmax bilinear attention of the EMM regressor.

Replaces ``far_tpu/ops/bilinear_attention.py:bilinear_dual_softmax``
(its ``pl.pallas_call`` at :171). Per (batch, head):
F = v^T (softmax_rows(S) * softmax_cols(S)) v with S = scale q k^T, a
(Dv, Dv) float32 matrix; the (N, N) attention is never stored. The CUDA
source is ``far_tpu_torch/csrc/bilinear_attention.cu``. Two routes:

- float32, on the CUDA cores: a row/column statistics pass over 64x64
  tiles of S, then G = v^T A accumulated in shared memory per 64 columns.
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from far_tpu_torch.ops import _build


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


def pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (..., N, w) with zero columns appended up to ``width``. Zero
    columns of q and k change no element of S; those of v add zero rows
    and columns to F, so ``F(pad(q), pad(k), pad(v))[..., :Dv, :Dv] ==
    F(q, k, v)``."""
    return F.pad(t, (0, width - t.shape[-1]))


def bilinear_dual_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """F[b, h] = v^T (softmax_r(S) * softmax_c(S)) v, S = scale q k^T.

    Args:
        q, k: (B, H, N, D); v: (B, H, N, Dv).
    Returns:
        (B, H, Dv, Dv) float32.
    """
    if _build.on_cpu(q, k, v):
        return bilinear_dual_softmax_plain(q, k, v, scale)
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
    if code == 1:
        width = _build.bind_size("bilinear_attention", "far_bilinear_tc_width", 1)
        d_tc, dv_tc = width(0), width(1)
        _build.require(D <= d_tc and Dv <= dv_tc and scale > 0,
                       f"the bfloat16 route takes D <= {d_tc}, Dv <= {dv_tc} "
                       f"and scale > 0, got q {tuple(q.shape)}, v "
                       f"{tuple(v.shape)}, scale {scale}")
        if D < d_tc:
            q, k = pad_columns(q, d_tc), pad_columns(k, d_tc)
        # v^T (B, H, dv_tc, ldn), zero past Dv and past N (ldn: N to a
        # multiple of 8, for 16-byte rows)
        vt = F.pad(pad_columns(v, dv_tc), (0, 0, 0, -N % 8)).transpose(-1, -2).contiguous()
        size = _build.bind_size("bilinear_attention", "far_bilinear_tc_scratch", 2)
        fn = _build.bind("bilinear_attention", "far_bilinear_dual_softmax_tc",
                         5, 3, 1)
        scratch = _build.scratch(size(B * H, N), q)
        err = fn(q.data_ptr(), k.data_ptr(), vt.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B * H, N, Dv, float(scale),
                 _build.stream_of(q))
        _build.check(err, "bilinear_dual_softmax (bf16)")
        bilinear_dual_softmax.launches_tc += 1
    else:
        size = _build.bind_size("bilinear_attention", "far_bilinear_scratch", 3)
        fn = _build.bind("bilinear_attention", "far_bilinear_dual_softmax",
                         5, 4, 1)
        scratch = _build.scratch(size(B * H, N, Dv), q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B * H, N, D, Dv, float(scale),
                 _build.stream_of(q))
        _build.check(err, "bilinear_dual_softmax")
    bilinear_dual_softmax.launches += 1
    return out


bilinear_dual_softmax.launches = 0     # launches of either route
bilinear_dual_softmax.launches_tc = 0  # launches of the bfloat16 tensor-core route
