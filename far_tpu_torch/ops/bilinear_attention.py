"""K4: dual-softmax bilinear attention of the EMM regressor.

Replaces ``far_tpu/ops/bilinear_attention.py:bilinear_dual_softmax``
(its ``pl.pallas_call`` at :171). Per (batch, head):
F = v^T (softmax_rows(S) * softmax_cols(S)) v with S = scale q k^T, a
(Dv, Dv) float32 matrix; the (N, N) attention is never stored. The CUDA
kernel is ``far_tpu_torch/csrc/bilinear_attention.cu``; its note says
what bounds it (operations: 24.7 GFLOP per pair and launch at N=4800,
4 heads, D=64, Dv=70) and how G = v^T A is accumulated in shared memory.
"""

from __future__ import annotations

import torch

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
    size = _build.bind_size("bilinear_attention", "far_bilinear_scratch", 3)
    fn = _build.bind("bilinear_attention", "far_bilinear_dual_softmax", 5, 5,
                     1)
    out = torch.empty((B, H, Dv, Dv), dtype=torch.float32, device=q.device)
    scratch = _build.scratch(size(B * H, N, Dv), q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), B * H, N, D, Dv, code, float(scale),
             _build.stream_of(q))
    _build.check(err, "bilinear_dual_softmax")
    bilinear_dual_softmax.launches += 1
    return out


bilinear_dual_softmax.launches = 0
