"""K2: dual-softmax match reductions.

Replaces ``far_tpu/ops/matching_kernel.py:dual_softmax_rowcol`` (its
``pl.pallas_call`` at :125). For S = inv_temp * f0 f1^T and
conf = softmax_rows(S) * softmax_cols(S) it returns each row's max conf
and first argmax and each column's max conf, without storing conf. The
kernel is bound by operations (two passes over S, 11.8 GFLOP each per
pair at L=S=4800, C=256). The CUDA source is
``far_tpu_torch/csrc/matching_kernel.cu``. Two routes:

- bfloat16 with C <= 256 and inv_temp > 0, the route of every far_forward
  request (the model casts the features to bf16 in f32 models too): four
  launches on the tensor cores (wgmma, cp.async). A statistics pass
  keeps the row and column (max, sum) in the log2 domain (2 exponentials
  per element of S); a conf pass computes t = 2x - alpha_i - beta_j once
  per element and takes the row max, its first argmax and the column max
  over t (0 exponentials per element: only the results are
  exponentiated), so a mutual pair's row_val and col_max are equal bit
  for bit. C is padded with zero channels to a multiple of 64
  (``ops.bilinear_attention.pad_columns``: zero columns change no element
  of S). Cross-block merges run in a fixed order.
- float32, and other bf16 inputs: the CUDA-core route, six launches of
  64x64 tiles with fixed-order merges.
"""

from __future__ import annotations

from typing import Tuple

import torch

from far_tpu_torch.ops import _build
from far_tpu_torch.ops.bilinear_attention import pad_columns


def dual_softmax_rowcol_plain(f0: torch.Tensor, f1: torch.Tensor,
                              inv_temp: float):
    """Plain PyTorch version (port of ``dual_softmax_rowcol_reference``):
    materializes conf."""
    sim = torch.einsum("blc,bsc->bls", f0.float(), f1.float()) * inv_temp
    conf = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)
    row_val = conf.amax(dim=2)
    row_idx = conf.argmax(dim=2)  # first index on ties
    col_max = conf.amax(dim=1)
    return row_val, row_idx, col_max


def dual_softmax_rowcol(f0: torch.Tensor, f1: torch.Tensor, inv_temp: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-best (value, argmax) and column max of the dual-softmax
    confidences.

    Args:
        f0: (B, L, C) already scaled by 1/sqrt(C); f1: (B, S, C).
        inv_temp: 1 / dsmax_temperature.
    Returns:
        row_val (B, L) float32, row_idx (B, L) int64, col_max (B, S)
        float32.
    """
    if _build.on_cpu(f0, f1):
        return dual_softmax_rowcol_plain(f0, f1, inv_temp)
    B, L, C = f0.shape
    S = f1.shape[1]
    code = _build.dtype_code(f0)
    _build.require(f1.dtype == f0.dtype, "f0 and f1 dtypes differ")
    _build.require(f1.shape[0] == B and f1.shape[2] == C,
                   f"f1 {tuple(f1.shape)} does not fit f0 {tuple(f0.shape)}")
    _build.require(f0.is_contiguous() and f1.is_contiguous(),
                   "f0 and f1 must be contiguous")
    row_val = torch.empty((B, L), dtype=torch.float32, device=f0.device)
    row_idx = torch.empty((B, L), dtype=torch.int64, device=f0.device)
    col_max = torch.empty((B, S), dtype=torch.float32, device=f0.device)
    width = _build.bind_size("matching_kernel", "far_dual_softmax_tc_width", 0)()
    tc = code == 1 and C <= width and inv_temp > 0
    if tc:
        cp = -(-C // 64) * 64
        if cp != C:
            f0, f1 = pad_columns(f0, cp), pad_columns(f1, cp)
        size = _build.bind_size("matching_kernel", "far_dual_softmax_tc_scratch", 3)
        fn = _build.bind("matching_kernel", "far_dual_softmax_rowcol_tc", 6, 4, 1)
        scratch = _build.scratch(size(B, L, S), f0)
        err = fn(f0.data_ptr(), f1.data_ptr(), row_val.data_ptr(),
                 row_idx.data_ptr(), col_max.data_ptr(), scratch.data_ptr(),
                 B, L, S, cp, float(inv_temp), _build.stream_of(f0))
    else:
        size = _build.bind_size("matching_kernel", "far_dual_softmax_scratch", 3)
        fn = _build.bind("matching_kernel", "far_dual_softmax_rowcol", 6, 5, 1)
        scratch = _build.scratch(size(B, L, S), f0)
        err = fn(f0.data_ptr(), f1.data_ptr(), row_val.data_ptr(),
                 row_idx.data_ptr(), col_max.data_ptr(), scratch.data_ptr(),
                 B, L, S, C, code, float(inv_temp), _build.stream_of(f0))
    _build.check(err, "dual_softmax_rowcol" + (" (bf16)" if tc else ""))
    _build.count_launch(dual_softmax_rowcol, "tc" if tc else "")
    return row_val, row_idx, col_max


dual_softmax_rowcol.launches = 0     # launches of either route
dual_softmax_rowcol.launches_tc = 0  # launches of the bfloat16 tensor-core route
