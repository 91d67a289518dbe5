"""The float32 tensor-core routes' arithmetic (3xTF32), in plain torch.

The float32 routes of K1, K3 and K4 (``far_loftr_layer_tf32``,
``far_fine_transformer_tf32`` and ``far_bilinear_dual_softmax_tf32`` in
``far_tpu_torch/csrc``) run each
product on the tensor cores as three TF32 products: every operand x is
split into big = tf32(x) and small = tf32(x - big), and a b becomes
small_a big_b + big_a small_b + big_a big_b, accumulated in float32. The
dropped small_a small_b term is ~2^-22 of |a||b|, so the sum keeps float32
accuracy where one TF32 product keeps ~2^-11.

These functions model that arithmetic for the CPU tests
(``tests/test_torch_tf32.py``); the kernels do it in registers and shared
memory (``cvt.rna.tf32.f32``, ``csrc/hopper.cuh``), and no wrapper calls
them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: add 0x1000 to the bits, clear the
    low 13. A carry runs into the exponent; inf and NaN pass through."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big = round_tf32(x), small = round_tf32(x - big)."""
    big = round_tf32(x)
    return big, round_tf32(x.float() - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the routes compute it: small.big + big.small + big.big, in
    float32, in that order."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big
