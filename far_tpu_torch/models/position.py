"""2D sinusoidal position encoding.

Counterpart of ``far_tpu/models/position.py``, including the
``temp_bug_fix`` switch. The table is built with numpy once per shape
and copied to each device once per dtype.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from far_tpu_torch.utils.tables import device_table


@functools.lru_cache(maxsize=8)
def _sine_table(d_model: int, h: int, w: int, temp_bug_fix: bool) -> np.ndarray:
    pe = np.zeros((d_model, h, w), np.float32)
    y_position = np.cumsum(np.ones((h, w), np.float32), axis=0)[None]
    x_position = np.cumsum(np.ones((h, w), np.float32), axis=1)[None]
    if temp_bug_fix:
        div_term = np.exp(
            np.arange(0, d_model // 2, 2, dtype=np.float32)
            * (-math.log(10000.0) / (d_model // 2))
        )
    else:  # reproduces the original LoFTR bug for old checkpoints
        div_term = np.exp(
            np.arange(0, d_model // 2, 2, dtype=np.float32)
            * (-math.log(10000.0) / d_model // 2)
        )
    div_term = div_term[:, None, None]
    pe[0::4] = np.sin(x_position * div_term)
    pe[1::4] = np.cos(x_position * div_term)
    pe[2::4] = np.sin(y_position * div_term)
    pe[3::4] = np.cos(y_position * div_term)
    return pe.transpose(1, 2, 0)  # HWC


def add_sine_position_encoding(x: torch.Tensor,
                               temp_bug_fix: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) -> x + PE."""
    _, h, w, c = x.shape
    pe = device_table(_sine_table, c, h, w, temp_bug_fix, device=x.device, dtype=x.dtype)
    return x + pe[None]
