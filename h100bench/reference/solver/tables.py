# Frozen copy of far_tpu_torch/utils/tables.py for the benchmark's plain reference: imports
# rewritten to this package, torch.linalg in place of the port's small-matrix kernels.
"""Fixed tables on a device, made once per (table, arguments, device, dtype).

A table built on the host and copied to the card on every call waits for
the card each time (a copy from pageable memory synchronises), and inside
a CUDA graph capture it is an error. ``device_table`` copies it once and
hands every later caller the same tensor, which nobody may change in
place. The tensor is made outside ``torch.inference_mode``, so autograd
can save it in a training step after an inference request made it.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def device_table(make: Callable[..., np.ndarray], *args, device, dtype) -> torch.Tensor:
    """``make(*args)`` as a tensor of ``dtype`` on ``device``, cached;
    ``make`` is a module-level function and ``args`` are hashable."""
    return _cached(make, args, torch.device(device), dtype)


@functools.lru_cache(maxsize=256)
def _cached(make, args, device, dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(make(*args), dtype=dtype, device=device)
