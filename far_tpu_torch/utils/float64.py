"""Run the port's float32 code in float64, to measure its rounding.

The models compute in ``compute_dtype(cfg)`` and cast to float32 where
the reference does (``.float()``, ``.to(torch.float32)``, factories with
``dtype=torch.float32``). Inside ``float64_compute()`` every such request
means float64 and every float32 tensor that an operation returns (one
read from numpy, say) is widened, so a float32 model whose parameters and
buffers were made float64 (``module.double()``) runs in float64 end to
end: the counterpart of the JAX package's tests reading ``jnp.float32``
as float64. Gradients of a float64 step then differ between two devices
by the step's condition number times float64's rounding, where float32's
would differ by that number times float32's.

The mode applies to what runs on the calling thread. Autograd's backward
of built-in operations needs none of it; a ``torch.autograd.Function``
whose backward runs Python (K4's ``bilinear_dual_softmax_auto``
recomputes its plain version there) is swapped for its plain version by
the caller. The CUDA kernels have no float64 route: they raise on it.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def _widen(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    if type(x) in (tuple, list):   # not the named results of torch.return_types
        return type(x)(_widen(v) for v in x)
    return x


class _Float64Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        elif func is torch.Tensor.to:
            args = tuple(torch.float64 if a is torch.float32 else a for a in args)
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        return _widen(func(*args, **kwargs))


def float64_compute() -> TorchFunctionMode:
    """Context manager: float32 means float64 inside it (module note)."""
    return _Float64Mode()
