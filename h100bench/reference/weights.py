"""Random weights from a seed, made on the device in a few large calls.

The init arithmetic of the program's ``init_weights`` (Flax's defaults):
LeCun-normal kernels (normal / sqrt(fan_in)), unit norm scales, zero
biases and BatchNorm means, unit variances. All kernels come from one
normal draw of a ``torch.Generator`` on the device, cut in sorted key
order, so the same seed gives the same weights on any run.
"""

from __future__ import annotations

from typing import Dict

import torch


def make_state_dict(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: shape} of a module's state dict -> float32 tensors on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    kernels = [k for k in names if len(shapes[k]) >= 2]
    sizes = [shapes[k].numel() for k in kernels]
    draw = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for k, part in zip(kernels, torch.split(draw, sizes)):
        fan_in = shapes[k][1:].numel()
        out[k] = (part / fan_in ** 0.5).reshape(shapes[k])
    for k in names:
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith("running_var") or (k.endswith("weight") and len(shapes[k]) == 1):
            out[k] = torch.ones(shapes[k], device=device)
        else:
            out[k] = torch.zeros(shapes[k], device=device)
    return out
