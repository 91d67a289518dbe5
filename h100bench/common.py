"""What the entries share: the seed's streams, configuration dataclasses
from the configuration file, and a reference's parameter shapes."""

from __future__ import annotations

import dataclasses

import torch

# streams of the seed: weights, pairs, uniforms, the check's sample
WEIGHTS, PAIRS, UNIFORMS, SAMPLE = 0, 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    return (seed * 4 + stream) % (2 ** 63)


def build(cls, values: dict):
    """A (nested) config dataclass from the configuration file's dict."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if dataclasses.is_dataclass(f.default):
            v = build(type(f.default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def state_shapes(make) -> dict:
    """{name: shape} of ``make()``'s state dict, built without memory."""
    with torch.device("meta"):
        module = make()
    return {k: v.shape for k, v in module.state_dict().items()}


def pin(tensors, device):
    """Pool tensors in pinned host memory where the device is a card."""
    return [t.cpu().pin_memory() if device.type == "cuda" else t for t in tensors]
