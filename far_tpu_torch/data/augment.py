"""Image augmentations.

The port's copy of ``far_tpu/data/augment.py`` (numpy, the same draws
from the same generator, so the outputs are bit-equal). Equivalent of
crockwell/far: mp3d_loftr/src/utils/augment.py (DarkAug /
MobileAug via albumentations — off by default in the reference) and the
8ptVit RGBDAugmentor color jitter, in pure numpy so the loader threads
can run them without extra deps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.1) -> np.ndarray:
    """Torchvision-style jitter on float [0, 1] HWC images."""
    out = img.astype(np.float32)
    if brightness:
        out = out * rng.uniform(1 - brightness, 1 + brightness)
    if contrast:
        mean = out.mean()
        out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    if out.shape[-1] == 3 and saturation:
        gray = out.mean(-1, keepdims=True)
        out = gray + (out - gray) * rng.uniform(1 - saturation, 1 + saturation)
    if out.shape[-1] == 3 and hue:
        shift = rng.uniform(-hue, hue)
        out = np.stack([out[..., 0], out[..., 1] + shift * 0.1,
                        out[..., 2] - shift * 0.1], -1)
    return np.clip(out, 0.0, 1.0)


def dark_aug(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Low-light simulation (reference DarkAug: gamma + brightness drop +
    gaussian noise)."""
    gamma = rng.uniform(1.5, 3.0)
    out = np.power(img.astype(np.float32), gamma)
    out = out * rng.uniform(0.4, 0.8)
    out = out + rng.normal(0, 0.02, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def mobile_aug(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Handheld-capture simulation (motion blur + jpeg-ish degradation)."""
    out = img.astype(np.float32)
    k = rng.integers(2, 5)
    axis = int(rng.integers(0, 2))
    kernel = np.ones(k, np.float32) / k
    out = np.apply_along_axis(
        lambda a: np.convolve(a, kernel, mode="same"), axis, out)
    out = np.round(out * 64) / 64  # quantization
    return np.clip(out, 0.0, 1.0)


def build_augmentor(name: Optional[str]):
    """None | 'dark' | 'mobile' | 'colorjitter' (reference augment.py:41)."""
    if name is None or name == "none":
        return None
    table = {"dark": dark_aug, "mobile": mobile_aug,
             "colorjitter": color_jitter}
    if name not in table:
        raise ValueError(f"unknown augmentor {name}")
    return table[name]
