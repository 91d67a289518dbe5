"""Index samplers: which dataset items a rank reads, in which order.

The port's own copy of ``far_tpu/data/sampler.py``: the same numpy draws
from the same seeds (a test holds the index arrays equal).
``scene_balance_indices`` draws n items a scene, with or without
replacement, shuffles and repeats them; ``random_indices`` draws over the
whole set; ``sequential_indices`` is the evaluation's sharding. Each
returns this rank's contiguous or strided share.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def scene_balance_indices(
    scene_lengths: Sequence[int],
    n_samples_per_scene: int,
    seed: int,
    replacement: bool = True,
    shuffle: bool = True,
    repeat: int = 1,
    rank: int = 0,
    world_size: int = 1,
) -> np.ndarray:
    """n items a scene, a global shuffle, optional repetition, then this
    rank's contiguous slice."""
    rng = np.random.default_rng(seed)
    offsets = np.cumsum([0] + list(scene_lengths))
    chunks = []
    for s, length in enumerate(scene_lengths):
        if length == 0:
            continue
        if replacement:
            idx = rng.integers(0, length, size=n_samples_per_scene)
        else:
            idx = rng.permutation(length)[:min(n_samples_per_scene, length)]
        chunks.append(idx + offsets[s])
    out = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    if shuffle:
        out = rng.permutation(out)
    if repeat > 1:
        reps = [out]
        for _ in range(repeat - 1):
            reps.append(rng.permutation(out) if shuffle else out)
        out = np.concatenate(reps)
    per_rank = len(out) // world_size
    return out[rank * per_rank:(rank + 1) * per_rank]


def random_indices(
    n: int,
    num_samples: Optional[int] = None,
    seed: int = 0,
    replacement: bool = True,
    rank: int = 0,
    world_size: int = 1,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = num_samples or n
    idx = rng.integers(0, n, size=m) if replacement else rng.permutation(n)[:m]
    per_rank = len(idx) // world_size
    return idx[rank * per_rank:(rank + 1) * per_rank]


def sequential_indices(n: int, rank: int = 0, world_size: int = 1,
                       pad: bool = True) -> np.ndarray:
    """Evaluation sharding: every ``world_size``-th item from ``rank``; with
    ``pad`` the tail is filled by repeating the first items, so every rank
    reads as many (the aggregation drops repeats by identifier)."""
    idx = np.arange(n)
    if pad and n % world_size:
        idx = np.concatenate([idx, idx[: world_size - n % world_size]])
    return idx[rank::world_size]
