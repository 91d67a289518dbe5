"""Communication helpers of the port, for one process.

The port's copy of ``far_tpu/parallel/comm.py``'s host side: identifier
strings as a fixed-width byte matrix (``encode_strings``,
``decode_strings``), so they can ride a fixed-shape gather beside the
metric arrays, and ``all_gather_metrics``, the identity in one process.
Gathering across processes (``torch.distributed`` with DDP, and the
JAX package's ``init_distributed`` and ``local_mesh``) is the multi-GPU
item of the roadmap and is not ported: with ``torch.distributed``
initialised at a world size above 1, ``all_gather_metrics`` raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.distributed as dist


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialised() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialised() else 1


def encode_strings(strings, width: int = 96) -> np.ndarray:
    """(N, width) uint8: each string's utf-8 bytes, cut at ``width`` and
    padded with zeros."""
    out = np.zeros((len(strings), width), np.uint8)
    for i, s in enumerate(strings):
        b = s.encode("utf-8")[:width]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def decode_strings(mat: np.ndarray) -> list:
    return [bytes(row[row != 0]).decode("utf-8", "replace") for row in mat]


def all_gather_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every process's metric arrays, joined on axis 0: in one process the
    input itself."""
    if process_count() == 1:
        return metrics
    raise NotImplementedError(
        "all_gather_metrics across processes is ROADMAP Queue 1 item 6 "
        "(multi-GPU with torch.distributed); the port runs one process")
