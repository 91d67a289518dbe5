"""Nister's 5-point minimal solve on the card: one launch for every sample
and basis rotation of a RANSAC round.

Replaces no Pallas kernel (``csrc/fivepoint.cu`` says why it exists, what
bounds it and its schedule). The plain version is
``geometry/fivepoint.run_5point_essential``: the CPU runs it, and the
kernel keeps its algorithm, constants, iteration counts and candidate
order in float32, with its fixed tables made from the same numpy arrays
(``kernel_tables``). A CUDA float32 input launches the kernel; any other
CUDA dtype, mixed devices or a shape the kernel does not take raise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from far_tpu_torch.geometry import fivepoint as plain
from far_tpu_torch.ops import _build
from far_tpu_torch.utils.tables import device_table

MAX_ROTATIONS = 4  # warps a block (csrc/fivepoint.cu: MAX_ROT)
ROOTS = 10         # candidates a rotation


def kernel_tables(n_rot: int) -> np.ndarray:
    """The kernel's fixed tables in one float32 array, in the order
    ``csrc/fivepoint.cu`` reads them (T_XY ... T_ROT): the xy-nodes, V^-T,
    the Chebyshev z-nodes, W^-1, the determinant's row mix, the
    Durand-Kerner start as (re, im) pairs and the basis rotations."""
    parts = (plain._XY_NODES, plain._VINV_T, plain._Z_NODES, plain._WINV_Z,
             plain._det_mix(ROOTS), plain._dk_start(ROOTS).view(np.float32),
             plain._basis_rotations(n_rot))
    return np.concatenate([np.asarray(p).astype(np.float32).ravel() for p in parts])


def fivepoint_essential(points1: torch.Tensor, points2: torch.Tensor,
                        n_basis_rotations: int = 2, real_tol: float = 5e-2,
                        det_tol: float = 2.5e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run_5point_essential`` (see it for the arguments and outputs):
    E (..., 10 R, 3, 3) and valid (..., 10 R), R = ``n_basis_rotations``;
    the plain version on the CPU, ``far_fivepoint`` on CUDA."""
    on_cpu = _build.on_cpu(points1, points2)
    _build.require(points1.shape == points2.shape and points1.ndim >= 2
                   and tuple(points1.shape[-2:]) == (5, 2),
                   f"fivepoint_essential takes two (..., 5, 2), got {tuple(points1.shape)} "
                   f"and {tuple(points2.shape)}")
    if on_cpu:
        return plain.run_5point_essential(points1, points2, real_tol=real_tol,
                                          n_basis_rotations=n_basis_rotations,
                                          det_tol=det_tol)
    _build.require(points1.dtype == torch.float32 and points2.dtype == torch.float32,
                   f"fivepoint_essential takes float32 on the card, got {points1.dtype} "
                   f"and {points2.dtype}")
    _build.require(1 <= n_basis_rotations <= MAX_ROTATIONS,
                   f"fivepoint_essential takes 1 to {MAX_ROTATIONS} basis rotations, got "
                   f"{n_basis_rotations}")
    _build.require(not (torch.is_grad_enabled()
                        and (points1.requires_grad or points2.requires_grad)),
                   "fivepoint_essential: the CUDA kernel has no gradient and an input "
                   "requires grad; run it under torch.no_grad()")
    lead = points1.shape[:-2]
    p1 = points1.reshape(-1, 5, 2).contiguous()
    p2 = points2.reshape(-1, 5, 2).contiguous()
    n = p1.shape[0]
    slots = ROOTS * n_basis_rotations
    E = torch.empty((n, slots, 3, 3), dtype=torch.float32, device=p1.device)
    valid = torch.empty((n, slots), dtype=torch.bool, device=p1.device)
    if n:
        tables = device_table(kernel_tables, n_basis_rotations, device=p1.device,
                              dtype=torch.float32)
        fn = _build.bind("fivepoint", "far_fivepoint", 5, 2, 2)
        _build.check(fn(p1.data_ptr(), p2.data_ptr(), tables.data_ptr(), E.data_ptr(),
                        valid.data_ptr(), n, n_basis_rotations, real_tol, det_tol,
                        _build.stream_of(p1)), "fivepoint_essential")
        _build.count_launch(fivepoint_essential)
    return E.reshape(*lead, slots, 3, 3), valid.reshape(*lead, slots)


fivepoint_essential.launches = 0  # launches of far_fivepoint
