"""The network guard: trained tiny weights through the whole FAR loop.

The port's copy of ``scripts/train_tiny_guard.py``'s ``TINY_SETS``,
``tiny_config``, ``load_guard`` and ``guard_eval``. ``assets/
tiny_guard.npz`` holds a small FARLoFTR trained on synthetic pairs (the
only weights in the repository that mean something) and the median
rotation error it reached at training time. ``guard_eval`` replays that
evaluation: 16 held-out synthetic pairs through ``far_forward``, the
error of each fused rotation against the ground truth. The JAX package's
bench fails when the median exceeds max(3 x the stored median, 5 deg);
``chip_smoke.py`` (phase 7) holds the port to the same gate on the card.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.pipeline import build_inference_fn, resolve_device
from far_tpu_torch.utils.config import (
    AttentionStackConfig,
    BackboneConfig,
    FARConfig,
    FineConfig,
    MatchConfig,
    RegressConfig,
    SolverOptions,
)
from far_tpu_torch.utils.convert_weights import flax_to_state_dict, load_flax_npz

GUARD_NPZ = Path(__file__).resolve().parents[2] / "assets" / "tiny_guard.npz"

TINY_SETS = dict(
    image_size=(64, 64),
    backbone=dict(initial_dim=16, block_dims=(16, 24, 32)),
    coarse=dict(d_model=32, nhead=4, layer_names=("self", "cross") * 2),
    match=dict(thr=0.0, border_rm=1, max_matches=64),
    fine=dict(d_model=16, nhead=4),
    regress=dict(d_model=32, emm_heads=4, hidden=64),
    solver=dict(num_hypotheses=256),
)


def tiny_config(dtype: str = "float32") -> FARConfig:
    """The guard's configuration (the 5-point solver, as FARConfig's)."""
    return FARConfig(
        image_size=TINY_SETS["image_size"],
        backbone=BackboneConfig(**TINY_SETS["backbone"]),
        coarse=AttentionStackConfig(**TINY_SETS["coarse"]),
        match=MatchConfig(**TINY_SETS["match"]),
        fine=FineConfig(**TINY_SETS["fine"]),
        regress=RegressConfig(**TINY_SETS["regress"]),
        solver=SolverOptions(**TINY_SETS["solver"]),
        dtype=dtype,
    )


def gate_deg(meta: Dict) -> float:
    """The JAX package's pass line for the guard's median (bench.py)."""
    return max(3.0 * meta["eval_rot_err_med_deg"], 5.0)


def load_guard(path=GUARD_NPZ, dtype: str = "float32",
               device=None) -> Tuple[FARLoFTR, Dict]:
    """(model in eval mode on ``device``, the npz's meta) from the guard's
    Flax weights, loaded with ``strict=True``."""
    variables, meta = load_flax_npz(path)
    cfg = tiny_config(dtype)
    model = FARLoFTR(cfg)
    sd = flax_to_state_dict(variables, cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.to(resolve_device(device)).eval(), meta


def rotation_errors_deg(R_est: torch.Tensor, R_gt: torch.Tensor) -> np.ndarray:
    """Geodesic angles between rotations, on the host in float64."""
    a = R_est.detach().double().cpu().numpy()
    b = R_gt.detach().double().cpu().numpy()
    cosang = (np.einsum("bij,bij->b", a, b) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))


def guard_eval(model: FARLoFTR, n: int = 16, seed: int = 4242,
               batch_size: int = 8, generator: Optional[torch.Generator] = None,
               uniforms: Optional[Sequence[torch.Tensor]] = None,
               prior_pcl: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float]:
    """(per-pair rotation errors in degrees (n,), their median) of the
    full loop on ``n`` held-out synthetic pairs, as
    ``scripts/train_tiny_guard.py:guard_eval`` draws them.

    ``uniforms`` (one tensor per solver round, see ``far_forward``) are
    handed to every batch, as the JAX guard draws every batch's from one
    key; without them the draws come from ``generator``."""
    device = next(model.parameters()).device
    ds = SyntheticPairDataset(n=n, hw=model.config.image_size, seed=seed,
                              n_scenes=n, max_angle_deg=12.0)
    fn = build_inference_fn(model)
    errs = []
    for b0 in range(0, n - batch_size + 1, batch_size):  # the tail is dropped
        batch, T = collate([ds[i] for i in range(b0, b0 + batch_size)], device)
        out = fn(batch, generator=generator, uniforms=uniforms,
                 prior_pcl=prior_pcl)
        errs.append(rotation_errors_deg(out.R, T[:, :3, :3]))
    errs = np.concatenate(errs)
    return errs, float(np.median(errs))

