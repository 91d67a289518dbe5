"""The reference's canonical experiments as presets.

Counterpart of ``far_tpu/configs.py``: each preset is a model
configuration, an optimizer configuration, a curriculum and the global
batch, from the reference's shell drivers (Matterport3D FAR training,
InteriorNet / StreetLearn 8-point ViT, map-free 6DReg with LoFTR and
prior), built from the port's own ``FARConfig``, ``ViTEssConfig``,
``SixDRegConfig``, ``OptimConfig`` and curricula.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from far_tpu_torch.models.sixdreg import SixDRegConfig
from far_tpu_torch.models.vitess import ViTEssConfig
from far_tpu_torch.train.checkpoint import (
    MAPFREE_CURRICULUM,
    MATTERPORT_CURRICULUM,
    CurriculumPhase,
)
from far_tpu_torch.train.optim import OptimConfig
from far_tpu_torch.utils.config import FARConfig, SolverOptions


@dataclasses.dataclass(frozen=True)
class ExperimentPreset:
    name: str
    model: object
    optim: OptimConfig
    curriculum: Tuple[CurriculumPhase, ...]
    batch_size: int
    notes: str = ""


def matterport() -> ExperimentPreset:
    """Matterport3D FAR training: AdamW at the canonical lr 6e-3 for a
    global batch of 64, 4800 warm-up steps, MultiStepLR, the 4-phase
    curriculum."""
    return ExperimentPreset(
        name="matterport_far",
        model=FARConfig(
            image_size=(480, 640),
            solver=SolverOptions(solver="prior_ransac", fine_pred_steps=2),
            dtype="bfloat16",
        ),
        optim=OptimConfig(
            optimizer="adamw", lr=6e-3, adamw_decay=0.1,
            warmup_steps=4800, scheduler="multistep",
            mslr_milestones=(3, 6, 9, 12), mslr_gamma=0.5, grad_clip=0.5,
        ),
        curriculum=MATTERPORT_CURRICULUM,
        batch_size=64,
        notes="lr scales linearly with global batch / 64 "
              "(reference train.py:199-211)",
    )


def interiornet(variant: str = "T") -> ExperimentPreset:
    """8-point ViT extreme-rotation training: 120k steps at batch 6, Adam
    5e-4 with OneCycle, gated by the LoFTR solver's pose."""
    return ExperimentPreset(
        name=f"interiornet_{variant}_vitess",
        model=ViTEssConfig(
            dataset="interiornet_T" if variant == "T" else "interiornet",
            use_loftr_gating=True, dtype="bfloat16",
        ),
        optim=OptimConfig(
            optimizer="adam", lr=5e-4, warmup_steps=0,
            scheduler="onecycle", onecycle_total_steps=120_000,
            grad_clip=1.0,
        ),
        curriculum=(
            CurriculumPhase("vit", 1, True, False, "prior_ransac_noprior",
                            1.0, 1.0, coarse_weight=0.0, fine_weight=0.0),
        ),
        batch_size=6,
    )


def streetlearn(variant: str = "T") -> ExperimentPreset:
    p = interiornet(variant)
    return dataclasses.replace(
        p,
        name=f"streetlearn_{variant}_vitess",
        model=dataclasses.replace(
            p.model,
            dataset="streetlearn_T" if variant == "T" else "streetlearn"),
    )


def mapfree() -> ExperimentPreset:
    """Map-free 6DReg with LoFTR and prior: batch 24 over 4 GPUs, Adam
    1e-5, the 3-phase curriculum."""
    return ExperimentPreset(
        name="mapfree_6dreg_loftr",
        model=SixDRegConfig(dtype="bfloat16"),
        optim=OptimConfig(
            optimizer="adam", lr=1e-5, warmup_steps=0, scheduler="none",
            grad_clip=1.0,
        ),
        curriculum=MAPFREE_CURRICULUM,
        batch_size=24,
        notes="scene_balance sampler, 700 samples/scene with replacement; "
              "overlap filter [0.4, 0.8]",
    )


PRESETS = {
    "matterport": matterport,
    "interiornet": interiornet,
    "streetlearn": streetlearn,
    "mapfree": mapfree,
}
