"""Frozen-dataclass config tree of the PyTorch port.

The port's own copy of ``far_tpu/utils/config.py``: the same fields and
defaults (a test holds the two equal), so a config means the same thing
to both packages. Fields that only the JAX package reads (TPU layout
switches) are kept so the two stay comparable.
Hierarchy: FARConfig{backbone, coarse, match, fine, regress, solver,
loss}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)
    resolution: Tuple[int, int] = (8, 2)  # (coarse, fine) strides
    norm: str = "batch"  # 'batch' | 'group'


@dataclasses.dataclass(frozen=True)
class AttentionStackConfig:
    d_model: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"  # 'linear' | 'full'
    temp_bug_fix: bool = True


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    thr: float = 0.2
    border_rm: int = 2
    match_type: str = "dual_softmax"  # 'dual_softmax' | 'sinkhorn'
    dsmax_temperature: float = 0.1
    skh_iters: int = 3
    skh_init_bin_score: float = 1.0
    max_matches: int = 1024        # static top-k replacing dynamic filtering
    train_pad_num_gt_min: int = 200
    train_coarse_percent: float = 0.2
    sparse_spvs: bool = True


@dataclasses.dataclass(frozen=True)
class FineConfig:
    d_model: int = 128
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear"
    window_size: int = 5
    concat_coarse_feat: bool = True
    # merge([windows || coarse]) as a split product (same weights); the
    # port's FinePreprocess always computes it that way
    split_merge: bool = True


@dataclasses.dataclass(frozen=True)
class RegressConfig:
    d_model: int = 256
    nhead_stack: int = 8          # heads of the optional extra loftr layers
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear"
    num_loftr_layers: int = 0      # reference regress_loftr_layers
    emm_heads: int = 4
    use_pos_embedding: bool = False
    use_simple_moe: bool = True
    use_1wt: bool = False
    use_2wt: bool = True
    scale_8pt: bool = True
    use_num_corres: bool = True    # append num matches to solver pose input
    use_many_ransac_thr: bool = True  # append tight/ultra-tight counts
    hidden: int = 512
    # Focal lengths (in coarse-grid cells) used to build the epipolar
    # positional basis. The reference hardcodes the mp3d values
    # (transformer.py:194-196) and asserts per-batch intrinsics equality;
    # we expose them so other camera grids (mapfree/streetlearn) can't
    # silently reuse the mp3d basis. Principal point is assumed at the
    # grid center (true for all supported datasets after resize).
    grid_fx: float = 517.0 / 9.0
    grid_fy: float = 517.0 / 8.0


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    solver: str = "prior_ransac"   # 'ransac'|'prior_ransac'|'prior_ransac_noprior'|'none'
    minimal_solver: str = "5pt"    # '5pt' (Nister; matches the reference's
                                   # essential_cv2 production default,
                                   # metrics.py:114 + ransac.py:151-157) or
                                   # '8pt' (cheaper, equal at low noise —
                                   # see README 5pt-vs-8pt A/B).
    num_hypotheses: int = 2048
    # hypothesis budget of the prior-refinement rounds: prior-biased
    # sampling concentrates minimal samples on near-inliers
    refine_num_hypotheses: int = 1024
    pixel_thr: float = 0.5
    prior_inl_th: float = 3e-7
    prior_lambda: float = 0.3
    bias_sigma_sq: float = 0.1
    fine_pred_steps: int = 2       # prior refinement rounds
    scoring: str = "inlier"        # 'inlier' (hard count, prior_ransac
                                   # parity) or 'magsac' (sigma-
                                   # marginalized, the mapfree
                                   # cv2.USAC_MAGSAC equivalent)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    coarse_type: str = "focal"
    coarse_weight: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    fine_type: str = "l2_with_std"
    fine_weight: float = 1.0
    fine_correct_thr: float = 1.0
    rt_weight_rot: float = 1.0
    rt_weight_tr: float = 1.0
    use_l1_rt_loss: bool = True
    scale_weight: float = 0.0
    max_scale_loss: float = 1.0


@dataclasses.dataclass(frozen=True)
class FARConfig:
    """Top-level model + pipeline config for the LoFTR-FAR family."""

    image_size: Tuple[int, int] = (480, 640)  # (H, W)
    backbone: BackboneConfig = BackboneConfig()
    coarse: AttentionStackConfig = AttentionStackConfig()
    match: MatchConfig = MatchConfig()
    fine: FineConfig = FineConfig()
    regress: RegressConfig = RegressConfig()
    solver: SolverOptions = SolverOptions()
    loss: LossConfig = LossConfig()
    regress_rt: bool = True
    predict_translation_scale: bool = False
    dtype: str = "float32"  # compute dtype: 'float32' | 'bfloat16'
    # backbone rematerialization in training (False | True | 'full' |
    # 'selective': keep the convolutions' outputs); inference ignores it
    remat: Union[bool, str] = False

    def __post_init__(self):
        s = self.backbone.resolution[0]
        H, W = self.image_size
        if H % s or W % s:
            raise ValueError(
                f"image_size {self.image_size} must be divisible by the "
                f"coarse stride {s} (the FPN halves/doubles resolutions; "
                f"odd sizes break the skip connections)")

    @property
    def coarse_hw(self) -> Tuple[int, int]:
        s = self.backbone.resolution[0]
        return (self.image_size[0] // s, self.image_size[1] // s)

    @property
    def fine_hw(self) -> Tuple[int, int]:
        s = self.backbone.resolution[1]
        return (self.image_size[0] // s, self.image_size[1] // s)


def default_config() -> FARConfig:
    return FARConfig()
