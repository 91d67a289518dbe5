"""FARLoFTR: the LoFTR matcher + FAR regressor.

Counterpart of ``far_tpu/models/loftr.py:FARLoFTR`` (``match``,
``regress_features``, ``regress_fuse``) and of its
``TranslationScaleHead``. The backbone is ResNet-FPN 8/2
or 16/4 by ``backbone.resolution`` (16/4: a 1/16 coarse and a 1/4 fine
map, so 1200 coarse tokens at 480x640), normalised by BatchNorm or, with
``backbone.norm="group"``, GroupNorm. ``match`` follows the module's
mode: in training (``model.train()``) the backbone's BatchNorms use the
batch's statistics (GroupNorm is the same in both modes), the coarse
match goes through the dense confidence matrix (returned as
``conf_matrix`` for the loss) and the fine transformer runs layer by
layer; in eval K2 and K3 run. A coarse or fine stack with
``attention="full"`` runs softmax attention in plain torch and launches
no K1 (coarse) or K3 (fine), as the JAX package routes it. With ``match.match_type ==
"sinkhorn"`` the coarse match is optimal transport with a learned dustbin
score (``bin_score``) in plain torch in both modes, and K2 does not run.
In training, ``cfg.remat`` checkpoints the backbone (``True`` or
``"full"``: all of it is recomputed in the backward pass;
``"selective"``: the convolutions' outputs are kept and the BatchNorms
and activations between them recomputed), with the BatchNorms' running
statistics updated once per step. Child modules carry the reference's names
(``backbone``, ``loftr_coarse``, ``fine_preprocess``, ``loftr_fine``,
``loftr_regress``), so a reference state dict with its ``matcher.``
prefix stripped loads with ``strict=True``; the optional scale head is
``ts_head``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from far_tpu_torch.models.backbone import (
    build_backbone,
    coarse_channels,
    deferred_running_stats,
    update_running_stats,
)
from far_tpu_torch.models.constants import compute_normalized_6d
from far_tpu_torch.models.fine import (
    FinePreprocess,
    fine_coords_to_kpts,
    fine_matching,
)
from far_tpu_torch.models.matching import (
    coarse_match,
    ids_to_coords,
    select_topk_matches,
    sinkhorn_confidence,
)
from far_tpu_torch.models.position import add_sine_position_encoding
from far_tpu_torch.models.regressor import PoseRegressorEMM, lin
from far_tpu_torch.models.transformer import LocalFeatureTransformer
from far_tpu_torch.types import MatcherOutput, MatchResult, PairBatch, SolverSummary
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.prof import BACKBONE, COARSE, FINE, MATCH, mark


def compute_dtype(cfg) -> torch.dtype:
    """The compute dtype a model config (any family's) names."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _save_convolutions(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """remat='selective': keep the convolutions' outputs (the JAX package's
    'bb_conv' names), recompute every other op."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class TranslationScaleHead(nn.Module):
    """Metric translation scale (B,) float32 from the backbone's coarse maps
    of both images: per image 2x2 max-pool, 1x1 conv 128 + relu, 2x2
    max-pool, 1x1 convs 64 and 16 + relu (weights shared by the two
    images), then an MLP 512-512-1 over both flattened maps. The maps are
    flattened in (h, w, c) order, as the JAX package's NHWC maps are, so
    its ``fc1`` weights line up."""

    def __init__(self, c_in: int, coarse_hw):
        super().__init__()
        h, w = coarse_hw[0] // 4, coarse_hw[1] // 4
        self.c1 = nn.Conv2d(c_in, 128, 1)
        self.c2 = nn.Conv2d(128, 64, 1)
        self.c3 = nn.Conv2d(64, 16, 1)
        self.fc1 = nn.Linear(2 * 16 * h * w, 512)
        self.fc2 = nn.Linear(512, 512)
        self.fc3 = nn.Linear(512, 1)

    def _shrink(self, x: torch.Tensor) -> torch.Tensor:
        def conv(m, t):
            return F.conv2d(t, m.weight.to(t.dtype), m.bias.to(t.dtype))

        x = F.relu(conv(self.c1, F.max_pool2d(x, 2)))
        x = F.relu(conv(self.c2, F.max_pool2d(x, 2)))
        x = F.relu(conv(self.c3, x))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor) -> torch.Tensor:
        """feat_c0/feat_c1 (B, C, h, w) -> (B,) float32."""
        y = torch.cat([self._shrink(feat_c0), self._shrink(feat_c1)], dim=-1)
        y = F.relu(lin(self.fc1, y))
        y = F.relu(lin(self.fc2, y))
        return lin(self.fc3, y)[..., 0].float()


class FARLoFTR(nn.Module):
    # the stages ``match`` marks, and the map-free request's counters
    MATCH_STAGES = (BACKBONE, COARSE, MATCH, FINE)
    MAPFREE_PREFIX = "mapfree"

    def __init__(self, cfg: FARConfig):
        super().__init__()
        if cfg.match.match_type not in ("dual_softmax", "sinkhorn"):
            raise ValueError(f"unknown match_type {cfg.match.match_type!r}")
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = build_backbone(cfg.backbone)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.coarse.d_model, cfg.coarse.nhead, cfg.coarse.layer_names,
            attention=cfg.coarse.attention)
        if cfg.match.match_type == "sinkhorn":
            self.bin_score = nn.Parameter(
                torch.tensor(cfg.match.skh_init_bin_score, dtype=torch.float32))
        self.fine_preprocess = FinePreprocess(cfg.fine, cfg.coarse.d_model)
        self.loftr_fine = LocalFeatureTransformer(
            cfg.fine.d_model, cfg.fine.nhead, cfg.fine.layer_names,
            window_tokens=cfg.fine.window_size ** 2, attention=cfg.fine.attention)
        if cfg.regress_rt:
            self.loftr_regress = PoseRegressorEMM(cfg.regress, cfg.coarse_hw)
        if cfg.predict_translation_scale:
            self.ts_head = TranslationScaleHead(coarse_channels(cfg.backbone),
                                                cfg.coarse_hw)

    def coarse_features(self, image0: torch.Tensor, image1: torch.Tensor):
        """Backbone + position encoding + coarse transformer.

        Returns (feat_c, feat_f0, feat_f1, t0, t1): the backbone's coarse
        map of both images (2B, C, h, w), the fine maps (B, Hf, Wf, Cf)
        and the transformed coarse tokens (B, h*w, C)."""
        cfg = self.config
        hc, wc = cfg.coarse_hw
        B = image0.shape[0]
        imgs = torch.cat([image0, image1], dim=0).permute(0, 3, 1, 2)
        feat_c, feat_f = self.run_backbone(imgs.to(self.dtype))
        mark(BACKBONE)
        feat_c_hwc = feat_c.permute(0, 2, 3, 1)
        feat_f = feat_f.permute(0, 2, 3, 1).contiguous()
        t = add_sine_position_encoding(feat_c_hwc, cfg.coarse.temp_bug_fix)
        t = t.reshape(2 * B, hc * wc, -1).contiguous()
        t0, t1 = self.loftr_coarse(t[:B], t[B:])
        mark(COARSE)
        return feat_c, feat_f[:B], feat_f[B:], t0, t1

    def run_backbone(self, imgs: torch.Tensor):
        """The backbone, under ``torch.utils.checkpoint`` in training when
        ``cfg.remat`` asks for it (eval ignores the field). The BatchNorms'
        running updates of the first pass are applied once, after it; those
        of the backward pass's recompute are dropped."""
        remat = self.config.remat
        if not (self.training and remat):
            return self.backbone(imgs)
        passes = []

        def run(x):
            with deferred_running_stats([]) as stats:
                out = self.backbone(x)
            passes.append(stats)
            return out

        context = {}
        if remat == "selective":
            context["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_convolutions)
        out = checkpoint(run, imgs, use_reentrant=False, **context)
        update_running_stats(passes[0])
        return out

    def fine_stage(self, feat_f0, feat_f1, t0, t1, i_ids, j_ids):
        """Window gather + fine transformer + soft-argmax -> expec_f."""
        cfg = self.config
        stride = cfg.backbone.resolution[0] // cfg.backbone.resolution[1]
        f0w, f1w = self.fine_preprocess(feat_f0, feat_f1, t0, t1, i_ids,
                                        j_ids, cfg.coarse_hw, stride)
        return fine_matching(self.loftr_fine, f0w, f1w, cfg.fine.window_size)

    def match(self, batch: PairBatch) -> MatcherOutput:
        """Backbone + coarse transformer + coarse/fine matching, with the
        end of each of these four stages marked (``utils.prof.mark``:
        ``BACKBONE``, ``COARSE``, ``MATCH``, ``FINE``) for the compiled
        request."""
        cfg = self.config
        hc, wc = cfg.coarse_hw
        feat_c, feat_f0, feat_f1, t0, t1 = self.coarse_features(
            batch.image0, batch.image1)
        B = batch.image0.shape[0]
        translation_scale = None
        if cfg.predict_translation_scale:  # from the maps before the transformer
            translation_scale = self.ts_head(feat_c[:B], feat_c[B:])
        stride = float(cfg.backbone.resolution[0])
        if cfg.match.match_type == "sinkhorn":
            conf = sinkhorn_confidence(t0, t1, self.bin_score, cfg.match.skh_iters)
            i_ids, j_ids, mconf, valid = select_topk_matches(
                conf, (hc, wc), (hc, wc), cfg.match)
            mkpts0 = ids_to_coords(i_ids, wc, stride, batch.scale0) * valid[..., None]
            mkpts1 = ids_to_coords(j_ids, wc, stride, batch.scale1) * valid[..., None]
            if not self.training:
                conf = None
        else:
            res = coarse_match(
                t0, t1, (hc, wc), (hc, wc), stride, cfg.match,
                scale0=batch.scale0, scale1=batch.scale1, return_conf=self.training)
            i_ids, j_ids, mconf, valid, mkpts0, mkpts1 = res[:6]
            conf = res[6] if self.training else None
        mark(MATCH)
        expec_f = self.fine_stage(feat_f0, feat_f1, t0, t1, i_ids, j_ids)
        mkpts1_f = fine_coords_to_kpts(
            expec_f, mkpts1, cfg.fine.window_size,
            float(cfg.backbone.resolution[1]), batch.scale1)
        mkpts1_f = torch.where(valid[..., None], mkpts1_f, mkpts1)
        mark(FINE)
        matches = MatchResult(
            i_ids=i_ids, j_ids=j_ids, mconf=mconf, valid=valid,
            mkpts0=mkpts0, mkpts1=mkpts1, mkpts0_f=mkpts0, mkpts1_f=mkpts1_f,
            expec_f=expec_f)
        return MatcherOutput(matches=matches, feat_c0=t0, feat_c1=t1,
                             conf_matrix=conf,
                             translation_scale=translation_scale)

    def solver_pose_in(self, summary: SolverSummary) -> torch.Tensor:
        """Normalized 9D solver pose + correspondence counts / 500."""
        cfg = self.config
        parts = [compute_normalized_6d(summary.rt)]
        if cfg.regress.use_num_corres:
            parts.append(summary.num_after[..., None] / 500.0)
        if cfg.regress.use_many_ransac_thr:
            parts.append(summary.num_before[..., None] / 500.0)
            parts.append(summary.num_tight[..., None] / 500.0)
            parts.append(summary.num_ultra_tight[..., None] / 500.0)
        return torch.cat(parts, dim=-1)

    def regress_features(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor):
        """EMM features; they do not depend on the solver pose, so the
        prior loop computes them once."""
        return self.loftr_regress.features_only(feat_c0, feat_c1)

    def regress_fuse(self, features: torch.Tensor, summary: SolverSummary):
        """MoE fusion of the EMM features with a solver pose ->
        (pose_9d, gate)."""
        return self.loftr_regress.fuse(features, self.solver_pose_in(summary))
