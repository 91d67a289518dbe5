"""ViTEss: the 8-point ViT relative-rotation model (NCHW inside).

Counterpart of ``far_tpu/models/vitess.py`` with the reference's module
names (interiornetStreetlearn_8ptVit ``src/model.py``): a torchvision
ResNet18 trunk through layer2 (``resnet``), a RAFT residual block whose
VALID 5x5 convolutions take 28x28 to 24x24 (``extractor_final_conv``), a
ViT-tiny stack whose last block is the epipolar CrossBlock
(``fusion_transformer.blocks``, K4 twice at 576 tokens), the pose MLP
(``pose_regressor``) and the optional LoFTR-gating MoE
(``moe_predictor``). A reference checkpoint loads through
``utils/convert_weights.load_reference_state_dict``. Parameters stay
float32 and are cast where they are used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.geometry.rotations import matrix_to_rotation_6d, ortho6d_to_matrix_rc
from far_tpu_torch.models.attention import full_attention
from far_tpu_torch.models.backbone import BasicBlock, bn, conv
from far_tpu_torch.models.loftr import compute_dtype
from far_tpu_torch.models.regressor import CrossBlockEMM, Mlp, _seq, lin, ln, run_seq

# Per-dataset 9D pose normalization (reference
# interiornetStreetlearn_8ptVit/train.py:148-164)
VITESS_POSE_STATS = {
    "matterport": (
        np.array([-0.06979753, 0.03417105, -0.17588863, 0.50275223,
                  0.03533648, -0.18179045, -0.03533648, 0.98189617,
                  0.09313615], np.float32),
        np.array([0.38802881, 0.07354026, 0.37663504, 0.51837117,
                  0.12717603, 0.65426397, 0.12717603, 0.0188729,
                  0.09709263], np.float32),
    ),
    "interiornet_T": (
        np.array([0, 0, 0, 0.92456496, -0.00201821, -0.00987212,
                  -0.00019313, 0.72139406, -0.00184757], np.float32),
        np.array([1, 1, 1, 0.07689704, 0.17564303, 0.32912105,
                  0.1753406, 0.27482772, 0.6109926], np.float32),
    ),
    "interiornet": (
        np.array([0, 0, 0, 0.9275364, -0.00368287, -0.00655767,
                  0.00045095, 0.7385428, -0.00683342], np.float32),
        np.array([1, 1, 1, 0.07534314, 0.1704135, 0.32389316,
                  0.17006727, 0.27120626, 0.5933235], np.float32),
    ),
    "streetlearn_T": (
        np.array([0, 0, 0, 0.828742, 0.00034936, -0.00100069,
                  -0.00250733, 0.7001684, -0.00283758], np.float32),
        np.array([1, 1, 1, 0.16392577, 0.2663457, 0.46407992,
                  0.26599622, 0.27905113, 0.60093635], np.float32),
    ),
    "streetlearn": (
        np.array([0, 0, 0, 0.8217494, -0.0019066, -0.00003673,
                  -0.00000574, 0.697334, -0.00272899], np.float32),
        np.array([1, 1, 1, 0.16815728, 0.27100316, 0.47223347,
                  0.27088866, 0.2769559, 0.60302496], np.float32),
    ),
}

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTEssConfig:
    dim: int = 192
    depth: int = 6                 # last block is the CrossBlock
    num_heads: int = 3
    feature_hw: Tuple[int, int] = (24, 24)
    fc_hidden: int = 512
    # epipolar-basis focals in grid cells (normalized focal 1.0 on the
    # 24x24 token grid for InteriorNet/StreetLearn)
    grid_fx: float = 12.0
    grid_fy: float = 12.0
    fusion_transformer: bool = True
    pool_size: int = 60            # non-transformer pooling path
    use_loftr_gating: bool = False
    use_normalized_6d: bool = True
    dataset: str = "interiornet_T"
    dtype: str = "bfloat16"


class ResNet18Trunk(nn.Module):
    """torchvision ResNet18 through layer2: 224x224 -> 28x28x128."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(bn(conv(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer2(self.layer1(x))


class RaftResidualBlock(nn.Module):
    """RAFT residual block (reference extractor.py:5-66, batch norm) with
    VALID kxk second and shortcut convolutions. ``norm3`` is registered
    twice, as in the reference: also as ``downsample.1``."""

    def __init__(self, cin: int, planes: int, k: int = 5):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, 1, 1)
        self.conv2 = nn.Conv2d(planes, planes, k)
        self.norm1 = nn.BatchNorm2d(planes)
        self.norm2 = nn.BatchNorm2d(planes)
        self.norm3 = nn.BatchNorm2d(planes)
        self.downsample = nn.Sequential(nn.Conv2d(cin, planes, k), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(bn(conv(x, self.conv1), self.norm1))
        y = F.relu(bn(conv(y, self.conv2), self.norm2))
        d = bn(conv(x, self.downsample[0]), self.norm3)
        return F.relu(d + y)


class Attention(nn.Module):
    """timm multi-head self-attention, softmax in float32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        q, k, v = lin(self.qkv, x).reshape(B, N, 3, self.num_heads, -1).unbind(2)
        return lin(self.proj, full_attention(q, k, v).reshape(B, N, C))


class ViTSelfBlock(nn.Module):
    """Pre-norm ViT block (timm; LayerNorm eps 1e-6, exact-erf GELU)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(ln(self.norm1, x))
        return x + self.mlp(ln(self.norm2, x))


class FusionTransformer(nn.Module):
    """Position embedding, depth - 1 ViT blocks, the CrossBlock, LayerNorm."""

    def __init__(self, cfg: ViTEssConfig):
        super().__init__()
        n = cfg.feature_hw[0] * cfg.feature_hw[1]
        self.pos_embed = nn.Parameter(torch.zeros(1, n, cfg.dim))
        self.blocks = nn.ModuleList(
            [ViTSelfBlock(cfg.dim, cfg.num_heads) for _ in range(cfg.depth - 1)]
            + [CrossBlockEMM(cfg.dim, cfg.num_heads, cfg.feature_hw,
                             (cfg.grid_fx, cfg.grid_fy), ln_eps=1e-6,
                             basis_xy_first=True)])
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (2B, N, C), the pairs' images interleaved -> (B, 2 Dv, C)."""
        x = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks[:-1]:
            x = blk(x)
        x = x.reshape(-1, 2, *x.shape[1:])
        return ln(self.norm, self.blocks[-1](x[:, 0], x[:, 1]))


class ViTEss(nn.Module):
    """8-point ViT pose regressor; ``forward`` returns (t (B, 3),
    R (B, 3, 3), the normalized 9D pose (B, 9), gate (B, 2) or None)."""

    # convolution biases that feed a train-mode BatchNorm: the normalisation
    # removes them, so their exact gradient is 0 and a computed one is
    # rounding noise (comparisons hold them to their weight's gradient)
    BIAS_BEFORE_BN = ("extractor_final_conv.conv1.bias", "extractor_final_conv.conv2.bias",
                      "extractor_final_conv.downsample.0.bias",
                      "pool_transformer_output.0.bias", "pool_transformer_output.3.bias")

    def __init__(self, cfg: Optional[ViTEssConfig] = None):
        super().__init__()
        cfg = cfg or ViTEssConfig()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        fh, fw = cfg.feature_hw
        self.resnet = ResNet18Trunk()
        self.extractor_final_conv = RaftResidualBlock(128, cfg.dim, max(1, 28 - fh + 1))
        if cfg.fusion_transformer:
            self.fusion_transformer = FusionTransformer(cfg)
            feat = 2 * (cfg.dim // cfg.num_heads + 6) * cfg.dim
        else:
            p1 = min(96, 4 * cfg.pool_size)
            # Flax's default momentum 0.99 here (torch's 0.01)
            self.pool_transformer_output = nn.Sequential(
                nn.Conv2d(cfg.dim, p1, 1), nn.BatchNorm2d(p1, momentum=0.01), nn.ReLU(),
                nn.Conv2d(p1, cfg.pool_size, 1), nn.BatchNorm2d(cfg.pool_size, momentum=0.01))
            feat = 2 * cfg.pool_size * fh * fw
        hid = cfg.fc_hidden
        self.pose_regressor = _seq(feat, hid, hid, 9)
        if cfg.use_loftr_gating:
            self.moe_predictor = _seq(feat + 9 + 10, hid, hid, 2)
        mean, std = VITESS_POSE_STATS[cfg.dataset]
        self.register_buffer("pose_mean", torch.from_numpy(mean), persistent=False)
        self.register_buffer("pose_std", torch.from_numpy(std), persistent=False)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W, 3) RGB in [0, 1] -> (2B, 3, 224, 224): ImageNet
        normalization, then torch's nearest resize (src = floor(dst in/out),
        in float32) to 224, cast to the compute dtype."""
        mean = images.new_tensor(_IMAGENET_MEAN)
        std = images.new_tensor(_IMAGENET_STD)
        x = ((images - mean) / std).flatten(0, 1)
        H, W = x.shape[1:3]
        if (H, W) != (224, 224):
            src = lambda n: torch.from_numpy(np.floor(
                np.arange(224, dtype=np.float32) * np.float32(n / 224)).astype(np.int64))
            x = x[:, src(H).to(x.device)][:, :, src(W).to(x.device)]
        return x.permute(0, 3, 1, 2).contiguous().to(self.dtype)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Images -> the flattened features (B, F) the heads take."""
        cfg = self.config
        B = images.shape[0]
        x = self.extractor_final_conv(self.resnet(self.preprocess(images)))
        if not cfg.fusion_transformer:
            seq = self.pool_transformer_output
            x = F.relu(bn(conv(x, seq[0]), seq[1]))
            x = bn(conv(x, seq[3]), seq[4])
            return x.reshape(B, -1)   # each image's (C, H, W), as the reference
        tokens = x.flatten(2).transpose(1, 2)              # (2B, N, C)
        return self.fusion_transformer(tokens).reshape(B, -1)

    def heads(self, features: torch.Tensor,
              solver_pose: Optional[torch.Tensor] = None,
              solver_num_corr: Optional[torch.Tensor] = None):
        """The pose MLP, the gating MoE and the decode."""
        cfg = self.config
        pred_9d = run_seq(self.pose_regressor, features).float()
        gate = None
        if cfg.use_loftr_gating:
            if solver_pose is None or solver_num_corr is None:
                raise ValueError("use_loftr_gating needs the solver pose and count")
            raw = torch.cat([solver_pose[..., :3, 3].float(),
                             matrix_to_rotation_6d(solver_pose[..., :3, :3].float())], -1)
            if cfg.use_normalized_6d:
                raw = (raw - self.pose_mean) / self.pose_std
            sp = torch.cat([raw, solver_num_corr.float()[..., None] / 500.0], -1)
            gin = torch.cat([features.float(), pred_9d, sp], -1).to(features.dtype)
            gate = torch.sigmoid(run_seq(self.moe_predictor, gin)).float()
            pred_9d = torch.cat([
                gate[..., :1] * pred_9d[..., :3] + (1 - gate[..., :1]) * sp[..., :3],
                gate[..., 1:] * pred_9d[..., 3:] + (1 - gate[..., 1:]) * sp[..., 3:9]], -1)
        un = pred_9d * self.pose_std + self.pose_mean if cfg.use_normalized_6d else pred_9d
        return un[..., :3], ortho6d_to_matrix_rc(un[..., 3:]), pred_9d, gate

    def forward(self, images: torch.Tensor,
                solver_pose: Optional[torch.Tensor] = None,
                solver_num_corr: Optional[torch.Tensor] = None):
        return self.heads(self.features(images), solver_pose, solver_num_corr)
