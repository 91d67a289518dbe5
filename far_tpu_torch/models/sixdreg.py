"""Map-free 6DReg: ResUNet encoder, correlation-volume warping, DeepResBlock
head, vanilla transformer and MoE fusion with the solver pose (NCHW inside).

Counterpart of ``far_tpu/models/sixdreg.py`` (``SixDRegConfig``,
``PreActBlock``, ``PreActBottleneck``, ``ResUNet``,
``CorrelationVolumeWarping`` under every aggregator flag,
``CorrelationVolumeWarpingQKV``, ``ConcatAggregator``,
``DeepResBlockHead``, ``ProcrustesHead``, ``AngularBinsHead``,
``QuaternionHead``, ``TorchTransformerEncoderLayer``,
``MapfreeRegression``) with the reference's module names
(mapfree_6dreg ``lib/models/regression``): ``encoder`` (``firstconv``,
``encoder1.0.shortcut.0``, ``upconv4.conv1.conv``, ``iconv4.normalize``,
...), ``head.resblock1-3``, ``transformer.layers.i`` (``self_attn.
in_proj_weight``, ``linear1``, ``norm1``, ...), ``pose_regressor``,
``moe_predictor``; and the classical baseline ``FeatureMatchingModel``
(a matcher, then an essential-matrix, metric or PnP solver on the card).
The pose and MoE MLPs take the transformer's tokens
flattened channel-major, (B, C, L), as the reference feeds them, so its
weights load as they are (the JAX package flattens token-major and
permutes the first Linear instead); a reference checkpoint loads through
``utils/convert_weights.load_reference_state_dict``. The aggregator's
three products are plain ``torch.matmul`` in float32, as the JAX package
computes them outside any Pallas kernel; no kernel runs in this model.
Parameters stay float32 and are cast where they are used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.geometry.rotations import (
    matrix_to_rotation_6d,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)
from far_tpu_torch.geometry.solvers import procrustes
from far_tpu_torch.models.attention import full_attention
from far_tpu_torch.models.backbone import _up2, bn, conv
from far_tpu_torch.models.loftr import compute_dtype
from far_tpu_torch.models.regressor import _seq, lin, ln, run_seq
from far_tpu_torch.solvers.metric import metric_scale_ransac, pnp_ransac
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose


@dataclasses.dataclass(frozen=True)
class SixDRegConfig:
    image_hw: Tuple[int, int] = (368, 272)   # padded 360x270 regressor input
    encoder_blocks: Tuple[int, ...] = (3, 3, 3)
    encoder_bottleneck: bool = True           # BLOCK_TYPE=1
    encoder_out_layers: int = 32
    not_concat: bool = False
    # aggregator flags (reference config/default.py AGGREGATOR tree)
    position_encoder: bool = True
    position_encoder_im1: bool = False
    max_score_channel: bool = True
    normalise_dot: bool = False
    cv_half_channels: bool = False
    use_vanilla_transformer: bool = True
    transformer_layers: int = 6
    transformer_heads: int = 8
    d_im: int = 256
    hidden: int = 512
    use_solver_preds: bool = True             # use_loftr_preds equivalent
    dtype: str = "bfloat16"


class PreActBlock(nn.Module):
    """Pre-activation block (reference preact.py:13-37); the 1x1 shortcut,
    where there is one, takes relu(bn1(x))."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.shortcut = None
        if stride != 1 or cin != planes:
            self.shortcut = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(bn(x, self.bn1))
        short = x if self.shortcut is None else conv(out, self.shortcut[0])
        out = conv(out, self.conv1)
        out = conv(F.relu(bn(out, self.bn2)), self.conv2)
        return out + short


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 4 (reference preact.py:40-70)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        exp = 4 * planes
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, exp, 1, bias=False)
        self.shortcut = None
        if stride != 1 or cin != exp:
            self.shortcut = nn.Sequential(nn.Conv2d(cin, exp, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(bn(x, self.bn1))
        short = x if self.shortcut is None else conv(out, self.shortcut[0])
        out = conv(out, self.conv1)
        out = conv(F.relu(bn(out, self.bn2)), self.conv2)
        out = conv(F.relu(bn(out, self.bn3)), self.conv3)
        return out + short


class ConvBNElu(nn.Module):
    """Convolution with bias, BatchNorm, ELU (reference resunet.py ``conv``)."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, 1, (kernel - 1) // 2)
        self.normalize = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(bn(conv(x, self.conv), self.normalize))


class UpConv(nn.Module):
    """x2 bilinear (align_corners) upsample, then ``ConvBNElu`` 3x3."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvBNElu(cin, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(_up2(x))


def skip_connect(up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Zero-pad ``skip`` to ``up``'s size (odd inputs make them differ by
    one; split dh // 2, dh - dh // 2) and concatenate [up, skip]."""
    dh = up.shape[2] - skip.shape[2]
    dw = up.shape[3] - skip.shape[3]
    skip = F.pad(skip, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([up, skip], dim=1)


class ResUNet(nn.Module):
    """H/2 stem and max-pool, pre-activation stages at H/4, H/8, H/16, a
    decoder back to H/4 (reference resunet.py:41-128)."""

    def __init__(self, cfg: SixDRegConfig):
        super().__init__()
        self.cfg = cfg
        block = PreActBottleneck if cfg.encoder_bottleneck else PreActBlock
        exp = block.expansion
        self.firstconv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.firstbn = nn.BatchNorm2d(64)
        cin = 64
        for name, planes, stride, n in zip(("encoder1", "encoder2", "encoder3"),
                                           (64, 128, 256), (1, 2, 2), cfg.encoder_blocks):
            blocks = []
            for i in range(n):
                blocks.append(block(cin, planes, stride if i == 0 else 1))
                cin = planes * exp
            setattr(self, name, nn.Sequential(*blocks))
        cat = not cfg.not_concat
        self.upconv4 = UpConv(256 * exp, 512)
        self.iconv4 = ConvBNElu(512 + cat * 128 * exp, 512, 3)
        self.upconv3 = UpConv(512, 256)
        self.iconv3 = ConvBNElu(256 + cat * 64 * exp, 256, 3)
        self.outconv = ConvBNElu(256, cfg.encoder_out_layers, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W) -> (B, encoder_out_layers, ~H/4, ~W/4)."""
        x1 = F.max_pool2d(F.relu(bn(conv(x, self.firstconv), self.firstbn)), 3, 2, 1)
        x2 = self.encoder1(x1)
        x3 = self.encoder2(x2)
        x4 = self.encoder3(x3)
        y = self.upconv4(x4)
        if not self.cfg.not_concat:
            y = skip_connect(y, x3)
        y = self.upconv3(self.iconv4(y))
        if not self.cfg.not_concat:
            y = skip_connect(y, x2)
        return self.outconv(self.iconv3(y))


def _grid(H: int, W: int, device) -> torch.Tensor:
    """(H W, 2) positions on a [-1, 1] grid, ``ij`` order."""
    uu, vv = torch.meshgrid(torch.linspace(-1.0, 1.0, H, device=device),
                            torch.linspace(-1.0, 1.0, W, device=device), indexing="ij")
    return torch.stack([uu, vv], -1).reshape(H * W, 2)


def _warp_parts(cfg: SixDRegConfig, f0, f1, sim, H: int, W: int) -> list:
    """[f0, the warped f1, the expected match position, the max score]
    from the (B, N, M) similarities, as the flags ask."""
    cvol = torch.softmax(sim, dim=2)                    # over image 1's positions
    parts = [f0, cvol @ f1]
    if cfg.position_encoder:
        grid = _grid(H, W, f0.device)
        parts.append(cvol @ grid)
    if cfg.max_score_channel:
        parts.append(cvol.amax(dim=2, keepdim=True))
    return parts


def _to_map(parts: list, like: torch.Tensor) -> torch.Tensor:
    B, _, H, W = like.shape
    return torch.cat(parts, dim=-1).to(like.dtype).transpose(1, 2).reshape(B, -1, H, W)


class CorrelationVolumeWarping(nn.Module):
    """Global correlation volume softmax(f0 f1^T) over image 1's positions,
    the warped f1, the expected match position ([-1, 1] grid, ``ij``) and
    the max score, concatenated to f0 (reference aggregator.py:6-116).
    Flags: ``normalise_dot`` L2-normalises f0 and f1 first (both then go
    into the output); ``cv_half_channels`` correlates only their first D/2
    channels; ``position_encoder_im1`` appends the grid itself. No
    parameters; float32 products."""

    def __init__(self, cfg: SixDRegConfig):
        super().__init__()
        self.cfg = cfg

    @staticmethod
    def channels(cfg: SixDRegConfig) -> int:
        """Output channels for the config's encoder width and flags."""
        pos = 2 * cfg.position_encoder
        return (2 * cfg.encoder_out_layers + pos + pos * cfg.position_encoder_im1
                + cfg.max_score_channel)

    def forward(self, vol0: torch.Tensor, vol1: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, D, H, W = vol0.shape
        f0 = vol0.flatten(2).transpose(1, 2).float()       # (B, N, D)
        f1 = vol1.flatten(2).transpose(1, 2).float()
        if cfg.normalise_dot:
            f0 = f0 / (torch.linalg.norm(f0, dim=-1, keepdim=True) + 1e-8)
            f1 = f1 / (torch.linalg.norm(f1, dim=-1, keepdim=True) + 1e-8)
        d = D // 2 if cfg.cv_half_channels else D
        parts = _warp_parts(cfg, f0, f1, f0[..., :d] @ f1[..., :d].transpose(1, 2), H, W)
        if cfg.position_encoder and cfg.position_encoder_im1:
            parts.insert(3, _grid(H, W, vol0.device).expand(B, -1, -1))
        return _to_map(parts, vol0)


class CorrelationVolumeWarpingQKV(nn.Module):
    """Learned-projection variant (reference aggregator.py:119-199): the
    similarity of q = q_proj(f0) and k = k_proj(f1) (plus f0, f1 with
    ``residual``) scaled by 1/sqrt(D), V = f1; the output channels as
    ``CorrelationVolumeWarping``'s without the image-1 grid, which this
    variant never appends. The projections run in the volume's dtype."""

    def __init__(self, cfg: SixDRegConfig, residual: bool = False):
        super().__init__()
        self.cfg = cfg
        self.residual = residual
        D = cfg.encoder_out_layers
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)

    def forward(self, vol0: torch.Tensor, vol1: torch.Tensor) -> torch.Tensor:
        B, D, H, W = vol0.shape
        f0 = vol0.flatten(2).transpose(1, 2)
        f1 = vol1.flatten(2).transpose(1, 2)
        q, k = lin(self.q_proj, f0), lin(self.k_proj, f1)
        if self.residual:
            q, k = q + f0, k + f1
        sim = (q.float() @ k.float().transpose(1, 2)) / D ** 0.5
        return _to_map(_warp_parts(self.cfg, f0.float(), f1.float(), sim, H, W), vol0)


class ConcatAggregator(nn.Module):
    """No-warping ablation: the two volumes concatenated over channels
    (reference aggregator 'Concat' option, 3d3d_no_warping.yaml)."""

    def __init__(self, cfg: SixDRegConfig):
        super().__init__()

    def forward(self, vol0: torch.Tensor, vol1: torch.Tensor) -> torch.Tensor:
        return torch.cat([vol0, vol1], dim=1)


HEAD_WIDTH = 256  # channels out of the head's resblock3


def _trunk(module: nn.Module, cin: int, n: int) -> None:
    """``resblock1``-``resblock{n}``: stride-2 PreActBlocks 64-128-256-512."""
    for i, planes in enumerate((64, 128, HEAD_WIDTH, 512)[:n]):
        setattr(module, f"resblock{i + 1}", PreActBlock(cin, planes, 2))
        cin = planes


def _pooled(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The four-block trunk, then the spatial mean (AVG_POOL): (B, 512)."""
    for i in range(1, 5):
        x = getattr(module, f"resblock{i}")(x)
    return x.mean(dim=(2, 3))


class DeepResBlockHead(nn.Module):
    """The reference DeepResBlock (head.py:27-55, DirectDeepResBlockMLP
    248-281): resblock1-3, stride-2 PreActBlocks 64-128-256, whose features
    ``forward`` returns; with ``full_forward_pass`` also resblock4 (512),
    the spatial mean and ``mlp`` (256, 128, 9), and ``forward`` returns
    (pose (B, 9) float32 as (t, 6D rotation), features)."""

    def __init__(self, cin: int, full_forward_pass: bool = False):
        super().__init__()
        self.full_forward_pass = full_forward_pass
        _trunk(self, cin, 4 if full_forward_pass else 3)
        if full_forward_pass:
            self.mlp = _seq(512, 256, 128, 9)

    def forward(self, x: torch.Tensor):
        x3 = self.resblock3(self.resblock2(self.resblock1(x)))
        if not self.full_forward_pass:
            return x3
        out = run_seq(self.mlp, self.resblock4(x3).mean(dim=(2, 3))).float()
        return torch.cat([out[..., 6:], out[..., :6]], -1), x3   # reference order (6D, t)


class ProcrustesHead(nn.Module):
    """3D-3D correspondence head (reference head.py ProcrustesDeepResBlock):
    the four-block trunk and its mean, ``mlp`` (256, 3 num_pts) predicting
    num_pts anchors, half for each camera (with 3, the basis e1-e3 for
    camera 0), the basis added where ``add_basis`` and num_pts is 3 or 6;
    (R, t) from the weighted Procrustes solve, differentiable through the
    SVD."""

    def __init__(self, cin: int, num_pts: int = 6, add_basis: bool = True):
        super().__init__()
        self.num_pts = num_pts
        self.add_basis = add_basis
        _trunk(self, cin, 4)
        self.mlp = _seq(512, 256, 3 * num_pts)

    def forward(self, x: torch.Tensor):
        xyz = run_seq(self.mlp, _pooled(self, x)).float().reshape(x.shape[0], -1, 3)
        basis = torch.eye(3, device=x.device).expand(x.shape[0], 3, 3)
        if self.num_pts == 3:
            cor0, cor1 = basis, xyz
        else:
            half = self.num_pts // 2
            cor0, cor1 = xyz[:, :half], xyz[:, half:]
        if self.add_basis and self.num_pts in (3, 6):
            if self.num_pts == 6:
                cor0 = cor0 + basis
            cor1 = cor1 + basis
        return procrustes(cor0, cor1)


def _euler_zyx(ax: torch.Tensor, ay: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """Rz(az) Ry(ay) Rx(ax) from angles in degrees, (B, 3, 3)."""
    a, b, c = (torch.deg2rad(v) for v in (ax, ay, az))
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    Rx = torch.stack([one, zero, zero, zero, a.cos(), -a.sin(), zero, a.sin(), a.cos()], -1)
    Ry = torch.stack([b.cos(), zero, b.sin(), zero, one, zero, -b.sin(), zero, b.cos()], -1)
    Rz = torch.stack([c.cos(), -c.sin(), zero, c.sin(), c.cos(), zero, zero, zero, one], -1)
    return Rz.reshape(-1, 3, 3) @ Ry.reshape(-1, 3, 3) @ Rx.reshape(-1, 3, 3)


class AngularBinsHead(nn.Module):
    """Classification head (reference head.py:284-338): the four-block trunk
    and its mean, ``mlp`` to 900 rotation bins (x 360, y 180, z 360, one
    degree each) and, with ``separate_scale``, 360 azimuth and 180
    elevation bins and a scale (541), else a raw t (3). R = Rz Ry Rx of
    the argmax bins; t = |scale| times the spherical direction. Returns
    (R, t, the rotation logits (B, 900))."""

    def __init__(self, cin: int, separate_scale: bool = True):
        super().__init__()
        self.separate_scale = separate_scale
        _trunk(self, cin, 4)
        self.mlp = nn.Linear(512, 900 + (541 if separate_scale else 3))

    def forward(self, x: torch.Tensor):
        out = lin(self.mlp, _pooled(self, x)).float()
        bins = lambda lo, hi: out[:, lo:hi].argmax(-1).float()
        R = _euler_zyx(bins(0, 360) - 180.0, bins(360, 540) - 90.0, bins(540, 900) - 180.0)
        if self.separate_scale:
            phi, theta = torch.deg2rad(bins(900, 1260)), torch.deg2rad(bins(1260, 1440))
            t = out[:, -1].abs()[:, None] * torch.stack(
                [phi.cos() * theta.sin(), phi.sin() * theta.sin(), theta.cos()], -1)
        else:
            t = out[:, 900:903]
        return R, t, out[:, :900]


class QuaternionHead(nn.Module):
    """Quaternion head (reference head.py QuatDeepResBlock): the four-block
    trunk and its mean, ``mlp`` to a wxyz quaternion and, with
    ``separate_scale``, a direction and a scale (8), else a raw t (7).
    Returns (R, t, the unit quaternion)."""

    def __init__(self, cin: int, separate_scale: bool = True):
        super().__init__()
        self.separate_scale = separate_scale
        _trunk(self, cin, 4)
        self.mlp = nn.Linear(512, 4 + (4 if separate_scale else 3))

    def forward(self, x: torch.Tensor):
        out = lin(self.mlp, _pooled(self, x)).float()
        q = out[:, :4] / (torch.linalg.norm(out[:, :4], dim=-1, keepdim=True) + 1e-8)
        if self.separate_scale:
            d = out[:, 4:7]
            t = out[:, 7:8].abs() * d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-8)
        else:
            t = out[:, 4:7]
        return quaternion_to_matrix(q), t, q


class _SelfAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with ``nn.TransformerEncoderLayer``'s names and
    defaults (ReLU FFN of ``dim_ff``, LayerNorm eps 1e-5), computed in
    plain torch with a float32 softmax."""

    def __init__(self, d_model: int, nhead: int, dim_ff: int = 2048):
        super().__init__()
        self.nhead = nhead
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        sa = self.self_attn
        qkv = F.linear(x, sa.in_proj_weight.to(x.dtype), sa.in_proj_bias.to(x.dtype))
        q, k, v = qkv.reshape(B, N, 3, self.nhead, -1).unbind(2)
        o = lin(sa.out_proj, full_attention(q, k, v).reshape(B, N, C))
        x = ln(self.norm1, x + o)
        y = lin(self.linear2, torch.relu(lin(self.linear1, x)))
        return ln(self.norm2, x + y)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [TorchTransformerEncoderLayer(d_model, nhead) for _ in range(n_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def head_tokens(image_hw: Tuple[int, int]) -> int:
    """Tokens after the head: the encoder's H/4 map (the decoder pads to
    twice its H/8 stage) through three stride-2 blocks."""
    def side(n):
        n = (n + 1) // 2            # firstconv 7x7/2
        n = (n + 1) // 2            # max-pool 3/2
        n = 4 * ((n + 3) // 4)      # encoder2, encoder3, then x2 x2
        for _ in range(3):
            n = (n + 1) // 2
        return n
    return side(image_hw[0]) * side(image_hw[1])


class MapfreeRegression(nn.Module):
    """A regressor-resolution pair and the solver's summary -> (R (B, 3, 3),
    t (B, 3), the 9D pose (t, 6D rows) (B, 9), gate (B, 2) or None). The
    solver t is rescaled toward the regressed norm (ratio clamped to
    [1e-2, 1e2]) before the MoE blend, and the three inlier counts enter
    divided by 500 (reference model.py:198-232)."""

    # the ResUNet decoder's convolution biases, each feeding a train-mode
    # BatchNorm (see ViTEss.BIAS_BEFORE_BN)
    BIAS_BEFORE_BN = ("encoder.upconv4.conv1.conv.bias", "encoder.iconv4.conv.bias",
                      "encoder.upconv3.conv1.conv.bias", "encoder.iconv3.conv.bias",
                      "encoder.outconv.conv.bias")

    def __init__(self, cfg: Optional[SixDRegConfig] = None):
        super().__init__()
        cfg = cfg or SixDRegConfig()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        self.encoder = ResUNet(cfg)
        self.aggregator = CorrelationVolumeWarping(cfg)
        self.head = DeepResBlockHead(CorrelationVolumeWarping.channels(cfg))
        # the transformer and the MLPs take the head's width, whatever d_im
        # says, as the JAX package's layers do
        if cfg.use_vanilla_transformer:
            self.transformer = TransformerEncoder(HEAD_WIDTH, cfg.transformer_heads,
                                                  cfg.transformer_layers)
        feat = HEAD_WIDTH * head_tokens(cfg.image_hw)
        self.pose_regressor = _seq(feat, cfg.hidden, cfg.hidden, 9)
        if cfg.use_solver_preds:
            self.moe_predictor = _seq(feat + 9 + 9 + 3, cfg.hidden, cfg.hidden, 2)

    def encode(self, image0: torch.Tensor, image1: torch.Tensor):
        """(B, H, W, 3) images in [0, 1] -> the ResUNet's maps of both,
        (B, encoder_out_layers, ~H/4, ~W/4) each."""
        nchw = lambda im: im.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        return self.encoder(nchw(image0)), self.encoder(nchw(image1))

    def volume(self, vol0: torch.Tensor, vol1: torch.Tensor) -> torch.Tensor:
        """The aggregator and the head: (B, HEAD_WIDTH, Hf, Wf)."""
        return self.head(self.aggregator(vol0, vol1))

    def tokens(self, feats: torch.Tensor) -> torch.Tensor:
        """The head's map through the transformer -> (B, C L) features,
        flattened channel-major."""
        B = feats.shape[0]
        tokens = feats.flatten(2).transpose(1, 2)           # (B, L, C)
        if self.config.use_vanilla_transformer:
            tokens = self.transformer(tokens)
        return tokens.transpose(1, 2).reshape(B, -1).float()

    def features(self, image0: torch.Tensor, image1: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] -> (B, C L) features, flattened
        channel-major. Independent of the solver."""
        return self.tokens(self.volume(*self.encode(image0, image1)))

    def regress(self, features: torch.Tensor) -> torch.Tensor:
        """The pose MLP: the regressed (t, 6D) pose (B, 9), float32."""
        return run_seq(self.pose_regressor, features.to(self.dtype)).float()

    def blend(self, features: torch.Tensor, pred_9d: torch.Tensor,
              solver_rt: Optional[torch.Tensor] = None,
              solver_inliers: Optional[torch.Tensor] = None):
        """The MoE blend of the regressed pose with the solver pose."""
        gate = None
        if self.config.use_solver_preds:
            if solver_rt is None or solver_inliers is None:
                raise ValueError("use_solver_preds needs the solver pose and counts")
            sp_t = solver_rt[..., :3, 3].float()
            sp_r = matrix_to_rotation_6d(solver_rt[..., :3, :3].float())
            counts = solver_inliers.float() / 500.0
            ratio = torch.linalg.norm(pred_9d[..., :3], dim=-1) / torch.linalg.norm(
                sp_t, dim=-1).clamp(1e-2, 1e2)
            sp_t = sp_t * ratio.clamp(1e-2, 1e2)[..., None]
            gin = torch.cat([features, pred_9d, sp_t, sp_r, counts], -1)
            gate = torch.sigmoid(run_seq(self.moe_predictor, gin.to(self.dtype))).float()
            pred_9d = torch.cat([
                gate[..., :1] * pred_9d[..., :3] + (1 - gate[..., :1]) * sp_t,
                gate[..., 1:] * pred_9d[..., 3:] + (1 - gate[..., 1:]) * sp_r], -1)
        return rotation_6d_to_matrix(pred_9d[..., 3:]), pred_9d[..., :3], pred_9d, gate

    def fuse(self, features: torch.Tensor, solver_rt: Optional[torch.Tensor] = None,
             solver_inliers: Optional[torch.Tensor] = None):
        """The pose MLP and the MoE blend with the solver pose."""
        return self.blend(features, self.regress(features), solver_rt, solver_inliers)

    def forward(self, image0: torch.Tensor, image1: torch.Tensor,
                solver_rt: Optional[torch.Tensor] = None,
                solver_inliers: Optional[torch.Tensor] = None):
        return self.fuse(self.features(image0, image1), solver_rt, solver_inliers)


class FeatureMatchingModel:
    """Classical baseline: matcher -> solver -> (R, t, inlier count).

    ``matcher.match(img0, img1)`` gives padded (K, 2) points of both
    images and a (K,) mask (``feature_matching.PrecomputedMatching`` takes
    the pair's names). ``solver``: ``essential`` (the 8-point RANSAC at
    ``pixel_thr``, inlier scoring, unit t), ``essential_metric`` (the same, t
    scaled by ``metric_scale_ransac`` over both depth maps) or ``pnp``
    (``pnp_ransac`` with image 0's depth, metric t). Runs on CUDA unless
    given ``device="cpu"``; ``uniforms`` are the solver's draws (B=1),
    else they come from ``generator``."""

    def __init__(self, matcher, solver: str = "essential", pixel_thr: float = 2.0,
                 scale_threshold: float = 0.1, device=None):
        from far_tpu_torch.pipeline import resolve_device

        if solver not in ("essential", "essential_metric", "pnp"):
            raise ValueError(f"solver {solver!r}, not 'essential', 'essential_metric' "
                             "or 'pnp'")
        self.matcher = matcher
        self.solver = solver
        self.pixel_thr = pixel_thr
        self.scale_threshold = scale_threshold
        self.device = resolve_device(device)

    @torch.no_grad()
    def estimate(self, img0, img1, K0, K1, depth0=None, depth1=None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None):
        """(R (3, 3), t (3,), inlier count) of one pair; K and depth maps as
        numpy arrays or tensors, unbatched."""
        def one(a, dt=torch.float32):
            return torch.as_tensor(a, dtype=dt, device=self.device)[None]

        p0, p1, valid = self.matcher.match(img0, img1)
        p0, p1, valid, K0, K1 = one(p0), one(p1), one(valid, torch.bool), one(K0), one(K1)
        if self.solver == "pnp":
            R, t, n_inl, _ = pnp_ransac(p0, p1, one(depth0), K0, K1, valid,
                                        uniforms=uniforms, generator=generator)
            return R[0], t[0], float(n_inl[0])
        est = estimate_pose(p0, p1, K0, K1, valid,
                            cfg=SolverConfig(solver="ransac", pixel_thr=self.pixel_thr),
                            uniforms=uniforms, generator=generator)
        t = est.t
        if self.solver == "essential_metric" and depth0 is not None:
            t, _, _ = metric_scale_ransac(est.R, est.t, p0, p1, one(depth0), one(depth1),
                                          K0, K1, est.inliers, self.scale_threshold)
        return est.R[0], t[0], float(est.num_inliers[0])
