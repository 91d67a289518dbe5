"""Plain float32 reference of the map-free 6DReg regressor and its fusion.

Written from the regressor's published equations (crockwell/far
``mapfree_6dreg``, ``lib/models/regression``) in plain torch, under the
configuration the map-free FAR request runs:

- ``encoder/resunet.py`` with ``preact.py``: a 7x7 stride-2 stem,
  BatchNorm, ReLU and a 3x3 stride-2 max-pool; three stages of
  pre-activation bottlenecks (expansion 4; planes 64, 128, 256; strides 1,
  2, 2); a decoder of x2 bilinear (aligned corners) upsamples, each a 3x3
  convolution with BatchNorm and ELU, concatenated with the zero-padded
  skip maps, to a 1x1 convolution of ``out`` channels at a quarter of the
  input's side;
- ``CorrelationVolumeWarping`` with its default flags: softmax over image
  1's positions of f0 f1^T, then f0, the warped f1, the expected match
  position on a [-1, 1] grid (ij order) and the max score;
- ``DeepResBlock``: three stride-2 pre-activation blocks, 64-128-256;
- the vanilla ``TransformerEncoder``: post-LN layers, 8-head softmax
  attention, a ReLU MLP of 2048, LayerNorm epsilon 1e-5;
- ``regression_mlp`` (``model.py:198-233``): the tokens flattened
  channel-major, a pose MLP to (t, 6D rotation rows), and with the solver's
  pose the MoE gate: the solver t rescaled toward the regressed norm (the
  ratio and the solver norm clamped to [1e-2, 1e2]), the counts over 500,
  and each half of the pose blended by its gate.

BatchNorm runs in eval mode. Parameters are named as the program's
``MapfreeRegression``, so one state dict loads into both. Nothing here
imports the program. Every product's operands go through ``quant`` (the
identity; ``far.fp8`` for the control).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.far import Quant, _bn, _conv, _ln, _run_seq, _seq, identity
from h100bench.reference.solver.rotations import (
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)

HEAD = (64, 128, 256)  # DeepResBlock's widths


@dataclass(frozen=True)
class RegShapes:
    """The configuration's sizes that the reference needs."""
    image_hw: Tuple[int, int] = (368, 272)
    blocks: Tuple[int, int, int] = (3, 3, 3)
    out: int = 32
    layers: int = 6
    heads: int = 8
    hidden: int = 512

    @property
    def tokens(self) -> int:
        """Tokens after the head: the encoder's quarter-side map (the
        decoder doubles its eighth-side stage) through three stride-2
        blocks."""
        def side(n):
            n = -(-n // 2)                  # stem, stride 2
            n = -(-n // 2)                  # max-pool, stride 2
            n = 4 * -(-n // 4)              # two stride-2 stages, then two x2 upsamples
            for _ in range(3):
                n = -(-n // 2)
            return n
        return side(self.image_hw[0]) * side(self.image_hw[1])


def shapes_from_config(reg: dict) -> RegShapes:
    """The ``regressor`` block of a configuration file as ``RegShapes``."""
    d = RegShapes()
    return RegShapes(image_hw=tuple(reg.get("image_hw", d.image_hw)),
                     blocks=tuple(reg.get("encoder_blocks", d.blocks)),
                     out=reg.get("encoder_out_layers", d.out),
                     layers=reg.get("transformer_layers", d.layers),
                     heads=reg.get("transformer_heads", d.heads),
                     hidden=reg.get("hidden", d.hidden))


# ---- the encoder ----------------------------------------------------------------

class Bottleneck(nn.Module):
    """out = conv3(relu(bn3(conv2(relu(bn2(conv1(a))))))) + shortcut, with
    a = relu(bn1(x)); the shortcut is x, or a 1x1 convolution of a where
    the width or the stride changes."""

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.shortcut = None
        if stride != 1 or cin != 4 * planes:
            self.shortcut = nn.Sequential(nn.Conv2d(cin, 4 * planes, 1, stride, bias=False))

    def run(self, x, q):
        a = F.relu(_bn(x, self.bn1))
        short = x if self.shortcut is None else _conv(a, self.shortcut[0], q)
        y = _conv(a, self.conv1, q)
        y = _conv(F.relu(_bn(y, self.bn2)), self.conv2, q)
        y = _conv(F.relu(_bn(y, self.bn3)), self.conv3, q)
        return y + short


class Block(nn.Module):
    """The head's pre-activation block: out = conv2(relu(bn2(conv1(a)))) +
    conv1x1(a), a = relu(bn1(x)), stride 2."""

    def __init__(self, cin, planes):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, planes, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.shortcut = nn.Sequential(nn.Conv2d(cin, planes, 1, 2, bias=False))

    def run(self, x, q):
        a = F.relu(_bn(x, self.bn1))
        y = _conv(F.relu(_bn(_conv(a, self.conv1, q), self.bn2)), self.conv2, q)
        return y + _conv(a, self.shortcut[0], q)


class ConvBNElu(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, (k - 1) // 2)
        self.normalize = nn.BatchNorm2d(cout)

    def run(self, x, q):
        return F.elu(_bn(_conv(x, self.conv, q), self.normalize))


class UpConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvBNElu(cin, cout, 3)

    def run(self, x, q):
        up = F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)
        return self.conv1.run(up, q)


def _skip(up, skip):
    """[up, skip zero-padded to up's size, the odd row or column after]."""
    dh, dw = up.shape[2] - skip.shape[2], up.shape[3] - skip.shape[3]
    return torch.cat([up, F.pad(skip, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))], 1)


class Encoder(nn.Module):
    def __init__(self, s: RegShapes):
        super().__init__()
        self.firstconv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.firstbn = nn.BatchNorm2d(64)
        cin = 64
        for name, planes, stride, n in zip(("encoder1", "encoder2", "encoder3"),
                                           (64, 128, 256), (1, 2, 2), s.blocks):
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(cin, planes, stride if i == 0 else 1))
                cin = 4 * planes
            setattr(self, name, nn.Sequential(*blocks))
        self.upconv4 = UpConv(1024, 512)
        self.iconv4 = ConvBNElu(512 + 512, 512, 3)
        self.upconv3 = UpConv(512, 256)
        self.iconv3 = ConvBNElu(256 + 256, 256, 3)
        self.outconv = ConvBNElu(256, s.out, 1)

    def run(self, x, q):
        def stage(seq, t):
            for blk in seq:
                t = blk.run(t, q)
            return t

        x1 = F.max_pool2d(F.relu(_bn(_conv(x, self.firstconv, q), self.firstbn)), 3, 2, 1)
        x2 = stage(self.encoder1, x1)
        x3 = stage(self.encoder2, x2)
        x4 = stage(self.encoder3, x3)
        y = self.iconv4.run(_skip(self.upconv4.run(x4, q), x3), q)
        y = self.iconv3.run(_skip(self.upconv3.run(y, q), x2), q)
        return self.outconv.run(y, q)


# ---- the transformer ------------------------------------------------------------

class SelfAttn(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * C, C))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * C))
        self.out_proj = nn.Linear(C, C)


class Layer(nn.Module):
    def __init__(self, C, heads):
        super().__init__()
        self.heads = heads
        self.self_attn = SelfAttn(C)
        self.linear1 = nn.Linear(C, 2048)
        self.linear2 = nn.Linear(2048, C)
        self.norm1 = nn.LayerNorm(C, eps=1e-5)
        self.norm2 = nn.LayerNorm(C, eps=1e-5)

    def run(self, x, q):
        B, L, C = x.shape
        H = self.heads
        a = self.self_attn
        qkv = F.linear(q(x), q(a.in_proj_weight), a.in_proj_bias)
        qq, kk, vv = (t.reshape(B, L, H, C // H).transpose(1, 2) for t in qkv.split(C, -1))
        A = torch.softmax(q(qq) @ q(kk).transpose(-1, -2) / (C // H) ** 0.5, -1)
        o = (q(A) @ q(vv)).transpose(1, 2).reshape(B, L, C)
        x = _ln(x + F.linear(q(o), q(a.out_proj.weight), a.out_proj.bias), self.norm1)
        y = F.relu(F.linear(q(x), q(self.linear1.weight), self.linear1.bias))
        return _ln(x + F.linear(q(y), q(self.linear2.weight), self.linear2.bias), self.norm2)


class Transformer(nn.Module):
    def __init__(self, C, heads, n):
        super().__init__()
        self.layers = nn.ModuleList([Layer(C, heads) for _ in range(n)])


class Head(nn.Module):
    def __init__(self, cin):
        super().__init__()
        for i, planes in enumerate(HEAD):
            setattr(self, f"resblock{i + 1}", Block(cin, planes))
            cin = planes


# ---- the model ------------------------------------------------------------------

class SixDRegReference(nn.Module):
    """The regressor: ``features`` (images -> channel-major tokens),
    ``regress`` (the pose MLP: the regressed 9D pose, (t, 6D rows)) and
    ``blend`` (the MoE with the solver's pose and counts)."""

    def __init__(self, s: RegShapes):
        super().__init__()
        self.s = s
        self.encoder = Encoder(s)
        self.head = Head(2 * s.out + 3)
        self.transformer = Transformer(HEAD[-1], s.heads, s.layers)
        feat = HEAD[-1] * s.tokens
        self.pose_regressor = _seq(feat, s.hidden, s.hidden, 9)
        self.moe_predictor = _seq(feat + 9 + 9 + 3, s.hidden, s.hidden, 2)

    def volume(self, v0, v1, q: Quant = identity):
        """The correlation volume, softmax over image 1's positions, and
        what it warps: (B, 2 D + 3, H, W)."""
        B, D, H, W = v0.shape
        f0 = v0.flatten(2).transpose(1, 2)
        f1 = v1.flatten(2).transpose(1, 2)
        cv = torch.softmax(q(f0) @ q(f1).transpose(1, 2), dim=2)
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, H, device=v0.device),
                                torch.linspace(-1.0, 1.0, W, device=v0.device), indexing="ij")
        grid = torch.stack([gy, gx], -1).reshape(H * W, 2)
        out = torch.cat([f0, q(cv) @ q(f1), q(cv) @ grid, cv.amax(2, keepdim=True)], -1)
        return out.transpose(1, 2).reshape(B, -1, H, W)

    def features(self, image0, image1, q: Quant = identity):
        """(B, H, W, 3) images in [0, 1] -> (B, C L) tokens, channel-major."""
        v0 = self.encoder.run(image0.permute(0, 3, 1, 2).float(), q)
        v1 = self.encoder.run(image1.permute(0, 3, 1, 2).float(), q)
        x = self.volume(v0, v1, q)
        for i in range(len(HEAD)):
            x = getattr(self.head, f"resblock{i + 1}").run(x, q)
        B = x.shape[0]
        tok = x.flatten(2).transpose(1, 2)
        for layer in self.transformer.layers:
            tok = layer.run(tok, q)
        return tok.transpose(1, 2).reshape(B, -1)

    def regress(self, feats, q: Quant = identity):
        return _run_seq(self.pose_regressor, feats, q)

    def blend(self, feats, pred, solver_rt, counts, q: Quant = identity):
        """(R (B, 3, 3), t (B, 3), gate (B, 2)) of the MoE blend."""
        r6, t, gate = self.blend6d(feats, pred, solver_rt, counts, q)
        return rotation_6d_to_matrix(r6), t, gate

    def blend6d(self, feats, pred, solver_rt, counts, q: Quant = identity):
        """(the blended 6D rows (B, 6) before Gram-Schmidt, t, gate)."""
        sp_t = solver_rt[..., :3, 3].float()
        sp_r = matrix_to_rotation_6d(solver_rt[..., :3, :3].float())
        ratio = pred[..., :3].norm(dim=-1) / sp_t.norm(dim=-1).clamp(1e-2, 1e2)
        sp_t = sp_t * ratio.clamp(1e-2, 1e2)[..., None]
        gate = torch.sigmoid(_run_seq(self.moe_predictor, torch.cat(
            [feats, pred, sp_t, sp_r, counts.float() / 500.0], -1), q))
        t = gate[..., :1] * pred[..., :3] + (1.0 - gate[..., :1]) * sp_t
        r6 = gate[..., 1:] * pred[..., 3:] + (1.0 - gate[..., 1:]) * sp_r
        return r6, t, gate
