"""ResNet-FPN 8/2 and 16/4 feature backbones (NCHW inside).

Counterpart of ``far_tpu/models/backbone.py:ResNetFPN_8_2`` and
``ResNetFPN_16_4``, with the reference's module names (``conv1``,
``layer1.0.conv1``, ``layer2_outconv2.1``, ``layer4_outconv``, ...) so a
reference state dict loads with ``strict=True``. The stem is a plain 7x7/2 convolution: the JAX
package's space-to-depth ``_StemConv`` computes the same thing in a form
shaped for the TPU. The x2 upsample is bilinear with align_corners=True,
as ``resize_bilinear_align_corners`` is. Parameters stay float32 and are
cast to the input's dtype where they are used, as Flax does.

BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9)``: in eval it
normalises with the running statistics, in float32 whatever the input's
dtype, and rounds the result once; in training (``self.training``)
with the batch's, computed in float32 whatever the compute dtype, the
variance biased (E[x^2] - mu^2, clipped at 0) in the normalisation and in
the running update ``running = 0.9 running + 0.1 batch`` (Flax's momentum
0.9 is the module's torch momentum 0.1; another is read from the
module). That is not ``F.batch_norm(training=True)``, whose running
variance is unbiased. Under a process group of several ranks the batch is
every rank's rows: one differentiable all-reduce of [sum x, sum x^2, n]
gives the moments, their gradient reaches every rank's x, and the running
statistics move alike on every rank (the JAX package's BatchNorm over a
mesh; ``nn.SyncBatchNorm`` would never run, as every family's BatchNorm
goes through ``bn``).

Under ``deferred_running_stats(sink)`` a train-mode BatchNorm appends
(module, batch mean, batch variance) to ``sink`` instead of updating its
running statistics; ``update_running_stats(sink)`` applies them. The
remat path (``models/loftr.py``) needs that: a checkpointed backbone runs
its forward again in the backward pass, and an in-place update there
would move the statistics twice (momentum 0.81, not 0.9), where Flax's
functional ``nn.remat`` updates them once.

With no gradient to carry, the glue between two convolutions goes
through ``ops/backbone_glue.py``: an eval BatchNorm2d with its ReLU or
LeakyReLU (``bn_act``), a residual block's second half (``bn_add_act``)
and the FPN's upsample-add (``up2_add``). On the card each is one kernel
pass a convolution output, rounded at the same points as its plain
version, the unfused sequence, which the CPU runs. Training, grad mode
and GroupNorm keep ``norm`` and the separate steps.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.ops import backbone_glue
from far_tpu_torch.parallel.comm import all_reduce_sum, process_count


def conv(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, m.stride, m.padding)


_DEFERRED: contextvars.ContextVar = contextvars.ContextVar("bn_deferred", default=None)


@contextlib.contextmanager
def deferred_running_stats(sink: List):
    """Within, train-mode ``bn`` appends its (module, mean, var) to ``sink``
    and leaves the running statistics alone."""
    token = _DEFERRED.set(sink)
    try:
        yield sink
    finally:
        _DEFERRED.reset(token)


@torch.no_grad()
def update_running_stats(stats) -> None:
    """``running = (1 - m) running + m batch`` for each (module, mean, var),
    m the module's torch momentum: 0.1 (Flax's momentum 0.9) unless the
    module sets another (Flax's default 0.99 is torch's 0.01)."""
    for m, mean, var in stats:
        m.running_mean.mul_(1 - m.momentum).add_(m.momentum * mean)
        m.running_var.mul_(1 - m.momentum).add_(m.momentum * var)


def bn(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    dt = x.dtype
    if not m.training:
        # float32 statistics and affine on x of any dtype: normalised in
        # float32 and rounded once, as Flax's BatchNorm(dtype=bfloat16) does
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                            False, 0.0, m.eps)
    x32 = x.float()
    if process_count() == 1:
        mean = x32.mean(dim=(0, 2, 3))
        var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    else:
        # the moments of every rank's rows, and their gradient through the
        # other ranks' losses, as the JAX package's step over a mesh
        C = x32.shape[1]
        sums = all_reduce_sum(torch.cat([
            x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3)),
            x32.new_full((1,), x32.numel() // C)]))
        mean = sums[:C] / sums[-1]
        var = (sums[C:2 * C] / sums[-1] - mean * mean).clamp(min=0.0)
    sink = _DEFERRED.get()
    if sink is None:
        update_running_stats([(m, mean, var)])
    else:
        sink.append((m, mean.detach(), var.detach()))
    mul = torch.rsqrt(var + m.eps) * m.weight
    y = (x32 - mean[:, None, None]) * mul[:, None, None] + m.bias[:, None, None]
    return y.to(dt)


GROUPS = 8  # the JAX package's nn.GroupNorm(num_groups=8)


def gn(x: torch.Tensor, m: nn.GroupNorm) -> torch.Tensor:
    """Flax's GroupNorm on (B, C, H, W): float32 statistics and affine,
    rounded once to x's dtype."""
    B, C = x.shape[:2]
    G = m.num_groups
    x32 = x.float()
    xg = x32.reshape(B, G, -1)
    mean = xg.mean(dim=-1)
    var = ((xg * xg).mean(dim=-1) - mean * mean).clamp(min=0.0)
    mean = mean.repeat_interleave(C // G, dim=1)
    mul = torch.rsqrt(var + m.eps).repeat_interleave(C // G, dim=1) * m.weight
    y = (x32 - mean[:, :, None, None]) * mul[:, :, None, None] + m.bias[:, None, None]
    return y.to(x.dtype)


def norm(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    """The backbone's normalisation layer ``m`` (BatchNorm2d or GroupNorm)."""
    return gn(x, m) if isinstance(m, nn.GroupNorm) else bn(x, m)


def norm_layer(kind: str, channels: int) -> nn.Module:
    """``_Norm``'s switch: BatchNorm2d, or GroupNorm of 8 groups (eps 1e-6)."""
    if kind == "batch":
        return nn.BatchNorm2d(channels)
    if kind != "group":
        raise ValueError(f"unknown norm {kind!r}")
    if channels % GROUPS:
        raise ValueError(f"Number of groups ({GROUPS}) does not divide the number "
                         f"of channels ({channels}).")
    return nn.GroupNorm(GROUPS, channels, eps=1e-6)


def _fused(*mods: Optional[nn.Module]) -> bool:
    """Whether the glue goes through ``ops/backbone_glue.py`` (one kernel
    pass on the card, its plain version on the CPU): no gradient to carry,
    and each of ``mods`` (None: absent) an eval BatchNorm2d."""
    return not torch.is_grad_enabled() and all(
        m is None or (isinstance(m, nn.BatchNorm2d) and not m.training) for m in mods)


def _norm_act(y: torch.Tensor, m: nn.Module, slope: float = 0.0) -> torch.Tensor:
    """act(norm(y)): ReLU for ``slope`` 0, else LeakyReLU(slope)."""
    if _fused(m):
        return backbone_glue.bn_act(y, m, slope)
    y = norm(y, m)
    return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def _conv1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, 0, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, norm_kind: str = "batch"):
        super().__init__()
        self.conv1 = _conv3(cin, planes, stride)
        self.conv2 = _conv3(planes, planes)
        self.bn1 = norm_layer(norm_kind, planes)
        self.bn2 = norm_layer(norm_kind, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(_conv1(cin, planes, stride),
                                            norm_layer(norm_kind, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv(_norm_act(conv(x, self.conv1), self.bn1), self.conv2)
        ds = self.downsample
        r, bn_r = (x, None) if ds is None else (conv(x, ds[0]), ds[1])
        if _fused(self.bn2, bn_r):
            return backbone_glue.bn_add_act(y, self.bn2, r, bn_r)
        y = norm(y, self.bn2)
        if bn_r is not None:
            r = norm(r, bn_r)
        return F.relu(r + y)


def _stage(cin: int, planes: int, stride: int, norm_kind: str) -> nn.Sequential:
    return nn.Sequential(BasicBlock(cin, planes, stride, norm_kind),
                         BasicBlock(planes, planes, 1, norm_kind))


def _outconv2(mid: int, out: int, norm_kind: str) -> nn.Sequential:
    return nn.Sequential(_conv3(mid, mid), norm_layer(norm_kind, mid),
                         nn.LeakyReLU(0.01), _conv3(mid, out))


def _refine(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    return conv(_norm_act(conv(x, seq[0]), seq[1], 0.01), seq[3])


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


def _up2_add(a: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """a + _up2(small)."""
    if _fused():
        return backbone_glue.up2_add(a, small)
    return a + _up2(small)


class ResNetFPN_8_2(nn.Module):
    """Coarse 1/8 (block_dims[2] channels) + fine 1/2 (block_dims[0])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256), norm_kind: str = "batch"):
        super().__init__()
        d0, d1, d2 = block_dims[:3]
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, 3, bias=False)
        self.bn1 = norm_layer(norm_kind, initial_dim)
        self.layer1 = _stage(initial_dim, d0, 1, norm_kind)
        self.layer2 = _stage(d0, d1, 2, norm_kind)
        self.layer3 = _stage(d1, d2, 2, norm_kind)
        self.layer3_outconv = _conv1(d2, d2)
        self.layer2_outconv = _conv1(d1, d2)
        self.layer2_outconv2 = _outconv2(d2, d1, norm_kind)
        self.layer1_outconv = _conv1(d0, d1)
        self.layer1_outconv2 = _outconv2(d1, d0, norm_kind)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 1, H, W) -> coarse (B, d2, H/8, W/8), fine (B, d0, H/2, W/2)."""
        x0 = _norm_act(conv(x, self.conv1), self.bn1)
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = conv(x3, self.layer3_outconv)
        x2_out = _refine(_up2_add(conv(x2, self.layer2_outconv), x3_out),
                         self.layer2_outconv2)
        x1_out = _refine(_up2_add(conv(x1, self.layer1_outconv), x2_out),
                         self.layer1_outconv2)
        return x3_out, x1_out


class ResNetFPN_16_4(nn.Module):
    """Coarse 1/16 (block_dims[3] channels) + fine 1/4 (block_dims[1]):
    four stages at 1/2, 1/4, 1/8 and 1/16, the FPN from 1/16 down to 1/4
    (reference resnet_fpn.py:122-200)."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256, 512), norm_kind: str = "batch"):
        super().__init__()
        d0, d1, d2, d3 = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, 3, bias=False)
        self.bn1 = norm_layer(norm_kind, initial_dim)
        self.layer1 = _stage(initial_dim, d0, 1, norm_kind)
        self.layer2 = _stage(d0, d1, 2, norm_kind)
        self.layer3 = _stage(d1, d2, 2, norm_kind)
        self.layer4 = _stage(d2, d3, 2, norm_kind)
        self.layer4_outconv = _conv1(d3, d3)
        self.layer3_outconv = _conv1(d2, d3)
        self.layer3_outconv2 = _outconv2(d3, d2, norm_kind)
        self.layer2_outconv = _conv1(d1, d2)
        self.layer2_outconv2 = _outconv2(d2, d1, norm_kind)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 1, H, W) -> coarse (B, d3, H/16, W/16), fine (B, d1, H/4, W/4)."""
        x0 = _norm_act(conv(x, self.conv1), self.bn1)
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        x4_out = conv(x4, self.layer4_outconv)
        x3_out = _refine(_up2_add(conv(x3, self.layer3_outconv), x4_out),
                         self.layer3_outconv2)
        x2_out = _refine(_up2_add(conv(x2, self.layer2_outconv), x3_out),
                         self.layer2_outconv2)
        return x4_out, x2_out


def build_backbone(bcfg) -> nn.Module:
    """The backbone a ``BackboneConfig`` names: 8/2 or 16/4 by its coarse
    stride, as ``far_tpu/models/loftr.py`` picks it."""
    cls = ResNetFPN_8_2 if bcfg.resolution[0] == 8 else ResNetFPN_16_4
    return cls(bcfg.initial_dim, tuple(bcfg.block_dims), bcfg.norm)


def coarse_channels(bcfg) -> int:
    """Channels of the backbone's coarse map."""
    return bcfg.block_dims[2 if bcfg.resolution[0] == 8 else 3]
