"""ResNet-FPN 8/2 feature backbone (NCHW inside).

Counterpart of ``far_tpu/models/backbone.py:ResNetFPN_8_2``, with the
reference's module names (``conv1``, ``layer1.0.conv1``,
``layer2_outconv2.1``, ...) so a reference state dict loads with
``strict=True``. The stem is a plain 7x7/2 convolution: the JAX
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
variance is unbiased.

Under ``deferred_running_stats(sink)`` a train-mode BatchNorm appends
(module, batch mean, batch variance) to ``sink`` instead of updating its
running statistics; ``update_running_stats(sink)`` applies them. The
remat path (``models/loftr.py``) needs that: a checkpointed backbone runs
its forward again in the backward pass, and an in-place update there
would move the statistics twice (momentum 0.81, not 0.9), where Flax's
functional ``nn.remat`` updates them once.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    mean = x32.mean(dim=(0, 2, 3))
    var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    sink = _DEFERRED.get()
    if sink is None:
        update_running_stats([(m, mean, var)])
    else:
        sink.append((m, mean.detach(), var.detach()))
    mul = torch.rsqrt(var + m.eps) * m.weight
    y = (x32 - mean[:, None, None]) * mul[:, None, None] + m.bias[:, None, None]
    return y.to(dt)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def _conv1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, 0, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3(cin, planes, stride)
        self.conv2 = _conv3(planes, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(_conv1(cin, planes, stride),
                                            nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(bn(conv(x, self.conv1), self.bn1))
        y = bn(conv(y, self.conv2), self.bn2)
        if self.downsample is not None:
            x = bn(conv(x, self.downsample[0]), self.downsample[1])
        return F.relu(x + y)


def _outconv2(mid: int, out: int) -> nn.Sequential:
    return nn.Sequential(_conv3(mid, mid), nn.BatchNorm2d(mid),
                         nn.LeakyReLU(0.01), _conv3(mid, out))


def _refine(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    x = F.leaky_relu(bn(conv(x, seq[0]), seq[1]), 0.01)
    return conv(x, seq[3])


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


class ResNetFPN_8_2(nn.Module):
    """Coarse 1/8 (block_dims[2] channels) + fine 1/2 (block_dims[0])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256)):
        super().__init__()
        d0, d1, d2 = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d0, 1),
                                    BasicBlock(d0, d0, 1))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2),
                                    BasicBlock(d1, d1, 1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2),
                                    BasicBlock(d2, d2, 1))
        self.layer3_outconv = _conv1(d2, d2)
        self.layer2_outconv = _conv1(d1, d2)
        self.layer2_outconv2 = _outconv2(d2, d1)
        self.layer1_outconv = _conv1(d0, d1)
        self.layer1_outconv2 = _outconv2(d1, d0)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 1, H, W) -> coarse (B, d2, H/8, W/8), fine (B, d0, H/2, W/2)."""
        x0 = F.relu(bn(conv(x, self.conv1), self.bn1))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = conv(x3, self.layer3_outconv)
        x2_out = _refine(conv(x2, self.layer2_outconv) + _up2(x3_out),
                         self.layer2_outconv2)
        x1_out = _refine(conv(x1, self.layer1_outconv) + _up2(x2_out),
                         self.layer1_outconv2)
        return x3_out, x1_out
