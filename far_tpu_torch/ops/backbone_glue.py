"""The backbone's glue between two cuDNN convolutions, one pass a
convolution output: eval BatchNorm with ReLU or LeakyReLU, the residual
block's second half, and the FPN's x2 upsample-add.

Replaces no Pallas kernel (``csrc/backbone_glue.cu`` says why it exists,
what bounds it and how it rounds). Each entry point's plain version is the
unfused PyTorch sequence (eval BatchNorm as ``models/backbone.py``'s ``bn``
computes it); the CPU runs it, the backbone's eval forward included. On
the card the kernel computes the same thing, rounded at the same points:
bfloat16 results are bit-equal to the plain version there, float32 within
2 ulp. (Training, grad mode and GroupNorm never come here: the backbone
keeps its ``norm`` for them.)
The BatchNorms are eval ``nn.BatchNorm2d`` modules, read through their
running statistics, weight and bias at each launch. Every tensor of a call
lies in one layout, NHWC (channels-last) or NCHW contiguous; a CUDA call
the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.ops import _build

MAX_CHANNELS = 1024  # csrc/backbone_glue.cu: the per-channel table's bound


def _bn_plain(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


def _act(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.relu(x) if slope == 0.0 else F.leaky_relu(x, slope)


def bn_act_plain(y: torch.Tensor, bn: nn.BatchNorm2d, slope: float = 0.0) -> torch.Tensor:
    return _act(_bn_plain(y, bn), slope)


def bn_add_act_plain(y: torch.Tensor, bn: nn.BatchNorm2d, res: torch.Tensor,
                     bn_res: Optional[nn.BatchNorm2d] = None) -> torch.Tensor:
    y = _bn_plain(y, bn)
    if bn_res is not None:
        res = _bn_plain(res, bn_res)
    return F.relu(res + y)


def up2_add_plain(a: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    return a + F.interpolate(small, scale_factor=2.0, mode="bilinear", align_corners=True)


def _layout(what: str, first: torch.Tensor, *others: torch.Tensor) -> torch.memory_format:
    """NCHW-contiguous or channels-last, as ``first`` is; every other tensor
    must be contiguous in the same one."""
    fmt = (torch.contiguous_format if first.is_contiguous() else torch.channels_last
           if first.dim() == 4 and first.is_contiguous(memory_format=torch.channels_last)
           else None)
    if first.dim() != 4 or fmt is None or not all(t.is_contiguous(memory_format=fmt)
                                                   for t in others):
        raise ValueError(f"{what} takes (B, C, H, W) maps all NCHW-contiguous or all "
                         f"channels-last, got shape {tuple(first.shape)}, strides "
                         f"{[t.stride() for t in (first, *others)]}")
    return fmt


def _inner(t: torch.Tensor, fmt: torch.memory_format) -> int:
    """Elements between two channels: 1 in NHWC, H * W in NCHW."""
    return 1 if fmt == torch.channels_last else t.shape[2] * t.shape[3]


def _bn_args(what: str, m: nn.BatchNorm2d, y: torch.Tensor):
    params = (m.running_mean, m.running_var, m.weight, m.bias)
    if y.shape[1] > MAX_CHANNELS:
        raise ValueError(f"{what} takes at most {MAX_CHANNELS} channels, got {y.shape[1]}")
    if not isinstance(m, nn.BatchNorm2d) or m.training:
        raise ValueError(f"{what} takes an eval nn.BatchNorm2d, got {type(m).__name__} "
                         f"(training={m.training})")
    if not all(p is not None and p.dtype == torch.float32 and p.is_contiguous()
               and p.device == y.device and p.shape == (y.shape[1],) for p in params):
        raise ValueError(f"{what}: the BatchNorm's running statistics, weight and bias must "
                         f"be float32 vectors of {y.shape[1]} on {y.device}")
    return [p.data_ptr() for p in params], float(m.eps)


def _check(what: str, *tensors: torch.Tensor, params=()) -> int:
    """The dtype code of the call's maps; raises on what the kernel does not
    take, or where a map or a parameter requires grad in grad mode."""
    code = _build.dtype_code(tensors[0])
    if not all(t.dtype == tensors[0].dtype for t in tensors):
        raise ValueError(f"{what} takes one dtype, got {[t.dtype for t in tensors]}")
    if not all(t.numel() < 2 ** 31 for t in tensors):
        raise ValueError(f"{what} takes fewer than 2^31 elements a tensor, got "
                         f"{tuple(tensors[0].shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, *params)):
        raise ValueError(f"{what}: the CUDA kernel has no gradient and an input requires "
                         f"grad; run it under torch.no_grad()")
    return code


def _aligned(nbytes: int, *tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


def _bn_glue(what: str, wrapper, y: torch.Tensor, bn: nn.BatchNorm2d, res, bn_res,
             slope: float) -> torch.Tensor:
    others = () if res is None else (res,)
    fmt = _layout(what, y, *others)
    mods = (bn,) if bn_res is None else (bn, bn_res)
    code = _check(what, y, *others, params=[p for m in mods for p in (m.weight, m.bias)])
    out = torch.empty_like(y, memory_format=fmt)
    ptrs, eps = _bn_args(what, bn, y)
    ptrs_r, eps_r = _bn_args(what, bn_res, y) if bn_res is not None else ([None] * 4, 0.0)
    mode = 0 if res is None else 1 if bn_res is None else 2
    vec = 2 if _aligned(16, y, out, *others) else 1
    fn = _build.bind("backbone_glue", "far_bn_glue", 11, 6, 3)
    _build.check(fn(y.data_ptr(), None if res is None else res.data_ptr(), out.data_ptr(),
                    *ptrs, *ptrs_r, y.numel(), y.shape[1], _inner(y, fmt), code, mode, vec,
                    eps, eps_r, float(slope), _build.stream_of(y)), what)
    _build.count_launch(wrapper)
    return out


def bn_act(y: torch.Tensor, bn: nn.BatchNorm2d, slope: float = 0.0) -> torch.Tensor:
    """act(bn(y)): ReLU for ``slope`` 0, else LeakyReLU(slope); ``bn`` an
    eval BatchNorm2d of y's channels. The plain version on the CPU, one
    kernel pass on CUDA."""
    if _build.on_cpu(y):
        return bn_act_plain(y, bn, slope)
    return _bn_glue("bn_act", bn_act, y, bn, None, None, slope)


def bn_add_act(y: torch.Tensor, bn: nn.BatchNorm2d, res: torch.Tensor,
               bn_res: Optional[nn.BatchNorm2d] = None) -> torch.Tensor:
    """relu(r + bf16(bn(y))) with r = res, or bn_res(res) rounded, where
    given: a residual block's second half (``bn_res`` the downsample
    branch's BatchNorm). The plain version on the CPU, one kernel pass on
    CUDA."""
    if res.shape != y.shape:
        raise ValueError(f"bn_add_act takes y and res of one shape, got {tuple(y.shape)} "
                         f"and {tuple(res.shape)}")
    if _build.on_cpu(y, res):
        return bn_add_act_plain(y, bn, res, bn_res)
    return _bn_glue("bn_add_act", bn_add_act, y, bn, res, bn_res, 0.0)


def up2_add(a: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """a + up2(small): small (B, C, H, W) upsampled bilinearly x2 with
    align_corners=True to a's (B, C, 2H, 2W), rounded, then added. The
    plain version on the CPU, one kernel pass on CUDA."""
    B, C, H, W = small.shape
    if tuple(a.shape) != (B, C, 2 * H, 2 * W):
        raise ValueError(f"up2_add takes a of twice small's size, got {tuple(a.shape)} and "
                         f"{tuple(small.shape)}")
    if _build.on_cpu(a, small):
        return up2_add_plain(a, small)
    fmt = _layout("up2_add", a, small)
    code = _check("up2_add", a, small)
    out = torch.empty_like(a, memory_format=fmt)
    nchw = int(fmt == torch.contiguous_format)
    size = a.element_size()
    vec_bytes = next(v for v in (16, 8, 4, 2, size)
                     if v >= size and C * size % v == 0 and _aligned(v, a, small, out))
    fn = _build.bind("backbone_glue", "far_up2_add", 3, 7)
    _build.check(fn(a.data_ptr(), small.data_ptr(), out.data_ptr(), B, C, H, W, nchw, code,
                    vec_bytes, _build.stream_of(a)), "up2_add")
    _build.count_launch(up2_add)
    return out


bn_act.launches = 0      # launches of far_bn_glue for bn_act
bn_add_act.launches = 0  # launches of far_bn_glue for bn_add_act
up2_add.launches = 0     # launches of far_up2_add
