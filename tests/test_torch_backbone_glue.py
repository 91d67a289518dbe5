"""The backbone's glue kernels (far_tpu_torch/ops/backbone_glue.py) and
the backbone's dispatch to them (models/backbone.py).

On the CPU: each entry point (``bn_act`` with ReLU and LeakyReLU,
``bn_add_act`` with and without the downsample branch's BatchNorm,
``up2_add``), which runs its plain version there, bit for bit equal to the
unfused sequence as the backbone ran it before (``norm``, then each step),
in bfloat16 and float32, NHWC and NCHW, at 128, 196 and 256 channels over a
ragged pixel count; both backbones' eval forward, which goes through the
entry points, bit for bit as before the glue existed, from NHWC and NCHW
images; training, grad mode and GroupNorm keep ``bn`` / ``gn``. On a card
(marked ``cuda``; each test skips without one): every kernel against its
plain version, bit for bit in bfloat16 and within 2 ulp in float32, at
synthetic shapes and at every site of the backbone at 480x640 (B=1, B=16)
and 720x544 (B=1); float32 against the unfused sequence on cuDNN's
BatchNorm, which PyTorch takes there, within 2.5 ulp; the launch counts; a compiled
``far_forward`` whose backbone stage holds at least 25 nodes fewer than
with the unfused glue, and whose replay equals the eager request and the
unfused eager request bit for bit.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_backbone_glue.py
"""

import copy
import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from far_tpu_torch.models import backbone
from far_tpu_torch.models.backbone import ResNetFPN_8_2, ResNetFPN_16_4, _up2, conv, norm
from far_tpu_torch.ops import backbone_glue
from far_tpu_torch.ops.backbone_glue import (
    bn_act, bn_act_plain, bn_add_act, bn_add_act_plain, up2_add, up2_add_plain)

torch.set_num_threads(2)

KINDS = ("bn_relu", "bn_leaky", "bn_add", "bn_add_bn", "up2_add")


def _bn(C, g, device="cpu"):
    m = nn.BatchNorm2d(C)
    with torch.no_grad():
        m.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        m.running_var.copy_(0.05 + 2 * torch.rand(C, generator=g))
        m.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
        m.bias.copy_(0.3 * torch.randn(C, generator=g))
    return m.to(device).eval()


def _randomize_norms(model, seed):
    """Every BatchNorm's and GroupNorm's statistics, weight and bias away
    from their (0, 1, 1, 0) init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.load_state_dict(_bn(m.num_features, g).state_dict())
            elif isinstance(m, nn.GroupNorm):
                m.weight.copy_(1 + 0.3 * torch.randn(m.num_channels, generator=g))
                m.bias.copy_(0.3 * torch.randn(m.num_channels, generator=g))
    return model


def _map(shape, g, dtype, layout, device="cpu", shift=False):
    """A random map, NHWC or NCHW; ``shift``: NHWC one element past a 16-byte
    boundary."""
    x = (2 * torch.randn(shape, generator=g)).to(device, dtype)
    if shift:
        B, C, H, W = shape
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        v = buf[1:].view(B, H, W, C).permute(0, 3, 1, 2)
        v.copy_(x)
        return v
    return x.contiguous(memory_format=torch.channels_last) if layout == "nhwc" else x


def _case(kind, C, dtype, layout, g, device="cpu", hw=(5, 7), B=2, shift=False):
    """(fused call, unfused call, float32 scale of the operands) of one
    entry point on random inputs: B maps of C channels over ``hw``."""
    H, W = hw
    _map_ = lambda shape: _map(shape, g, dtype, layout, device, shift)
    if kind == "up2_add":
        a = _map_((B, C, 2 * H, 2 * W))
        small = _map_((B, C, H, W))
        return (lambda: up2_add(a, small), lambda: a + _up2(small),
                lambda: a.float().abs() + _up2(small.float().abs()))
    y = _map_((B, C, H, W))
    m = _bn(C, g, device)
    if kind in ("bn_relu", "bn_leaky"):
        slope = 0.0 if kind == "bn_relu" else 0.01
        unfused = (lambda: F.relu(norm(y, m))) if slope == 0.0 else \
            (lambda: F.leaky_relu(norm(y, m), 0.01))
        return lambda: bn_act(y, m, slope), unfused, lambda: _bn_scale(y, m)
    res = _map_((B, C, H, W))
    m_r = _bn(C, g, device) if kind == "bn_add_bn" else None

    def unfused():
        r = res if m_r is None else norm(res, m_r)
        return F.relu(r + norm(y, m))

    scale = lambda: _bn_scale(y, m) + (res.float().abs() if m_r is None else _bn_scale(res, m_r))
    return lambda: bn_add_act(y, m, res, m_r), unfused, scale


def _bn_scale(x, m):
    """(|x| + |mean|) |weight / sqrt(var + eps)| + |bias|: the size of every
    term of eval BatchNorm, however it is ordered."""
    mul = (m.weight / torch.sqrt(m.running_var + m.eps)).abs()[:, None, None]
    return (x.float().abs() + m.running_mean.abs()[:, None, None]) * mul + m.bias.abs()[:, None, None]


def _ulps(out, ref, scale) -> float:
    """max |out - ref| in float32 ulp of ``scale`` (2^-23 scale)."""
    return float(((out.float() - ref.float()).abs() / (2.0 ** -23 * scale)).max())


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
        b.contiguous().view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


# ---- on the CPU -----------------------------------------------------------


@pytest.mark.parametrize("C", [128, 196, 256])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_entry_points_are_the_unfused_sequence_on_cpu(kind, dtype, layout, C):
    """The CPU's eval glue: the plain version, no launch, bit for bit the
    sequence the backbone ran before (``norm``, then each step)."""
    g = torch.Generator().manual_seed(C)
    fused, unfused, _ = _case(kind, C, dtype, layout, g)
    before = (bn_act.launches, bn_add_act.launches, up2_add.launches)
    out = fused()
    assert _same_bits(out, unfused())
    assert (bn_act.launches, bn_add_act.launches, up2_add.launches) == before


def _old_block(blk, x):
    y = F.relu(norm(conv(x, blk.conv1), blk.bn1))
    y = norm(conv(y, blk.conv2), blk.bn2)
    if blk.downsample is not None:
        x = norm(conv(x, blk.downsample[0]), blk.downsample[1])
    return F.relu(x + y)


def _old_forward(m, x):
    """Both backbones' forward as it was before the glue kernels."""
    h = F.relu(norm(conv(x, m.conv1), m.bn1))
    feats = []
    for stage in (m.layer1, m.layer2, m.layer3) + ((m.layer4,) if hasattr(m, "layer4") else ()):
        for blk in stage:
            h = _old_block(blk, h)
        feats.append(h)
    n = len(feats)
    top = out = conv(feats[-1], getattr(m, f"layer{n}_outconv"))
    for k in (n - 1, n - 2):
        seq = getattr(m, f"layer{k}_outconv2")
        x = conv(feats[k - 1], getattr(m, f"layer{k}_outconv")) + _up2(out)
        out = conv(F.leaky_relu(norm(conv(x, seq[0]), seq[1]), 0.01), seq[3])
    return top, out


def _backbone(arch, norm_kind="batch", seed=0):
    torch.manual_seed(seed)
    m = ResNetFPN_8_2(16, (16, 24, 32), norm_kind) if arch == "8_2" else \
        ResNetFPN_16_4(16, (16, 24, 32, 40), norm_kind)
    return _randomize_norms(m, seed + 1).eval()


def _images(B, H, W, dtype, seed=0, layout="nhwc"):
    """(B, 1, H, W): NHWC images permuted, as FARLoFTR hands them over, or
    NCHW-contiguous ones."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, H, W, 1, generator=g).permute(0, 3, 1, 2).to(dtype)
    return x if layout == "nhwc" else x.contiguous()


def _through(monkeypatch, wrap):
    """The backbone's calls into ops/backbone_glue.py through
    ``wrap(name, entry point)``."""
    monkeypatch.setattr(backbone, "backbone_glue", SimpleNamespace(
        **{name: wrap(name, getattr(backbone_glue, name))
           for name in ("bn_act", "bn_add_act", "up2_add")}))


def _spy(monkeypatch, forbid=False):
    """Counts of the backbone's calls into ops/backbone_glue.py (each call
    raising where ``forbid``)."""
    calls = {"bn_act": 0, "bn_add_act": 0, "up2_add": 0}

    def wrap(name, real):
        def spy(*args):
            if forbid:
                raise AssertionError(f"{name} called")
            calls[name] += 1
            return real(*args)
        return spy

    _through(monkeypatch, wrap)
    return calls


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["8_2", "16_4"])
def test_backbone_forward_as_before_the_glue(arch, dtype, layout, monkeypatch):
    """The eval forward bit for bit as before, through the entry points
    (their plain versions here, the card's kernels there): 8/2 calls bn_act
    9 times (stem, a block's first half, two FPN levels), bn_add_act 6 and
    up2_add 2; 16/4 11, 8, 2."""
    m = _backbone(arch).to(dtype)
    x = _images(2, 64, 96, dtype, layout=layout)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, want = m(x), _old_forward(m, x)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    blocks = 6 if arch == "8_2" else 8
    assert calls == {"bn_act": blocks + 3, "bn_add_act": blocks, "up2_add": 2}


@pytest.mark.parametrize("case", ["train", "grad", "group"])
def test_training_grad_mode_and_groupnorm_keep_bn_and_gn(case, monkeypatch):
    """Train mode (batch statistics, the running update), grad mode and
    GroupNorm never reach the BatchNorm entry points:
    the outputs, gradients and running statistics are the unfused
    sequence's. (GroupNorm's FPN still takes up2_add.)"""
    m = _backbone("8_2", "group" if case == "group" else "batch")
    if case == "train":
        m.train()
    old = copy.deepcopy(m)
    x = _images(2, 64, 96, torch.float32)
    calls = _spy(monkeypatch, forbid=case == "grad")
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        got, want = m(x), _old_forward(old, x)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert calls == {"bn_act": 0, "bn_add_act": 0, "up2_add": 0 if case == "grad" else 2}
    if case == "grad":
        sum(t.sum() for t in got).backward()
        sum(t.sum() for t in want).backward()
        for (name, p), q in zip(m.named_parameters(), old.parameters()):
            assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(m.named_buffers(), old.buffers()):
        assert torch.equal(b, c), name


def test_entry_points_check_shapes_on_cpu():
    g = torch.Generator().manual_seed(0)
    y, m = torch.randn(1, 8, 4, 4, generator=g), _bn(8, g)
    with pytest.raises(ValueError, match="one shape"):
        bn_add_act(y, m, torch.randn(1, 8, 4, 5, generator=g))
    with pytest.raises(ValueError, match="twice"):
        up2_add(torch.randn(1, 8, 8, 9, generator=g), y)
    with torch.no_grad():
        assert backbone._fused(m, None) and backbone._fused()
        assert not backbone._fused(nn.GroupNorm(2, 8))
        assert not backbone._fused(m.train())
    assert not backbone._fused(m.eval()) and not backbone._fused()


# ---- on a card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and run the kernels")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plain_on_card(fn, *args):
    """The unfused sequence on the card on PyTorch's own CUDA kernels, whose
    arithmetic the glue kernels follow: cuDNN's float32 BatchNorm, which
    PyTorch takes where it can (bf16 never), is off. (Against it, float32
    results differ by up to ~2.3 ulp of the operands' scale where two
    BatchNorms meet in bn_add_act.)"""
    with torch.backends.cudnn.flags(enabled=False):
        return fn(*args)


def _held(out, ref, scale, what):
    """bf16 bit for bit; float32 within 2 ulp of the operands' scale; the
    layout kept."""
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    assert out.stride() == ref.stride(), what
    if out.dtype == torch.bfloat16:
        assert _same_bits(out, ref), f"{what}: {int((out != ref).sum())} elements differ"
    else:
        err = _ulps(out, ref, scale)
        assert err <= 2.0, f"{what}: {err:.3f} ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 128, 196, 256])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_glue_kernels_on_card(card, kind, dtype, layout, C):
    """Each kernel against the unfused sequence on a ragged pixel count
    (37 x 53), one launch a call; C = 3 is narrower than a vector."""
    g = torch.Generator().manual_seed(C)
    fused, unfused, scale = _case(kind, C, dtype, layout, g, card, hw=(37, 53))
    wrapper = {"up2_add": up2_add, "bn_add": bn_add_act, "bn_add_bn": bn_add_act}.get(kind, bn_act)
    with torch.inference_mode():
        before = wrapper.launches
        out = fused()
        assert wrapper.launches == before + 1
        _held(out, _plain_on_card(unfused), scale(), f"{kind} {dtype} {layout} C={C}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_glue_kernels_unaligned_on_card(card, kind, dtype):
    """NHWC maps one element past a 16-byte boundary (one-element loads)."""
    g = torch.Generator().manual_seed(1)
    fused, unfused, scale = _case(kind, 196, dtype, "nhwc", g, card, hw=(9, 11), shift=True)
    with torch.inference_mode():
        _held(fused(), _plain_on_card(unfused), scale(), f"{kind} {dtype} unaligned")


@pytest.mark.cuda
def test_glue_refuses_what_it_cannot_take_on_card(card):
    g = torch.Generator().manual_seed(0)
    y = _map((1, 8, 4, 4), g, torch.bfloat16, "nhwc", card)
    m = _bn(8, g, card)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="layout|channels-last"):
            bn_add_act(y, m, y.contiguous())
        with pytest.raises(ValueError, match="eval"):
            bn_act(y, copy.deepcopy(m).train())
        with pytest.raises(TypeError):
            bn_act(y.half(), m)
    with pytest.raises(ValueError, match="gradient"):
        bn_act(y.float().requires_grad_(), m)


SITES = [(1, 480, 640), (16, 480, 640), (1, 720, 544)]


def _backbone_sites(card, dtype, B, H, W, monkeypatch, held):
    """FARConfig()'s ResNet-FPN 8/2 (128, 196, 256), eager, on 2B images of
    H x W: ``held(name, out, plain, scale, args)`` for every glue call, ``plain``
    its plain version and ``scale`` the float32 scale of its operands.
    Returns (name, shape, with a second BatchNorm or input) a call."""
    m = _randomize_norms(ResNetFPN_8_2(), 3).to(card).eval()
    x = _images(2 * B, H, W, dtype).to(card)
    sites = []
    plain = {"bn_act": (bn_act_plain, lambda y, bn, slope=0.0: _bn_scale(y, bn)),
             "bn_add_act": (bn_add_act_plain, lambda y, bn, r, bn_r=None: _bn_scale(y, bn) + (
                 r.float().abs() if bn_r is None else _bn_scale(r, bn_r))),
             "up2_add": (up2_add_plain, lambda a, s: a.float().abs() + _up2(s.float().abs()))}

    def wrap(name, real):
        def call(*args):
            out = real(*args)
            ref, scale = plain[name]
            held(name, out, ref, scale(*args), args)
            sites.append((name, tuple(args[0].shape), args[-1] is not None))
            return out
        return call

    _through(monkeypatch, wrap)
    with torch.inference_mode():
        m(x)
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", SITES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_glue_at_every_backbone_site_on_card(card, dtype, B, H, W, monkeypatch):
    """FARConfig()'s ResNet-FPN 8/2 (128, 196, 256) at the cells' shapes (2B
    images): every glue call of an eager forward against its plain version
    on the same inputs (bf16 bit for bit, float32 within 2 ulp): bn_act 9
    times, bn_add_act 6 (2 with the downsample branch), up2_add 2."""
    def held(name, out, plain, scale, args):
        _held(out, _plain_on_card(plain, *args), scale, f"{name} at {tuple(args[0].shape)}")

    sites = _backbone_sites(card, dtype, B, H, W, monkeypatch, held)
    names = [s[0] for s in sites]
    assert (names.count("bn_act"), names.count("bn_add_act"), names.count("up2_add")) == (9, 6, 2)
    assert sum(1 for s in sites if s[0] == "bn_add_act" and s[2]) == 2
    assert {s[1][1] for s in sites} == {128, 196, 256}


# float32 ulp of the operands' scale between the glue kernels and the
# unfused sequence on cuDNN's BatchNorm, which PyTorch takes for float32
# (the backbone's float32 path before the glue kernels): cuDNN rounds the
# normalisation in another order. Measured on an H100 with torch 2.11:
# 2.000 ulp at most at these sites, 2.258 on random maps where two
# BatchNorms meet in bn_add_act.
CUDNN_F32_ULP = 2.5


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", SITES[::2])
def test_float32_glue_against_cudnn_batchnorm_on_card(card, B, H, W, monkeypatch):
    """Every float32 glue call of the eager forward at the reloc and
    map-free shapes against the unfused sequence as the backbone ran it
    on the card before the glue kernels, cuDNN's BatchNorm included:
    within CUDNN_F32_ULP of the operands' scale, the layout kept."""
    worst = []

    def held(name, out, plain, scale, args):
        with torch.backends.cudnn.flags(enabled=True):
            ref = plain(*args)
        assert out.shape == ref.shape and out.stride() == ref.stride(), name
        worst.append(_ulps(out, ref, scale))
        assert worst[-1] <= CUDNN_F32_ULP, f"{name} at {tuple(args[0].shape)}: {worst[-1]:.3f} ulp"

    sites = _backbone_sites(card, torch.float32, B, H, W, monkeypatch, held)
    print(f"float32 glue against cuDNN's BatchNorm at {B}x{H}x{W}: {max(worst):.3f} ulp at most")
    assert len(sites) == 17


# far.capture.nodes.backbone of the compiled far_forward below with the
# unfused glue (the backbone before the glue kernels; 137 with them), on an
# H100 with torch 2.11
UNFUSED_BACKBONE_NODES = 196


@pytest.mark.cuda
def test_compiled_request_takes_the_glue_on_card(card, monkeypatch):
    """FARConfig() in bf16 at 480x640, B=1 (the reloc cell's request): an
    eager far_forward launches bn_act 9, bn_add_act 6, up2_add 2 and equals
    the unfused eager request bit for bit; the compiled request's backbone
    stage holds at least 25 nodes fewer than the same capture with the
    unfused glue (recorded in UNFUSED_BACKBONE_NODES), and its replay
    equals both eager requests bit for bit."""
    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.pipeline import build_inference_fn, far_forward, init_model
    from far_tpu_torch.utils.config import FARConfig
    from far_tpu_torch.utils.prof import counters

    cfg = FARConfig(dtype="bfloat16")
    model = _randomize_norms(init_model(cfg, seed=1, device=card), 5)
    batch = synthetic_batch(1, *cfg.image_size, card, seed=3)
    gen = torch.Generator(device=card)

    def fields(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            yield from (fields(v) if dataclasses.is_dataclass(v) else
                        [(f.name, v)] if isinstance(v, torch.Tensor) else [])

    def same(a, b):
        for (name, x), (_, y) in zip(fields(a), fields(b)):
            assert torch.equal(x, y), name

    def backbone_nodes():
        fn = build_inference_fn(model)
        before = counters().get("far.capture.nodes.backbone", 0)
        first = fn(batch, generator=gen.manual_seed(2))
        nodes = counters()["far.capture.nodes.backbone"] - before
        out = fn(batch, generator=gen.manual_seed(2))
        torch.cuda.synchronize()
        return nodes, first, out

    launched = (bn_act.launches, bn_add_act.launches, up2_add.launches)
    with torch.inference_mode():
        ref = far_forward(model, batch, gen.manual_seed(2))
    assert (bn_act.launches - launched[0], bn_add_act.launches - launched[1],
            up2_add.launches - launched[2]) == (9, 6, 2)
    fused_nodes, first, out = backbone_nodes()
    same(first, ref)
    same(out, ref)
    with monkeypatch.context() as mp:
        mp.setattr(backbone, "_fused", lambda *mods: False)
        with torch.inference_mode():
            ref_unfused = far_forward(model, batch, gen.manual_seed(2))
        unfused_nodes, _, out_unfused = backbone_nodes()
    same(ref_unfused, ref)
    same(out_unfused, ref)
    print(f"far.capture.nodes.backbone: fused {fused_nodes}, unfused {unfused_nodes}")
    assert unfused_nodes == UNFUSED_BACKBONE_NODES
    assert fused_nodes <= unfused_nodes - 25
