"""far_tpu_torch's training against the JAX package's, on the CPU.

Small configuration (``test_torch_modules.small_config``), float32. The
same inputs, made with numpy from seeds, go to both packages: the
supervision on ``SyntheticPairDataset`` pairs, every loss, the optimizer
and schedule against optax step for step, the gradients of the K1, K3
and K4 Functions against autograd through their plain versions (and
K4's against the JAX package's VJP), one whole train step against
``far_tpu.train.trainer.make_train_step``, and the checkpoints. Each
tolerance is stated where it is checked.
"""

import dataclasses
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import far_tpu.train.trainer as jtrainer
import far_tpu_torch.train.trainer as ttrainer
from far_tpu.geometry.warp import warp_kpts as jwarp
from far_tpu.models import matching as jmatching
from far_tpu.models.attention import full_attention as jfull
from far_tpu.models.attention import linear_attention as jlinear
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.ops.bilinear_attention import bilinear_dual_softmax as jbilinear
from far_tpu.train import checkpoint as jckpt
from far_tpu.train import losses as jlosses
from far_tpu.train import optim as joptim
from far_tpu.train import supervision as jsup
from far_tpu.types import PairBatch as JPairBatch
from far_tpu.utils import config as jconfig
from far_tpu.utils.convert_weights import convert_loftr_state_dict
from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
from far_tpu_torch.geometry.warp import warp_kpts
from far_tpu_torch.models import matching as tmatching
from far_tpu_torch.models.attention import full_attention, linear_attention
from far_tpu_torch.models.backbone import bn
from far_tpu_torch.ops.bilinear_attention import (
    bilinear_dual_softmax_auto,
    bilinear_dual_softmax_plain,
    bilinear_dual_softmax_streaming,
    pick_block,
)
from far_tpu_torch.ops.fine_layer import fine_transformer_auto, fine_transformer_plain
from far_tpu_torch.ops.loftr_layer import PARAM_KEYS, loftr_layer_auto, loftr_layer_plain
from far_tpu_torch.train import checkpoint as tckpt
from far_tpu_torch.train import losses as tlosses
from far_tpu_torch.train import optim as toptim
from far_tpu_torch.train import supervision as tsup
from far_tpu_torch.train.trainer import Trainer
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import flax_to_state_dict
from test_torch_modules import small_config

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_close(out, ref, rel, what=""):
    """|out - ref| <= rel * max(|ref|, 1e-30) elementwise in the max norm."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def pairs(hw, n=2, seed=0):
    """(port batch, JAX batch) of ``n`` SyntheticPairDataset pairs."""
    ds = SyntheticPairDataset(n=n, hw=hw, seed=seed)
    tb, _ = collate([ds[i] for i in range(n)])
    jb = JPairBatch(**{k: jnp.asarray(getattr(tb, k).numpy())
                       for k in ("image0", "image1", "K0", "K1", "T_0to1",
                                 "T_1to0", "depth0", "depth1")})
    return tb, jb


# ---- supervision ---------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (120, 160)])
def test_warp_and_supervision(hw):
    """warp_kpts, coarse_supervision and fine_supervision on synthetic pairs
    with exact depth and pose: the validity mask and conf_gt equal, the
    warped points within 1e-4 px, the fine offsets within 1e-5 relative."""
    tb, jb = pairs(hw)
    coarse_hw = (hw[0] // 8, hw[1] // 8)
    grid = tsup._grid_pts(*coarse_hw, 8.0, 2, "cpu")
    valid, w = warp_kpts(grid, tb.depth0, tb.depth1, tb.T_0to1, tb.K0, tb.K1)
    jvalid, jw = jwarp(jnp.asarray(grid.numpy()), jb.depth0, jb.depth1, jb.T_0to1,
                       jb.K0, jb.K1)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.sum() >= 4   # the splatted depth grows sparser with the size
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-4)

    conf_gt, w_pt0, pt1 = tsup.coarse_supervision(tb, coarse_hw, 8.0)
    jconf, jw_pt0, jpt1 = jsup.coarse_supervision(jb, coarse_hw, 8.0)
    np.testing.assert_array_equal(conf_gt.numpy(), np.asarray(jconf))
    assert conf_gt.sum() >= 4   # real positives (32 at 64x64, 4 at 120x160)
    np.testing.assert_allclose(w_pt0.numpy(), np.asarray(jw_pt0), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(pt1.numpy(), np.asarray(jpt1))

    rng = np.random.default_rng(1)
    L = coarse_hw[0] * coarse_hw[1]
    ids = rng.integers(0, L, (2, 2, 16))
    scale1 = np.array([[1.0, 1.0], [1.5, 0.75]], np.float32)
    for s1 in (None, scale1):
        f = tsup.fine_supervision(w_pt0, pt1, t(ids[0]), t(ids[1]), 2.0, 5,
                                  None if s1 is None else t(s1))
        jf = jsup.fine_supervision(jw_pt0, jpt1, jnp.asarray(ids[0]), jnp.asarray(ids[1]),
                                   2.0, 5, None if s1 is None else jnp.asarray(s1))
        rel_close(f, jf, 1e-5, "fine_supervision")


def test_coarse_supervision_with_resize_scales():
    """The per-pair resize factors enter both grids and leave the warped
    cells as in the JAX package."""
    tb, jb = pairs((64, 64))
    s0 = np.array([[1.0, 1.0], [1.25, 1.25]], np.float32)
    s1 = np.array([[1.0, 1.0], [0.8, 0.8]], np.float32)
    tb = dataclasses.replace(tb, scale0=t(s0), scale1=t(s1))
    jb = jb.replace(scale0=jnp.asarray(s0), scale1=jnp.asarray(s1))
    conf_gt, w_pt0, _ = tsup.coarse_supervision(tb, (8, 8), 8.0)
    jconf, jw_pt0, _ = jsup.coarse_supervision(jb, (8, 8), 8.0)
    np.testing.assert_array_equal(conf_gt.numpy(), np.asarray(jconf))
    np.testing.assert_allclose(w_pt0.numpy(), np.asarray(jw_pt0), rtol=1e-6, atol=1e-4)


# ---- losses --------------------------------------------------------------


def _loss_inputs():
    rng = np.random.default_rng(2)
    B, L, K = 2, 40, 24
    conf = rng.uniform(0, 1, (B, L, L)).astype(np.float32) ** 4
    conf_gt = (rng.uniform(0, 1, (B, L, L)) < 0.05).astype(np.float32)
    expec = np.concatenate([rng.uniform(-1, 1, (B, K, 2)),
                            rng.uniform(0.05, 1.5, (B, K, 1))], -1).astype(np.float32)
    expec_gt = rng.uniform(-1.3, 1.3, (B, K, 2)).astype(np.float32)
    valid = rng.uniform(0, 1, (B, K)) < 0.7
    pose = rng.normal(0, 1, (B, 9)).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3, (B, 3))
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        c, s = np.cos(ang[b, 0]), np.sin(ang[b, 0])
        T[b, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[b, :3, 3] = rng.normal(0, 1, 3)
    return conf, conf_gt, expec, expec_gt, valid, pose, T


@pytest.mark.parametrize("coarse_type,sparse", [("focal", True), ("focal", False),
                                                ("cross_entropy", True)])
def test_coarse_loss(coarse_type, sparse):
    conf, conf_gt, *_ = _loss_inputs()
    cfg_t = tconfig.LossConfig(coarse_type=coarse_type)
    cfg_j = jconfig.LossConfig(coarse_type=coarse_type)
    out = tlosses.coarse_loss(t(conf), t(conf_gt), cfg_t, sparse)
    rel_close(out, jlosses.coarse_loss(jnp.asarray(conf), jnp.asarray(conf_gt), cfg_j,
                                       sparse), 1e-5, coarse_type)


@pytest.mark.parametrize("fine_type", ["l2", "l2_with_std"])
def test_fine_loss(fine_type):
    """Values within 1e-5 relative, and the gradient with respect to
    expec_f (the inverse-std weights detached in both)."""
    _, _, expec, expec_gt, valid, *_ = _loss_inputs()
    cfg_t = tconfig.LossConfig(fine_type=fine_type)
    cfg_j = jconfig.LossConfig(fine_type=fine_type)
    e = t(expec).requires_grad_()
    out = tlosses.fine_loss(e, t(expec_gt), t(valid), cfg_t)
    out.backward()
    jval, jgrad = jax.value_and_grad(
        lambda a: jlosses.fine_loss(a, jnp.asarray(expec_gt), jnp.asarray(valid), cfg_j)
    )(jnp.asarray(expec))
    rel_close(out, jval, 1e-5, fine_type)
    rel_close(e.grad, jgrad, 1e-5, fine_type + " grad")


@pytest.mark.parametrize("l1", [True, False])
def test_rt_loss(l1):
    *_, pose, T = _loss_inputs()
    out = tlosses.rt_loss(t(pose), t(T), tconfig.LossConfig(use_l1_rt_loss=l1))
    ref = jlosses.rt_loss(jnp.asarray(pose), jnp.asarray(T),
                          jconfig.LossConfig(use_l1_rt_loss=l1))
    for o, r in zip(out, ref):
        rel_close(o, r, 1e-5, f"rt l1={l1}")


@pytest.mark.parametrize("offset", [0.3, 3.0])  # below and above max_scale_loss
def test_scale_loss_and_total(offset):
    conf, conf_gt, expec, expec_gt, valid, pose, T = _loss_inputs()
    ts = np.linalg.norm(T[:, :3, 3], axis=-1).astype(np.float32) + offset
    cfg_t = tconfig.LossConfig(scale_weight=0.5)
    cfg_j = jconfig.LossConfig(scale_weight=0.5)
    rel_close(tlosses.scale_loss(t(ts), t(T), cfg_t),
              jlosses.scale_loss(jnp.asarray(ts), jnp.asarray(T), cfg_j), 1e-5, "scale")
    out = tlosses.compute_losses(cfg_t, t(conf), t(conf_gt), t(expec), t(expec_gt),
                                 t(valid), t(pose), t(T), t(ts), sparse_spvs=False)
    ref = jlosses.compute_losses(cfg_j, *(jnp.asarray(a) for a in (
        conf, conf_gt, expec, expec_gt, valid, pose, T, ts)), sparse_spvs=False)
    for k, v in out.scalars().items():
        rel_close(v, ref.scalars()[k], 1e-5, k)


# ---- optimizer and schedule ----------------------------------------------


def _optim_cfg(mod, scheduler, variant, **over):
    kw = dict(optimizer="adamw" if variant == "adamw" else "adam", lr=1e-3,
              adam_decay=0.01 if variant == "adam+decay" else 0.0, warmup_steps=5,
              warmup_ratio=0.1, scheduler=scheduler, steps_per_epoch=2,
              mslr_milestones=(3, 6), cosa_tmax=5, elr_gamma=0.9,
              onecycle_total_steps=200, grad_clip=0.5)
    kw.update(over)
    return mod.OptimConfig(**kw)


@pytest.mark.parametrize("variant", ["adam", "adam+decay", "adamw"])
@pytest.mark.parametrize("scheduler", ["multistep", "cosine", "exponential",
                                       "onecycle", "none"])
def test_optimizer_against_optax(scheduler, variant):
    """20 steps of a fixed gradient sequence whose norm crosses the clip
    (0.5) both ways, with a NaN at step 7: the parameters within 1e-6
    relative after every step, and the skipped step changes neither the
    parameters nor the optimizer's state. At lr 1e-3 a wrong clip, skip,
    schedule or decay moves a parameter by 1e-4 of it or more; optax's
    float32 bias corrections (1 - 0.999^t keeps ~5 digits in float32,
    torch computes it in double) move it by ~1e-8."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(t(p)) for p in p0]
    opt = toptim.build_optimizer(_optim_cfg(toptim, scheduler, variant), params)
    tx = joptim.build_optimizer(_optim_cfg(joptim, scheduler, variant))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for step in range(20):
        scale = 0.05 if step % 3 == 0 else 2.0
        g = [(rng.normal(0, 1, s) * scale).astype(np.float32) for s in shapes]
        if step == 7:
            g[1][2] = np.nan
        for p, gi in zip(params, g):
            p.grad = t(gi)
        before = [p.detach().clone() for p in params]
        inner_before = {k: v["exp_avg"].clone() for k, v in enumerate(opt.inner.state.values())}
        applied = opt.step()
        upd, state = update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        assert applied == (step != 7)
        if step == 7:
            assert opt.count == 7 and opt.notfinite_count == 1
            for p, b in zip(params, before):
                assert torch.equal(p.detach(), b)
            for k, v in enumerate(opt.inner.state.values()):
                assert torch.equal(v["exp_avg"], inner_before[k])
        for p, r in zip(params, jp):
            rel_close(p, r, 1e-6, f"{scheduler} {variant} step {step}")


@pytest.mark.parametrize("warmup_type", ["linear", "constant"])
def test_schedule_against_optax(warmup_type):
    """The schedules alone, counts 0..59, every decay kind: within 1e-6 of
    the peak lr (optax computes in float32, where the one-cycle cosine's
    cancellation leaves ~2e-6 of its smallest values; the port in double)."""
    for scheduler in ("multistep", "cosine", "exponential", "onecycle", "none"):
        over = dict(warmup_type=warmup_type, warmup_steps=7)
        ours = toptim.build_schedule(_optim_cfg(toptim, scheduler, "adamw", **over))
        ref = joptim.build_schedule(_optim_cfg(joptim, scheduler, "adamw", **over))
        for count in range(60):
            np.testing.assert_allclose(ours(count), float(ref(count)), rtol=0, atol=1e-9,
                                       err_msg=f"{scheduler} count {count}")


def test_optim_config_copy():
    assert dataclasses.asdict(toptim.OptimConfig()) == dataclasses.asdict(joptim.OptimConfig())


# ---- the differentiable kernel wrappers ----------------------------------


def _layer_params(C, rng):
    w = lambda o, i: t(rng.normal(0, i ** -0.5, (o, i)).astype(np.float32))
    ln = lambda: t(np.stack([1 + 0.1 * rng.normal(size=C),
                             0.1 * rng.normal(size=C)]).astype(np.float32))
    return {"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
            "w0": w(2 * C, 2 * C), "w1": w(C, 2 * C), "ln1": ln(), "ln2": ln()}


def _grads(fn, inputs, seed):
    """Gradients of <fn(*inputs), cotangent> for every input."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    cot = [t(rng.normal(size=o.shape).astype(np.float32)) for o in outs]
    torch.autograd.backward(outs, cot)
    return [o.detach() for o in outs], [x.grad for x in leaves]


@pytest.mark.parametrize("self_layer", [True, False])
def test_loftr_layer_function_grads(self_layer):
    """K1's Function: the same output as the plain version and, through
    its recompute, autograd's gradients of the plain version for x,
    source and every weight (a self layer passes x twice; both gradients
    add up). f32, 1e-5 relative per tensor."""
    rng = np.random.default_rng(5)
    C, H = 32, 4
    p = _layer_params(C, rng)
    x = t(rng.normal(size=(2, 50, C)).astype(np.float32))
    src = x if self_layer else t(rng.normal(size=(2, 70, C)).astype(np.float32))
    keys = list(PARAM_KEYS)

    def auto(x, s, *w):
        return loftr_layer_auto(x, x if self_layer else s, dict(zip(keys, w)), H)

    def plain(x, s, *w):
        return loftr_layer_plain(x, x if self_layer else s, dict(zip(keys, w)), H)

    inputs = [x, src] + [p[k] for k in keys]
    (o1,), g1 = _grads(auto, inputs, 0)
    (o2,), g2 = _grads(plain, inputs, 0)
    assert torch.equal(o1, o2)
    for name, a, b in zip(["x", "source"] + keys, g1, g2):
        if self_layer and name == "source":
            assert a is None and b is None
            continue
        rel_close(a, b.numpy(), 1e-5, name)


def test_fine_transformer_function_grads():
    """K3's Function against autograd through fine_transformer_plain."""
    rng = np.random.default_rng(6)
    C, H = 16, 4
    params = [_layer_params(C, rng) for _ in range(2)]
    names = ("self", "cross")
    f0 = t(rng.normal(size=(6, 25, C)).astype(np.float32))
    f1 = t(rng.normal(size=(6, 25, C)).astype(np.float32))
    flat = [p[k] for p in params for k in PARAM_KEYS]
    n = len(PARAM_KEYS)
    dicts = lambda w: [dict(zip(PARAM_KEYS, w[:n])), dict(zip(PARAM_KEYS, w[n:]))]
    o1, g1 = _grads(lambda a, b, *w: fine_transformer_auto(a, b, dicts(w), names, H),
                    [f0, f1] + flat, 1)
    o2, g2 = _grads(lambda a, b, *w: fine_transformer_plain(a, b, dicts(w), names, H),
                    [f0, f1] + flat, 1)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(g1, g2)):
        rel_close(a, b.numpy(), 1e-5, f"input {i}")


@pytest.mark.parametrize("N", [64, 1024])
def test_bilinear_function_grads(N):
    """K4's Function: below N = 1024 its backward differentiates the plain
    version, from 1024 the streaming twin (row blocks of 512 under
    torch.utils.checkpoint). Gradients of q, k, v against autograd
    through the plain version and against the JAX package's VJP (which
    takes the same two routes), 1e-5 relative; the twin's forward equals
    the plain version's to 1e-5."""
    rng = np.random.default_rng(7)
    B, H, D, Dv = 1, 2, 8, 14
    q, k = (t(rng.normal(size=(B, H, N, D)).astype(np.float32)) for _ in range(2))
    v = t(rng.normal(size=(B, H, N, Dv)).astype(np.float32))
    (o1,), g1 = _grads(lambda a, b, c: bilinear_dual_softmax_auto(a, b, c, 0.3), [q, k, v], 2)
    (o2,), g2 = _grads(lambda a, b, c: bilinear_dual_softmax_plain(a, b, c, 0.3), [q, k, v], 2)
    assert torch.equal(o1, o2)
    cot = jnp.asarray(np.random.default_rng(2).normal(size=o1.shape).astype(np.float32))
    _, vjp = jax.vjp(lambda a, b, c: jbilinear(a, b, c, 0.3),
                     *(jnp.asarray(a.numpy()) for a in (q, k, v)))
    for name, a, b, r in zip("qkv", g1, g2, vjp(cot)):
        rel_close(a, b.numpy(), 1e-5, name)
        rel_close(a, r, 1e-5, name + " vs JAX")
    if N >= 1024:
        assert pick_block(N) == 512 and pick_block(4800) == 480
        rel_close(bilinear_dual_softmax_streaming(q, k, v, 0.3, 512), o2.numpy(), 1e-5,
                  "streaming forward")


def test_functions_run_without_autograd():
    """Under torch.inference_mode and torch.no_grad the Functions run
    their forward only, as serving calls them."""
    rng = np.random.default_rng(8)
    p = _layer_params(16, rng)
    x = t(rng.normal(size=(1, 10, 16)).astype(np.float32))
    ref = loftr_layer_plain(x, x, p, 4)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            out = loftr_layer_auto(x, x, p, 4)
        assert torch.equal(out, ref) and not out.requires_grad


# ---- train-mode modules --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode(dtype):
    """bn() in training against Flax's BatchNorm(momentum=0.9): the output
    (1e-5 relative in f32; one bf16 rounding in bf16) and the running
    statistics (1e-5 relative; statistics in f32 in both dtypes)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(0.5, 2.0, (4, 6, 5, 7))).astype(np.float32)    # NHWC
    mean0 = rng.normal(0, 1, 7).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    bias = rng.normal(0, 1, 7).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    ref, new = layer.apply(variables, jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
    m = torch.nn.BatchNorm2d(7).train()
    with torch.no_grad():
        m.weight.copy_(t(scale))
        m.bias.copy_(t(bias))
        m.running_mean.copy_(t(mean0))
        m.running_var.copy_(t(var0))
    tdt = getattr(torch, dtype)
    out = bn(t(x).permute(0, 3, 1, 2).to(tdt), m).permute(0, 2, 3, 1)
    assert out.dtype == tdt
    rel = 1e-5 if dtype == "float32" else 2 ** -8
    rel_close(out.float(), np.asarray(ref.astype(jnp.float32)), rel, "output")
    rel_close(m.running_mean, new["batch_stats"]["mean"], 1e-5, "running mean")
    rel_close(m.running_var, new["batch_stats"]["var"], 1e-5, "running var")


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_attention_with_masks(kind):
    rng = np.random.default_rng(10)
    q = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 4, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 4, 8)).astype(np.float32)
    qm = rng.uniform(size=(2, 12)) < 0.8
    km = rng.uniform(size=(2, 9)) < 0.8
    ours, ref = (linear_attention, jlinear) if kind == "linear" else (full_attention, jfull)
    for masks in ((None, None), (qm, km)):
        out = ours(t(q), t(k), t(v), *(None if a is None else t(a) for a in masks))
        r = ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                *(None if a is None else jnp.asarray(a) for a in masks))
        rel_close(out, r, 1e-5, kind)


def test_dense_coarse_match():
    """The training branch of coarse_match (dense conf matrix) on features
    with real mutual matches: ids, validity and the matrix as JAX's."""
    rng = np.random.default_rng(11)
    hw = (8, 10)
    L = hw[0] * hw[1]
    f1 = rng.standard_normal((2, L, 32)).astype(np.float32)
    perm = np.stack([rng.permutation(L) for _ in range(2)])
    f0 = np.take_along_axis(f1, perm[..., None], axis=1) \
        + 0.3 * rng.standard_normal((2, L, 32)).astype(np.float32)
    cfg_t, cfg_j = small_config(tconfig).match, small_config(jconfig).match
    out = tmatching.coarse_match(t(f0), t(f1), hw, hw, 8.0, cfg_t, return_conf=True)
    ref = jmatching.coarse_match(jnp.asarray(f0), jnp.asarray(f1), hw, hw, 8.0, cfg_j,
                                 return_conf=True)
    assert out[3].sum() >= 8
    for i in (0, 1, 3):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    for i in (2, 4, 5, 6):
        rel_close(out[i], ref[i], 1e-5, f"output {i}")


# ---- one train step against make_train_step ------------------------------


def _fixed_estimate(B):
    """A solver result that does not depend on the matches (RANSAC on a
    random model's matches picks among near-ties; see ROADMAP)."""
    rng = np.random.default_rng(12)
    c, s = np.cos(0.2), np.sin(0.2)
    rt = np.tile(np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.9]],
                          np.float32)[None], (B, 1, 1))
    return dict(rt34=rt, num_inliers=rng.integers(5, 40, B).astype(np.float32),
                num_tight=rng.integers(0, 5, B).astype(np.float32),
                num_ultra_tight=np.zeros(B, np.float32), success=np.ones(B, bool))


def _stub(est, conv):
    fields = {k: conv(v) for k, v in est.items()}
    return lambda *a, **kw: types.SimpleNamespace(**fields)


@pytest.fixture(scope="module")
def train_pair():
    """The port's Trainer (init_weights, seed 0) and the JAX model with the
    same weights (convert_loftr_state_dict), on two 64x64 synthetic pairs;
    JAX's step with optax.sgd(1.0) and the solver stubbed."""
    jcfg, tcfg = small_config(jconfig), small_config(tconfig)
    trainer = Trainer(tcfg, device="cpu").init(seed=0)
    sd = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    jmodel = JFARLoFTR(jcfg)
    tb, jb = pairs((64, 64))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_loftr_state_dict({f"matcher.{k}": v for k, v in sd.items()},
                                                 zeros, jcfg)
    assert not report["missing"] and not report["unused"], report
    tx = optax.sgd(1.0)
    state = jtrainer.create_train_state(jmodel, variables, tx)
    key = jax.random.PRNGKey(3)
    est = _fixed_estimate(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "estimate_pose", _stub(est, jnp.asarray))
    stub_state, stub_metrics = jax.jit(jtrainer.make_train_step(jmodel, tx))(state, jb, key)
    mp.undo()
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return dict(jcfg=jcfg, tcfg=tcfg, sd=sd, tb=tb, key=key, est=est,
                variables=np_tree(variables), stub=(np_tree(stub_state), np_tree(stub_metrics)))


def _port_trainer(ctx):
    trainer = Trainer(ctx["tcfg"], device="cpu")
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["sd"].items()})
    return trainer


# backbone tensors whose gradient passes the stride-2 stages: the JAX
# package's float32 gradient of them is off on the CPU (see
# test_backbone_train_grads_against_jax_float64)
_BACKBONE_STAGES = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.",
                    "backbone.layer2.", "backbone.layer3.0.")


def test_backbone_train_grads_against_jax_float64():
    """The backbone in train mode, alone, under a fixed cotangent of both
    outputs: the port's float32 gradients within 1e-5 max|ref| of the JAX
    package's backbone run in float64 (x64 on, dtype float64). The JAX
    package's own float32 gradients of the stem and of layer1 to layer3.0
    are up to 5e-2 max|ref| away from its float64 ones on the CPU (the
    later tensors within 1e-5), which is why the whole-step test holds
    those tensors to 5e-2."""
    from far_tpu.models.backbone import ResNetFPN_8_2 as JBackbone

    tcfg = small_config(tconfig)
    trainer = Trainer(tcfg, device="cpu").init(seed=0)
    sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    tb, _ = pairs((64, 64))
    imgs = np.concatenate([tb.image0.numpy(), tb.image1.numpy()])
    rng = np.random.default_rng(13)
    wc = rng.normal(size=(4, 8, 8, 32))
    wf = rng.normal(size=(4, 32, 32, 16))
    bb = trainer.model.backbone.train()
    c, f = bb(t(imgs).permute(0, 3, 1, 2))
    ((c.permute(0, 2, 3, 1) * t(wc).float()).sum()
     + (f.permute(0, 2, 3, 1) * t(wf).float()).sum()).backward()
    jcfg = small_config(jconfig)
    jmodel = JFARLoFTR(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pairs((64, 64))[1]))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, _ = convert_loftr_state_dict({f"matcher.{k}": v for k, v in sd.items()},
                                            zeros, jcfg)
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jbb = JBackbone(initial_dim=16, block_dims=(16, 24, 32), dtype=jnp.float64)
        stats = f64(variables["batch_stats"]["backbone"])

        def loss(params):
            (cc, ff), _ = jbb.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(imgs, jnp.float64), True,
                                    mutable=["batch_stats"])
            return jnp.sum(cc * wc) + jnp.sum(ff * wf)

        grads = jax.tree.map(np.asarray,
                             jax.jit(jax.grad(loss))(f64(variables["params"]["backbone"])))
    finally:
        jax.config.update("jax_enable_x64", False)
    params = dict(jax.tree.map(np.zeros_like, variables["params"]), backbone=grads)
    ref = flax_to_state_dict({"params": params, "batch_stats": variables["batch_stats"]}, tcfg)
    for name, p in bb.named_parameters():
        rel_close(p.grad, ref["backbone." + name], 1e-5, name)


def test_train_step_matches_jax(train_pair, monkeypatch):
    """One step with the solver stubbed to the same fixed estimate in both
    packages and SGD(lr=1): the losses and grad_norm within 1e-4
    relative, every parameter's delta (= -grad) within 1e-4 max|ref| of
    the tensor plus one rounding of max|p| (SGD's p - g is rounded to p's
    ulp in both packages), the BatchNorm running statistics within 1e-5.
    The backbone's stem, layer1, layer2 and layer3.0 are held to 5e-2
    max|ref|, the size of the JAX package's own float32 error there (the
    float64 test above holds the port's to 1e-5)."""
    ctx = train_pair
    trainer = _port_trainer(ctx)
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=1.0)
    monkeypatch.setattr(ttrainer, "estimate_pose", _stub(ctx["est"], t))
    metrics = trainer.step(ctx["tb"])
    jstate, jmetrics = ctx["stub"]
    assert metrics["num_matches"] == float(jmetrics["num_matches"]) >= 2
    assert metrics["loss_f"] > 0 and metrics["loss_c"] > 0 and metrics["loss_rot"] > 0
    for k, v in metrics.items():
        rel_close(np.float64(v), np.float64(jmetrics[k]), 1e-4, k)
    delta = jax.tree.map(lambda a, b: a - b, jstate.params, ctx["variables"]["params"])
    ref_delta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats},
                                   ctx["tcfg"])
    new_sd = trainer.model.state_dict()
    n_moved = 0
    for name, p in trainer.model.named_parameters():
        d = (p.detach() - torch.from_numpy(ctx["sd"][name])).numpy()
        ref = ref_delta[name]
        ulp = 2.0 ** -23 * float(np.abs(ctx["sd"][name]).max())
        rel = 5e-2 if name.startswith(_BACKBONE_STAGES) else 1e-4
        atol = rel * float(np.abs(ref).max()) + ulp
        np.testing.assert_allclose(d, ref, rtol=0, atol=atol, err_msg=name)
        n_moved += bool(np.abs(ref).max() > 0)
    assert n_moved > 0.9 * len(list(trainer.model.parameters()))
    stats = flax_to_state_dict({"params": ctx["variables"]["params"],
                                "batch_stats": jstate.batch_stats}, ctx["tcfg"])
    for name in new_sd:
        if name.endswith(("running_mean", "running_var")):
            rel_close(new_sd[name], stats[name], 1e-5, name)


def test_train_step_real_solver(train_pair):
    """The same step with the real solver, JAX's sampler draws (split as
    the JAX trainer splits its key) and JAX's prior cloud, and the default
    optimizer (AdamW, warm-up): every metric finite, and loss_c, loss_f
    and num_matches within 1e-4 relative of JAX's step (they do not
    depend on the solver, so JAX's stubbed step gives them)."""
    ctx = train_pair
    trainer = _port_trainer(ctx)
    tcfg = ctx["tcfg"]
    from far_tpu.solvers.pose_estimation import default_prior_pcl
    from far_tpu_torch.pipeline import make_solver_configs

    first, refine = make_solver_configs(tcfg)
    k0, k1 = jax.random.split(ctx["key"])
    keys = jax.random.split(k1, tcfg.solver.fine_pred_steps - 1)
    uniforms = [jax.random.uniform(k0, (2, *first.ransac_config(False).sampling()[:2]))]
    uniforms += [jax.random.uniform(k, (2, *refine.ransac_config(True).sampling()[:2]))
                 for k in keys]
    metrics = trainer.step(ctx["tb"], uniforms=[t(u) for u in uniforms],
                           prior_pcl=t(default_prior_pcl()))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    for k in ("loss_c", "loss_f", "num_matches"):
        rel_close(np.float64(metrics[k]), np.float64(ctx["stub"][1][k]), 1e-4, k)
    assert trainer.optimizer.count == 1 and trainer.step_count == 1


# ---- checkpoints, curriculum, the device rule -----------------------------


def test_checkpoint_round_trip(tmp_path):
    """Two steps, save, restore into a fresh trainer: the same parameters,
    optimizer state and step, and the next step gives the same metrics."""
    tb, _ = pairs((64, 64))
    cfg = small_config(tconfig)
    optim = toptim.OptimConfig(warmup_steps=2)
    a = Trainer(cfg, optim, device="cpu").init(seed=1)
    gen = lambda: torch.Generator().manual_seed(5)
    for _ in range(2):
        a.step(tb, generator=gen())
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    mgr.save(a.step_count, a.state_dict(), {"loss": 1.0})
    b = Trainer(cfg, optim, device="cpu")
    b.load_state_dict(tckpt.CheckpointManager(tmp_path / "ckpt").restore())
    assert b.step_count == 2 and b.optimizer.count == a.optimizer.count
    for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), n
    ma, mb = a.step(tb, generator=gen()), b.step(tb, generator=gen())
    assert ma == mb


def test_checkpoint_retention_matches_orbax(tmp_path):
    """Which steps survive five saves at max_to_keep=2: the latest two, or
    the best two by a metric in either mode, as the JAX package's orbax
    manager keeps them."""
    for best in (None, "loss"):
        for mode in ("min", "max"):
            ours = tckpt.CheckpointManager(tmp_path / f"t{best}{mode}", 2, best, mode)
            ref = jckpt.CheckpointManager(tmp_path / f"j{best}{mode}", 2, best, mode)
            for step, loss in ((1, 5.0), (2, 1.0), (3, 3.0), (4, 2.0), (5, 4.0)):
                ours.save(step, {"x": torch.full((2,), float(step))}, {"loss": loss})
                ref.save(step, {"x": np.full((2,), step, np.float32)}, {"loss": loss})
            assert ours.all_steps() == list(ref._mgr.all_steps()), (best, mode)
            assert ours.latest_step() == ref.latest_step()
            assert float(ours.restore()["x"][0]) == float(ours.latest_step())
            ref.close()


def test_surgical_load_and_curriculum():
    template = {"a": torch.ones(3, 3), "moe": torch.zeros(12, 2), "new": torch.full((4,), 7.0)}
    restored = {"a": torch.full((3, 3), 2.0), "moe": torch.ones(9, 2), "gone": torch.ones(1)}
    merged, skipped = tckpt.surgical_load(restored, template, verbose=False)
    jmerged, jskipped = jckpt.surgical_load(
        {k: v.numpy() for k, v in restored.items()},
        {k: v.numpy() for k, v in template.items()}, verbose=False)
    assert sorted(skipped) == ["moe", "new"] and len(jskipped) == 2
    for k, v in merged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmerged[k]))
    for curriculum in ("MATTERPORT_CURRICULUM", "MAPFREE_CURRICULUM"):
        ours, ref = getattr(tckpt, curriculum), getattr(jckpt, curriculum)
        assert [dataclasses.asdict(p) for p in ours] == [dataclasses.asdict(p) for p in ref]
        for p, r in zip(ours, ref):
            assert dataclasses.asdict(tckpt.apply_phase(tconfig.FARConfig(), p)) == \
                dataclasses.asdict(jckpt.apply_phase(jconfig.FARConfig(), r))


def test_trainer_needs_a_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = small_config(tconfig)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    assert next(trainer.model.parameters()).device.type == "cpu"
    assert trainer.model.training
