"""far_tpu_torch's 6DReg variants and geometry helpers against far_tpu's.

The aggregators no configuration of the repo runs (the QKV projection,
with and without its residual, and the plain concatenation), the heads
(``DeepResBlockHead`` with ``full_forward_pass``, ``ProcrustesHead``,
``AngularBinsHead``, ``QuaternionHead``) and ``MapfreeRegression`` under
each non-default aggregator flag and at ``d_im=128`` take the JAX
package's variables (its init, BatchNorm statistics drawn from a numpy
seed) carried across by ``flax_to_state_dict``; inputs are numpy-seeded.
Float32 throughout. Modules: within 1e-5 * max|ref|, in eval mode and in
train mode (batch statistics; the running statistics after the step
too); the argmax bins of ``AngularBinsHead`` equal. ``MapfreeRegression``:
within 1e-4 * max|ref|, ``test_torch_sixdreg``'s bound for the whole
model. Geometry: within 1e-5 * max|ref| (triangulation in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu import geometry as jgeo
from far_tpu.geometry import transforms as jtransforms
from far_tpu.models import sixdreg as jsixdreg
from far_tpu_torch import geometry as tgeo
from far_tpu_torch.geometry import transforms as ttransforms
from far_tpu_torch.models import sixdreg as tsixdreg
from far_tpu_torch.utils.convert_weights import flax_to_state_dict
from test_torch_sixdreg import SMALL, _pair_images, sixdreg_pair
from test_torch_vitess import _solver_inputs, t

torch.set_num_threads(2)
CFG = dict(SMALL)


def close(out, ref, rel=1e-5, what=""):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_stats(variables, seed):
    """The JAX variables with BatchNorm statistics drawn from a seed, so
    that eval mode normalises by something other than (0, 1)."""
    rng = np.random.default_rng(seed)
    out = _np_tree(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.normal(size=v.shape) * 0.2 if p[-1].key == "mean"
                          else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            out["batch_stats"])
    return out


def _carry(port, variables):
    sd = flax_to_state_dict(variables, port)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                         strict=True)
    return port


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("kind", ["qkv", "qkv_residual", "qkv_no_position", "concat"])
def test_aggregator_variants_match_jax(kind):
    """B=2 volumes of 8 channels on a 12x8 map."""
    cfg_kw = dict(CFG, position_encoder=kind != "qkv_no_position")
    tcfg, jcfg = tsixdreg.SixDRegConfig(**cfg_kw), jsixdreg.SixDRegConfig(**cfg_kw)
    rng = np.random.default_rng(3)
    v0, v1 = (rng.normal(size=(2, 12, 8, 8)).astype(np.float32) for _ in range(2))
    if kind == "concat":
        jmod, port = jsixdreg.ConcatAggregator(jcfg), tsixdreg.ConcatAggregator(tcfg)
        variables = {}
    else:
        res = kind == "qkv_residual"
        jmod = jsixdreg.CorrelationVolumeWarpingQKV(jcfg, residual=res)
        port = tsixdreg.CorrelationVolumeWarpingQKV(tcfg, residual=res)
        variables = _np_tree(jmod.init(jax.random.PRNGKey(1), v0, v1))
        _carry(port, variables)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(v0), jnp.asarray(v1))
    with torch.no_grad():
        out = port(t(v0).permute(0, 3, 1, 2), t(v1).permute(0, 3, 1, 2))
    close(_nhwc(out), ref)


HEADS = {
    "deep_full": (lambda c: jsixdreg.DeepResBlockHead(c, full_forward_pass=True),
                  lambda cin: tsixdreg.DeepResBlockHead(cin, full_forward_pass=True)),
    "procrustes6": (lambda c: jsixdreg.ProcrustesHead(c, num_pts=6),
                    lambda cin: tsixdreg.ProcrustesHead(cin, num_pts=6)),
    "procrustes3": (lambda c: jsixdreg.ProcrustesHead(c, num_pts=3),
                    lambda cin: tsixdreg.ProcrustesHead(cin, num_pts=3)),
    "procrustes8_no_basis": (lambda c: jsixdreg.ProcrustesHead(c, num_pts=8, add_basis=False),
                             lambda cin: tsixdreg.ProcrustesHead(cin, num_pts=8,
                                                                 add_basis=False)),
    "angular": (lambda c: jsixdreg.AngularBinsHead(c),
                lambda cin: tsixdreg.AngularBinsHead(cin)),
    "angular_raw_t": (lambda c: jsixdreg.AngularBinsHead(c, separate_scale=False),
                      lambda cin: tsixdreg.AngularBinsHead(cin, separate_scale=False)),
    "quaternion": (lambda c: jsixdreg.QuaternionHead(c),
                   lambda cin: tsixdreg.QuaternionHead(cin)),
    "quaternion_raw_t": (lambda c: jsixdreg.QuaternionHead(c, separate_scale=False),
                         lambda cin: tsixdreg.QuaternionHead(cin, separate_scale=False)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(HEADS))
def test_heads_match_jax(kind, train):
    """A (2, 19, 64, 48) gvol-like input (the aggregator's 2 D + 3 channels
    at D = 8; resblock4's train-mode BatchNorm then averages 24 values a
    channel, where fewer amplify float32 rounding past the bound): every
    output; in train mode the running statistics too."""
    make_j, make_t = HEADS[kind]
    jmod, port = make_j(jsixdreg.SixDRegConfig(**CFG)), make_t(19)
    x = np.random.default_rng(4).normal(size=(2, 64, 48, 19)).astype(np.float32)
    variables = _random_stats(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    _carry(port, variables).train(train)
    if train:
        ref, new = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(t(x).permute(0, 3, 1, 2))
    if kind == "deep_full":
        pose, feats = out
        close(pose, ref[0], what="pose")
        close(_nhwc(feats), ref[1], what="features")
    else:
        for i, (o, r) in enumerate(zip(out, ref)):
            close(o, r, what=f"output {i}")
    if kind.startswith("angular"):
        np.testing.assert_array_equal(out[2][:, :360].argmax(-1).numpy(),
                                      np.asarray(ref[2][:, :360]).argmax(-1))
    if train:
        sd = flax_to_state_dict(_np_tree({"params": variables["params"], **new}), port)
        for k, v in port.state_dict().items():
            if "running" in k:
                close(v, sd[k], what=k)


@pytest.mark.parametrize("over", [dict(position_encoder=False), dict(position_encoder_im1=True),
                                  dict(max_score_channel=False), dict(normalise_dot=True),
                                  dict(cv_half_channels=True), dict(d_im=128)],
                         ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_mapfree_regression_flags_match_jax(over):
    """The whole regressor (R, t, 9D pose, gate) with one flag off its
    default: the head's input channels follow the aggregator's flags, and
    d_im=128 changes nothing (JAX's layers and the port's take the head's
    256 channels)."""
    jmodel, variables, port, _ = sixdreg_pair(seed=3, **over)
    cin = port.head.resblock1.conv1.weight.shape[1]
    assert cin == tsixdreg.CorrelationVolumeWarping.channels(port.config)
    im0, im1 = _pair_images(6)
    rt, _ = _solver_inputs()
    counts = np.array([[40.0, 12.0, 3.0], [7.0, 2.0, 0.0]], np.float32)
    ref = jax.jit(jmodel.apply)(variables, *(jnp.asarray(a) for a in (im0, im1, rt, counts)))
    with torch.inference_mode():
        out = port(t(im0), t(im1), t(rt), t(counts))
    for o, r in zip(out, ref):
        close(o, r, rel=1e-4)


def _poses(rng, n):
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
    R *= np.linalg.det(R)[:, None, None]          # proper rotations
    return R.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def _procrustes_inputs(reflect):
    rng = np.random.default_rng(11)
    A = rng.normal(size=(4, 10, 3)).astype(np.float32)
    R, tt = _poses(rng, 4)
    B = np.einsum("bij,bnj->bni", R, A) + tt[:, None] + 0.01 * rng.normal(size=A.shape)
    if reflect:   # a mirror image: the best proper rotation needs the det fix-up
        B = B * np.array([1.0, 1.0, -1.0])
    w = rng.uniform(0.2, 1.0, size=(4, 10))
    return [a.astype(np.float32) for a in (A, B, w)]


def _geometry_cases():
    rng = np.random.default_rng(12)
    R, tt = _poses(rng, 5)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    T34 = np.concatenate([R, tt[..., None]], -1)
    X = (rng.normal(size=(5, 16, 3)) + [0, 0, 6]).astype(np.float32)
    P1 = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (5, 3, 4)).copy()
    x1 = X[..., :2] / X[..., 2:]
    Xc = np.einsum("bij,bnj->bni", R, X) + tt[:, None]
    x2 = Xc[..., :2] / Xc[..., 2:]
    H = rng.normal(size=(5, 3, 3)).astype(np.float32)
    pts = rng.normal(size=(5, 16, 2)).astype(np.float32)
    return {
        "procrustes": ("solvers", _procrustes_inputs(False)),
        "procrustes_reflection": ("solvers", _procrustes_inputs(True)[:2]),
        "triangulate_points": ("solvers", [P1, T34, x1, x2]),
        "essential_from_Rt": ("epipolar", [R, tt]),
        "fundamental_from_essential": ("epipolar", [H, K, K * 1.1]),
        "essential_from_fundamental": ("epipolar", [H, K, K * 1.1]),
        "from_homogeneous": ("transforms", [np.concatenate(
            [pts, np.array([1e-9, -1e-9, 0.5, -2.0])[rng.integers(0, 4, (5, 16, 1))]], -1)
            .astype(np.float32)]),
        "transform_points": ("transforms", [H, pts]),
        "transform_points_affine": ("transforms", [H[:, :2], pts]),
        "compose_pose34": ("transforms", [R, tt]),
        "pose34_to_44": ("transforms", [T34]),
        "invert_pose34": ("transforms", [T34]),
        "apply_pose34": ("transforms", [T34, X]),
    }


@pytest.mark.parametrize("name", sorted(_geometry_cases()))
def test_geometry_helpers_match_jax(name):
    """Batched float32 inputs; procrustes also on a mirrored point set,
    where its R must stay a rotation (det +1). triangulate_points runs in
    float64 in both packages (JAX under x64): the eigenvector of A^T A in
    float32 is ~3e-3 relative from float64's in either package, which
    says nothing of the port."""
    _, args = _geometry_cases()[name]
    fn = name.split("_reflection")[0].split("_affine")[0]
    jfn = getattr(jgeo, fn, None) or getattr(jtransforms, fn)
    tfn = getattr(tgeo, fn, None) or getattr(ttransforms, fn)
    x64 = fn == "triangulate_points"
    if x64:
        args = [a.astype(np.float64) for a in args]
    jax.config.update("jax_enable_x64", x64)
    try:
        ref = jax.tree.map(np.asarray, jfn(*(jnp.asarray(a) for a in args)))
    finally:
        jax.config.update("jax_enable_x64", False)
    if x64:
        assert ref.dtype == np.float64
    out = tfn(*(t(a) for a in args))
    for o, r in zip(*((out, ref) if isinstance(ref, tuple) else ((out,), (ref,)))):
        close(o, r, what=name)
    if fn == "procrustes":
        np.testing.assert_allclose(torch.linalg.det(out[0]).numpy(), 1.0, atol=1e-5)
