"""far_tpu_torch's ViTEss, vitess_forward and golden helpers against far_tpu.

The full-width port replays tests/golden/vitess_seed0.npz with the gates
of tests/test_golden_parity.py. At small widths (dim 48, depth 3, 3
heads, fc_hidden 64, 96x96 images so that the nearest resize to 224
runs) one synthesized state dict feeds both packages: JAX through
far_tpu.utils.convert_weights.convert_vitess_state_dict, the port through
its own flax_to_state_dict; each module then gets the same inputs and
is held to 1e-4 * max|ref| in float32. vitess_forward is held to JAX's on
a rigid scene's correspondences with JAX's sampler draws.
"""

import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu import pipeline as jpipeline
from far_tpu.geometry.rotations import ortho6d_to_matrix_rc as jortho6d_rc
from far_tpu.models import regressor as jregressor
from far_tpu.models import vitess as jvitess
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.types import MatcherOutput as JMatcherOutput
from far_tpu.types import MatchResult as JMatchResult
from far_tpu.types import PairBatch as JPairBatch
from far_tpu.utils import config as jconfig
from far_tpu.utils import parity as jparity
from far_tpu.utils.convert_weights import convert_vitess_state_dict
from far_tpu_torch import pipeline as tpipeline
from far_tpu_torch.geometry.rotations import ortho6d_to_matrix_rc
from far_tpu_torch.models import regressor as tregressor
from far_tpu_torch.models import vitess as tvitess
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.solvers.pose_estimation import SolverConfig
from far_tpu_torch.types import MatcherOutput, MatchResult, PairBatch
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils import parity as tparity
from far_tpu_torch.utils.convert_weights import (
    flax_to_state_dict,
    init_weights,
    load_reference_state_dict,
)
from test_torch_modules import small_config
from test_torch_pipeline import _scene_matches

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "golden"
SMALL = dict(dim=48, depth=3, num_heads=3, fc_hidden=64, dtype="float32")


def t(a):
    return torch.from_numpy(np.array(a))


def close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))


def zeros_init(init_fn):
    shapes = jax.eval_shape(init_fn)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def vitess_pair(seed=0, **over):
    """(JAX model, its variables, the port model, the synthesized state
    dict): the port's spec marks ``norm3`` as the alias of
    ``downsample.1``, as the reference's state dict holds it."""
    kw = {**SMALL, **over}
    tcfg, jcfg = tvitess.ViTEssConfig(**kw), jvitess.ViTEssConfig(**kw)
    port = tvitess.ViTEss(tcfg).eval()
    spec = tparity.sd_spec_of({k: v.numpy() for k, v in port.state_dict().items()})
    for k in spec:
        if ".norm3." in k:
            spec[k]["alias_of"] = k.replace(".norm3.", ".downsample.1.")
    sd = tparity.synth_state_dict(spec, seed=seed)
    jmodel = jvitess.ViTEss(jcfg)
    images = jnp.zeros((1, 2, 224, 224, 3))
    sp, nc = jnp.eye(3, 4)[None], jnp.zeros((1,))
    variables, report = convert_vitess_state_dict(
        sd, zeros_init(lambda: jmodel.init(jax.random.PRNGKey(0), images, sp, nc)), jcfg)
    assert not report["missing"] and not report["unused"], report
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          flax_to_state_dict(variables, tcfg).items()}, strict=True)
    return jmodel, variables, port, sd


@pytest.fixture(scope="module")
def gated():
    return vitess_pair(use_loftr_gating=True)


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables.get("batch_stats", {}):
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _images(seed, B=2, hw=(96, 96)):
    return np.random.default_rng(seed).random((B, 2, *hw, 3)).astype(np.float32)


def _solver_inputs(B=2):
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(B, 3, 3)))
    R = q * np.sign(np.linalg.det(q))[:, None, None]
    rt = np.concatenate([R, rng.normal(size=(B, 3, 1))], -1).astype(np.float32)
    return rt, np.array([37.0, 5.0][:B], np.float32)


def test_config_copies_agree():
    assert dataclasses.asdict(tvitess.ViTEssConfig()) == \
        dataclasses.asdict(jvitess.ViTEssConfig())
    assert tvitess.VITESS_POSE_STATS.keys() == jvitess.VITESS_POSE_STATS.keys()
    for k, (m, s) in jvitess.VITESS_POSE_STATS.items():
        assert np.array_equal(tvitess.VITESS_POSE_STATS[k][0], m)
        assert np.array_equal(tvitess.VITESS_POSE_STATS[k][1], s)


@pytest.mark.parametrize("fixture", ["farloftr_seed0.npz", "vitess_seed0.npz",
                                     "sixdreg_seed0.npz"])
def test_parity_helpers_equal_jax(fixture):
    """The port's load_fixture, sd_spec_of and synth_state_dict give the
    JAX package's arrays bit for bit."""
    path = GOLDEN / fixture
    meta, inputs, sd, taps = tparity.load_fixture(path)
    jmeta, jinputs, jsd, jtaps = jparity.load_fixture(str(path))
    assert meta == jmeta and not sd and not jsd
    for ours, ref in ((inputs, jinputs), (taps, jtaps)):
        assert ours.keys() == ref.keys()
        assert all(np.array_equal(ours[k], ref[k]) for k in ref)
    spec = meta["sd_spec"]
    ours = tparity.synth_state_dict(spec, seed=meta["sd_seed"])
    ref = jparity.synth_state_dict(spec, seed=meta["sd_seed"])
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    assert tparity.sd_spec_of(ours) == jparity.sd_spec_of(ref)


def _hooked(model, names):
    got = {}
    mods = dict(model.named_modules())
    for tap, mod in names.items():
        mods[mod].register_forward_hook(
            lambda m, a, o, tap=tap: got.setdefault(tap, []).append(o))
    return got


def test_golden_replay():
    """The full-width port (f32) against the fixture's taps, each gated at
    max(1e-3, the tap's floor, 1e-3 max|tap|); the reference checkpoint's
    keys load through load_reference_state_dict (``module.`` stripped,
    trunk layer3/layer4 dropped)."""
    meta, inputs, _, taps = tparity.load_fixture(GOLDEN / "vitess_seed0.npz")
    sd = tparity.synth_state_dict(meta["sd_spec"], seed=meta["sd_seed"])
    assert any(k.startswith("module.resnet.layer4.") for k in sd)
    port = tvitess.ViTEss(tvitess.ViTEssConfig(use_loftr_gating=True,
                                               dtype="float32")).eval()
    load_reference_state_dict(port, sd)
    got = _hooked(port, {"resnet": "resnet", "extractor": "extractor_final_conv",
                         "features": "fusion_transformer"})
    # reference input (B, 2, 3, H, W) BGR in [0, 255] -> RGB [0, 1] NHWC
    im = inputs["images"][:, :, ::-1].transpose(0, 1, 3, 4, 2) / 255.0
    with torch.inference_mode():
        tran, R, p9, _ = port(torch.from_numpy(np.ascontiguousarray(im, np.float32)),
                              t(inputs["solver_pose"]), t(inputs["solver_num_corr"]))
    ours = {"resnet": got["resnet"][0], "extractor": got["extractor"][0],
            "features": got["features"][0], "pred_t": tran, "pred_rmtx": R,
            "pred_r6": p9[..., 3:]}
    assert set(taps) == set(ours)
    bad = {}
    for name, tap in taps.items():
        ref = np.asarray(tap, np.float32)
        err = float(np.abs(ours[name].float().numpy().reshape(ref.shape) - ref).max())
        if not err <= tparity.tap_tolerance("vitess", name, ref):
            bad[name] = err
    assert not bad, bad


def test_state_dict_round_trip():
    """flax_to_state_dict inverts JAX's convert_vitess_state_dict on the
    golden fixture's full-width state dict (the port's keys: prefix
    stripped, trunk layer3/layer4 dropped)."""
    meta, *_ = tparity.load_fixture(GOLDEN / "vitess_seed0.npz")
    sd = tparity.synth_state_dict(meta["sd_spec"], seed=meta["sd_seed"])
    cfg = dict(use_loftr_gating=True, dtype="float32")
    jmodel = jvitess.ViTEss(jvitess.ViTEssConfig(**cfg))
    variables, report = convert_vitess_state_dict(sd, zeros_init(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 224, 224, 3)),
                            jnp.eye(3, 4)[None], jnp.zeros((1,)))),
        jvitess.ViTEssConfig(**cfg))
    assert not report["missing"] and not report["unused"], report
    back = flax_to_state_dict(variables, tvitess.ViTEssConfig(**cfg))
    want = {k[len("module."):]: v for k, v in sd.items()
            if not k.startswith(("module.resnet.layer3.", "module.resnet.layer4."))}
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_ortho6d_rc_matches_jax():
    d6 = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    close(ortho6d_to_matrix_rc(t(d6)), jortho6d_rc(jnp.asarray(d6)))


def test_trunk_and_raft_block(gated):
    jmodel, variables, port, _ = gated
    x = np.random.default_rng(1).normal(size=(2, 224, 224, 3)).astype(np.float32)
    ref = jax.jit(jvitess.ResNet18Trunk().apply)(_sub(variables, "resnet"), jnp.asarray(x))
    nchw = lambda a: t(a).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        out = port.resnet(nchw(x))
    close(out.permute(0, 2, 3, 1), ref)
    y = np.random.default_rng(2).normal(size=(2, 28, 28, 128)).astype(np.float32)
    ref = jax.jit(jvitess.RaftResidualBlock(48, 5).apply)(
        _sub(variables, "extractor_final_conv"), jnp.asarray(y))
    with torch.inference_mode():
        out = port.extractor_final_conv(nchw(y))
    assert out.shape[-2:] == (24, 24)
    close(out.permute(0, 2, 3, 1), ref)


def test_vit_self_block(gated):
    jmodel, variables, port, _ = gated
    x = np.random.default_rng(3).normal(size=(2, 576, 48)).astype(np.float32)
    ref = jax.jit(jvitess.ViTSelfBlock(48, 3).apply)(_sub(variables, "block_1"),
                                                     jnp.asarray(x))
    with torch.inference_mode():
        close(port.fusion_transformer.blocks[1](t(x)), ref)


def test_cross_block_of_vitess(gated):
    """ViTEss's CrossBlock: LayerNorm eps 1e-6 and the basis
    [x^2, y^2, xy, x, y, 1], against JAX's CrossBlockEMM(basis_xy_first=True,
    ln_eps=1e-6); K4 runs at 576 tokens with head width 16."""
    jmodel, variables, port, _ = gated
    blk = port.fusion_transformer.blocks[-1]
    assert blk.norm1.eps == 1e-6 and blk.cross_attn.basis_xy_first
    rng = np.random.default_rng(4)
    f0, f1 = (rng.normal(size=(2, 576, 48)).astype(np.float32) for _ in range(2))
    ref = jax.jit(jregressor.CrossBlockEMM(
        dim=48, num_heads=3, grid_hw=(24, 24), grid_f=(12.0, 12.0), ln_eps=1e-6,
        basis_xy_first=True).apply)(_sub(variables, "cross_block"), jnp.asarray(f0),
                                    jnp.asarray(f1))
    with torch.inference_mode():
        close(blk(t(f0), t(f1)), ref)


def _old_basis(h=60, w=80, fx=517.0 / 9.0, fy=517.0 / 8.0, cx=40.0, cy=30.0):
    """The port's basis before ``xy_first`` existed."""
    us = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    vs = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    x = np.tile(us[None, :], (h, 1)) / ((fx / (cx * 2.0)) * 2.0)
    y = np.tile(vs[:, None], (1, w)) / ((fy / (cy * 2.0)) * 2.0)
    feats = [y * y, x * x, x * y, y, x, np.ones_like(x)]
    return np.stack(feats, axis=-1).reshape(h * w, 6).astype(np.float32)


def test_farloftr_regressor_unchanged_by_the_new_fields(monkeypatch):
    """FARLoFTR's regressor under the defaults: LayerNorm eps 1e-5, and
    outputs bit-equal to the same weights run with the basis as it was
    computed before the ``xy_first`` flag."""
    cfg = small_config(tconfig)
    model = init_weights(FARLoFTR(cfg).eval(), seed=2)
    emm = model.loftr_regress.emm
    assert emm.norm1.eps == emm.norm2.eps == 1e-5 and not emm.cross_attn.basis_xy_first
    rng = np.random.default_rng(6)
    L = cfg.coarse_hw[0] * cfg.coarse_hw[1]
    f0, f1 = (t(rng.normal(size=(2, L, 32)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        now = model.regress_features(f0, f1)
        monkeypatch.setattr(tregressor, "epipolar_positional_basis",
                            lambda *a, **k: _old_basis(*a[:6]))
        before = model.regress_features(f0, f1)
    assert torch.equal(now, before)


@pytest.mark.parametrize("variant", ["gated", "ungated", "pooling"])
def test_vitess_whole(variant, gated):
    """Whole ViTEss from 96x96 images: (t, R, 9D pose, gate)."""
    if variant == "gated":
        jmodel, variables, port, _ = gated
    else:
        over = {"ungated": {}, "pooling": dict(fusion_transformer=False, pool_size=8)}
        jmodel, variables, port, _ = vitess_pair(seed=1, **over[variant])
    images = _images(7)
    rt, nc = _solver_inputs()
    args = (rt, nc) if variant == "gated" else (None, None)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(images),
                                *(None if a is None else jnp.asarray(a) for a in args))
    with torch.inference_mode():
        out = port(t(images), *(None if a is None else t(a) for a in args))
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            close(o, r)


def scene_matcher_outputs(seed, B, K, n_slots=64, n_valid=40, n_outliers=6):
    """One rigid scene's correspondences as the JAX and the port
    MatcherOutput: what both packages' matchers are made to return."""
    kp0, kp1, valid = _scene_matches(np.random.default_rng(seed), B, K, n_slots,
                                     n_valid, n_outliers)
    z = lambda *s: np.zeros((B, n_slots, *s), np.float32)
    ids = np.zeros((B, n_slots), np.int32)
    arrays = dict(i_ids=ids, j_ids=ids, mconf=z(), valid=valid, mkpts0=kp0, mkpts1=kp1,
                  mkpts0_f=kp0, mkpts1_f=kp1, expec_f=z(3))
    feat = np.zeros((B, 1, 8), np.float32)
    jout = JMatcherOutput(
        matches=JMatchResult(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        feat_c0=jnp.asarray(feat), feat_c1=jnp.asarray(feat))
    arrays.update(i_ids=ids.astype(np.int64), j_ids=ids.astype(np.int64))
    tout = MatcherOutput(matches=MatchResult(**{k: t(v) for k, v in arrays.items()}),
                         feat_c0=t(feat), feat_c1=t(feat))
    return jout, tout


def patch_matchers(monkeypatch, jout, tout, record):
    """JAX's pipeline calls FARLoFTR.match by name: it gets ``jout``; the
    port's matcher is any object with ``match``. Both packages' solver
    estimates go to ``record``."""
    monkeypatch.setattr(jpipeline, "FARLoFTR", types.SimpleNamespace(
        match=lambda module, batch, train=False: jout))
    for mod, key in ((jpipeline, "jax"), (tpipeline, "port")):
        def rec(*a, _f=mod.estimate_pose, _k=key, **kw):
            est = _f(*a, **kw)
            record.setdefault(_k, []).append(est)
            return est
        monkeypatch.setattr(mod, "estimate_pose", rec)
    return JFARLoFTR(jconfig.FARConfig()), types.SimpleNamespace(match=lambda batch: tout)


def scene_batches(B, K, hw=(64, 64)):
    Kb = np.tile(K[None], (B, 1, 1))
    img = np.zeros((B, *hw, 1), np.float32)
    jb = JPairBatch(image0=jnp.asarray(img), image1=jnp.asarray(img),
                    K0=jnp.asarray(Kb), K1=jnp.asarray(Kb))
    tb = PairBatch(image0=t(img), image1=t(img), K0=t(Kb), K1=t(Kb))
    return jb, tb


@pytest.mark.parametrize("with_matcher", [True, False])
def test_vitess_forward_matches_jax(with_matcher, gated, monkeypatch):
    """With a matcher: both matchers return one rigid scene's matches, the
    port gets the draws JAX takes from the key (far_tpu/pipeline.py:218),
    num_inliers equal and (t, R, 9D pose, gate) within 1e-3. Without:
    the ungated model on the images alone."""
    B = 2
    # f = 2000 px: the scene's 0.1 px noise makes no borderline inlier
    K = np.array([[2000.0, 0, 320], [0, 2000.0, 240], [0, 0, 1]], np.float32)
    images = _images(8)
    if not with_matcher:
        jmodel, variables, port, _ = vitess_pair(seed=1)
        ref = jax.jit(lambda im: jpipeline.vitess_forward(jmodel, variables, im))(
            jnp.asarray(images))
        with torch.inference_mode():
            out = tpipeline.vitess_forward(port, t(images))
        assert out[3] is None and ref[3] is None
        for o, r in zip(out[:3], ref[:3]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)
        return
    jmodel, variables, port, _ = gated
    jout, tout = scene_matcher_outputs(9, B, K)
    record = {}
    jmatcher, tmatcher = patch_matchers(monkeypatch, jout, tout, record)
    jb, tb = scene_batches(B, K)
    key = jax.random.PRNGKey(4)
    ref, jinl = jax.jit(lambda im, k: (
        jpipeline.vitess_forward(jmodel, variables, im, jmatcher, {}, jb, k),
        record["jax"][-1].num_inliers))(jnp.asarray(images), key)
    n = SolverConfig(solver="prior_ransac_noprior").ransac_config(False).sampling()[:2]
    u = t(jax.random.uniform(key, (B, *n)))
    with torch.inference_mode():
        out = tpipeline.vitess_forward(port, t(images), tmatcher, tb, uniforms=u)
    assert (np.asarray(jinl) >= 25).all()
    np.testing.assert_array_equal(record["port"][0].num_inliers.numpy(), np.asarray(jinl))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)


def test_eval_batchnorm_bf16_matches_flax():
    """The port's eval BatchNorm on bf16 maps keeps the float32 statistics
    and affine, normalises in float32 and rounds once, as Flax's
    BatchNorm(dtype=bfloat16) does: bit-equal outputs, where casting the
    statistics and affine to bf16 first (the port's earlier form) is not."""
    import flax.linen as fnn

    from far_tpu_torch.models.backbone import bn

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 5, 8)).astype(np.float32)).astype(jnp.bfloat16)
    mean, scale, bias = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    var = (rng.random(8) + 0.5).astype(np.float32)
    ref = fnn.BatchNorm(use_running_average=True, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, x)
    m = torch.nn.BatchNorm2d(8).eval()
    with torch.no_grad():
        for buf, v in ((m.running_mean, mean), (m.running_var, var), (m.weight, scale),
                       (m.bias, bias)):
            buf.copy_(t(v))
    xt = t(x.astype(jnp.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.inference_mode():
        out = bn(xt, m)
    assert out.dtype == torch.bfloat16
    want = t(ref.astype(jnp.float32))
    assert torch.equal(out.permute(0, 2, 3, 1).float(), want)
    cast = torch.nn.functional.batch_norm(
        xt, *(v.to(torch.bfloat16) for v in (m.running_mean, m.running_var, m.weight,
                                              m.bias)), False, 0.0, m.eps)
    assert not torch.equal(cast.permute(0, 2, 3, 1).float(), want)
