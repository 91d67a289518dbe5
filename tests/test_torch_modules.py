"""far_tpu_torch modules against the JAX modules at a small config.

One synthesized reference state dict (far_tpu.utils.parity.
synth_state_dict) feeds both packages: the JAX package through
far_tpu.utils.convert_weights.convert_loftr_state_dict, the port through
its own flax_to_state_dict and load_state_dict(strict=True). Every
module then gets the JAX pipeline's own intermediates as inputs, so each
comparison isolates one module. Tolerance: float32, atol =
1e-4 * max|ref|; discrete outputs (ids, validity) must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu.models import matching as jmatching
from far_tpu.models.fine import fine_coords_to_kpts as jfine_coords_to_kpts
from far_tpu.models.fine import fine_softargmax as jfine_softargmax
from far_tpu.models.fine import gather_windows as jgather
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.models.position import add_sine_position_encoding as jpe
from far_tpu.ops.fine_layer import fine_transformer_auto
from far_tpu.types import PairBatch as JPairBatch
from far_tpu.types import SolverSummary as JSummary
from far_tpu.utils import config as jconfig
from far_tpu.utils.convert_weights import convert_loftr_state_dict
from far_tpu.utils.parity import synth_state_dict
from far_tpu_torch.models import matching as tmatching
from far_tpu_torch.models.fine import (
    fine_coords_to_kpts,
    fine_matching,
    fine_softargmax,
    gather_windows,
    gather_windows_pointwise,
)
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.position import add_sine_position_encoding
from far_tpu_torch.types import PairBatch, SolverSummary
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import flax_to_state_dict

torch.set_num_threads(2)


def small_config(mod, **over):
    """The small configuration of .claude/skills/verify/SKILL.md, built
    from either package's config module."""
    kw = dict(
        image_size=(64, 64),
        backbone=mod.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=mod.AttentionStackConfig(d_model=32, nhead=4),
        match=mod.MatchConfig(max_matches=32, thr=0.0),
        fine=mod.FineConfig(d_model=16, nhead=4),
        regress=mod.RegressConfig(d_model=32, emm_heads=4, hidden=64),
        solver=mod.SolverOptions(num_hypotheses=64, minimal_solver="8pt"),
        dtype="float32",
    )
    kw.update(over)
    return mod.FARConfig(**kw)


def build_pair(jcfg, tcfg, seed: int = 0):
    """(JAX model, JAX variables, port model, synthesized state dict)."""
    port = FARLoFTR(tcfg).eval()
    spec = {f"matcher.{k}": {"shape": list(v.shape),
                             "dtype": str(v.numpy().dtype)}
            for k, v in port.state_dict().items()}
    sd = synth_state_dict(spec, seed=seed)
    H, W = jcfg.image_size
    jb = JPairBatch(image0=jnp.zeros((1, H, W, 1)), image1=jnp.zeros((1, H, W, 1)),
                    K0=jnp.eye(3)[None], K1=jnp.eye(3)[None])
    jmodel = JFARLoFTR(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_loftr_state_dict(sd, zeros, jcfg)
    assert not report["missing"] and not report["unused"], report
    port_sd = flax_to_state_dict(variables, tcfg)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in port_sd.items()},
                         strict=True)
    return jmodel, variables, port, sd, port_sd


def smooth_images(rng, B, H, W, shift=(8, 8)):
    low = rng.random((B, H // 8 + 2, W // 8 + 2)).astype(np.float32)
    t = torch.nn.functional.interpolate(
        torch.from_numpy(low)[:, None], size=(H + shift[0], W + shift[1]),
        mode="bilinear", align_corners=True)[:, 0].numpy()
    im0 = t[:, :H, :W, None]
    im1 = t[:, shift[0]:, shift[1]:, None]
    return np.ascontiguousarray(im0), np.ascontiguousarray(im1)


@pytest.fixture(scope="module")
def ctx():
    jcfg, tcfg = small_config(jconfig), small_config(tconfig)
    jmodel, variables, port, sd, port_sd = build_pair(jcfg, tcfg)
    rng = np.random.default_rng(0)
    im0, im1 = smooth_images(rng, 2, 64, 64)
    K = np.tile(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    summary = dict(rt=np.tile(np.eye(3, 4, dtype=np.float32)[None], (2, 1, 1)),
                   num_before=np.array([20.0, 9.0], np.float32),
                   num_after=np.array([12.0, 5.0], np.float32),
                   num_tight=np.array([4.0, 2.0], np.float32),
                   num_ultra_tight=np.array([1.0, 0.0], np.float32),
                   success=np.array([True, True]))
    hc, wc = jcfg.coarse_hw

    def stages(m, batch, jsum):
        B = batch.image0.shape[0]
        imgs = jnp.concatenate([batch.image0, batch.image1], axis=0)
        feat_c, feat_f = m.backbone(imgs, False)
        t0 = jpe(feat_c[:B], True).reshape(B, hc * wc, -1)
        t1 = jpe(feat_c[B:], True).reshape(B, hc * wc, -1)
        c0, c1 = m.loftr_coarse(t0, t1)
        ids = jmatching.coarse_match(c0, c1, (hc, wc), (hc, wc), 8.0, jcfg.match)
        f0w, f1w = m.fine_preprocess(feat_f[:B], feat_f[B:], c0, c1, ids[0],
                                     ids[1], (hc, wc), stride=4)
        f0t, f1t = m.fine_matching.transform(f0w, f1w)
        expec_f = m.fine_matching(f0w, f1w)
        feats = m.regress_features(c0, c1)
        pose, gate, _ = m.regress_fuse(feats, jsum)
        out = m.match(batch)
        return dict(feat_c=feat_c, feat_f=feat_f, t0=t0, t1=t1, c0=c0, c1=c1,
                    ids=ids, f0w=f0w, f1w=f1w, f0t=f0t, f1t=f1t,
                    expec_f=expec_f, feats=feats, pose=pose,
                    gate=gate, match=out.matches)

    jb = JPairBatch(image0=jnp.asarray(im0), image1=jnp.asarray(im1),
                    K0=jnp.asarray(K), K1=jnp.asarray(K))
    js = JSummary(**{k: jnp.asarray(v) for k, v in summary.items()})
    ref = jax.jit(functools.partial(jmodel.apply, method=stages))(variables, jb, js)
    ref = jax.tree.map(np.asarray, ref)
    tb = PairBatch(image0=torch.from_numpy(im0), image1=torch.from_numpy(im1),
                   K0=torch.from_numpy(K), K1=torch.from_numpy(K))
    ts = SolverSummary(**{k: torch.from_numpy(v) for k, v in summary.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, port=port, sd=sd, port_sd=port_sd,
                ref=ref, tb=tb, ts=ts, variables=variables)


def t(a):
    return torch.from_numpy(np.array(a))


def close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    if ref.size == 0:
        return
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_state_dict_round_trip(ctx):
    """flax_to_state_dict inverts convert_loftr_state_dict exactly."""
    sd = {k[len("matcher."):]: v for k, v in ctx["sd"].items()}
    assert set(sd) == set(ctx["port_sd"])
    for k, v in sd.items():
        np.testing.assert_array_equal(ctx["port_sd"][k], v, err_msg=k)
        assert ctx["port_sd"][k].shape == v.shape


def test_backbone(ctx):
    r = ctx["ref"]
    imgs = torch.cat([ctx["tb"].image0, ctx["tb"].image1]).permute(0, 3, 1, 2)
    with torch.no_grad():
        fc, ff = ctx["port"].backbone(imgs)
    close(fc.permute(0, 2, 3, 1), r["feat_c"])
    close(ff.permute(0, 2, 3, 1), r["feat_f"])


@pytest.mark.parametrize("fix", [True, False])
def test_position_encoding(fix):
    x = np.random.default_rng(1).standard_normal((2, 6, 10, 32)).astype(np.float32)
    close(add_sine_position_encoding(t(x), fix), jpe(jnp.asarray(x), fix))


def test_coarse_transformer(ctx):
    r = ctx["ref"]
    with torch.no_grad():
        c0, c1 = ctx["port"].loftr_coarse(t(r["t0"]), t(r["t1"]))
    close(c0, r["c0"])
    close(c1, r["c1"])


def test_coarse_match(ctx):
    """Matching on features with real matches: noisy permuted copies (the
    random-weight transformer's outputs share one dominant offset, so
    they hold almost no mutual nearest neighbours)."""
    rng = np.random.default_rng(3)
    cfg_t, cfg_j = ctx["tcfg"].match, ctx["jcfg"].match
    hw = (8, 10)
    L = hw[0] * hw[1]
    f1 = rng.standard_normal((2, L, 32)).astype(np.float32)
    perm = np.stack([rng.permutation(L) for _ in range(2)])
    f0 = np.take_along_axis(f1, perm[..., None], axis=1) \
        + 0.3 * rng.standard_normal((2, L, 32)).astype(np.float32)
    ref = jmatching.coarse_match(jnp.asarray(f0), jnp.asarray(f1), hw, hw, 8.0,
                                 cfg_j)
    out = tmatching.coarse_match(t(f0), t(f1), hw, hw, 8.0, cfg_t)
    i_ids, j_ids, mconf, valid, mk0, mk1 = out
    ri, rj, rc, rv, rk0, rk1 = [np.asarray(a) for a in ref]
    assert valid.sum() >= 8
    np.testing.assert_array_equal(valid.numpy(), rv)
    np.testing.assert_array_equal(i_ids.numpy(), ri)
    np.testing.assert_array_equal(j_ids.numpy(), rj)
    close(mconf, rc)
    close(mk0, rk0)
    close(mk1, rk1)


def test_border_mask_and_topk_order():
    np.testing.assert_array_equal(tmatching.border_mask(6, 7, 2).numpy(),
                                  np.asarray(jmatching.border_mask(6, 7, 2)))
    score = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.2, 0.0]])
    vals, idx = tmatching.topk_stable(score, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(score.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("hw,stride", [((8, 8), 4), ((5, 7), 4), ((6, 6), 2)])
def test_gather_windows(hw, stride):
    rng = np.random.default_rng(hw[0] * stride)
    Hf, Wf = hw[0] * stride, hw[1] * stride
    feat = rng.standard_normal((2, Hf, Wf, 3)).astype(np.float32)
    ids = rng.integers(0, hw[0] * hw[1], (2, 9))
    out = gather_windows(t(feat), t(ids), hw, stride, 5)
    oracle = gather_windows_pointwise(t(feat), t(ids), hw, stride, 5)
    np.testing.assert_array_equal(out.numpy(), oracle.numpy())
    ref = jgather(jnp.asarray(feat), jnp.asarray(ids, jnp.int32), hw, stride, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def jax_raw(layer):
    """A JAX LoFTREncoderLayer's variables in the fused-kernel layout."""
    C = layer["q_proj"]["kernel"].shape[0]
    w0 = layer["mlp_0"]["kernel"]
    ln = lambda n: jnp.stack([layer[n]["scale"], layer[n]["bias"]])
    return {"wq": layer["q_proj"]["kernel"], "wk": layer["k_proj"]["kernel"],
            "wv": layer["v_proj"]["kernel"], "wm": layer["merge"]["kernel"],
            "w0x": w0[:C], "w0m": w0[C:], "w1": layer["mlp_1"]["kernel"],
            "ln1": ln("norm1"), "ln2": ln("norm2")}


def test_fine_stage(ctx):
    """FinePreprocess, the windowed fine transformer (K3's module) and the
    soft-argmax, each on the JAX pipeline's own inputs. (Chained, the
    random weights' sharp heatmaps would amplify f32 rounding.)"""
    r = ctx["ref"]
    ri, rj = r["ids"][0], r["ids"][1]
    B, K = ri.shape
    port = ctx["port"]
    with torch.no_grad():
        f0w, f1w = port.fine_preprocess(
            t(r["feat_f"][:B]), t(r["feat_f"][B:]), t(r["c0"]), t(r["c1"]),
            t(ri).long(), t(rj).long(), ctx["tcfg"].coarse_hw, 4)
        close(f0w, r["f0w"])
        close(f1w, r["f1w"])
        # the windowed transformer on unit-scale windows: the synthesized
        # weights make the gathered windows ~50x larger, where f32
        # rounding grows through the stack; compared with the function
        # the JAX fine module dispatches to (fine_transformer_auto)
        WW, C = f0w.shape[2:]
        rng = np.random.default_rng(5)
        a = rng.standard_normal((B * K, WW, C)).astype(np.float32)
        b = rng.standard_normal((B * K, WW, C)).astype(np.float32)
        f0t, f1t = port.loftr_fine(t(a), t(b))
        fine_vars = ctx["variables"]["params"]["fine_matching"]["loftr_fine"]
        names = ctx["jcfg"].fine.layer_names
        params = [jax_raw(fine_vars[f"layer_{i}_{nm}"])
                  for i, nm in enumerate(names)]
        r0, r1 = fine_transformer_auto(jnp.asarray(a), jnp.asarray(b), params,
                                       names, ctx["jcfg"].fine.nhead)
        close(f0t, r0)
        close(f1t, r1)
        # the soft-argmax on unit-scale windows too (on the model's ~50x
        # larger ones its heatmaps saturate and amplify rounding)
        expec = fine_softargmax(t(a).reshape(B, K, WW, C),
                                t(b).reshape(B, K, WW, C), 5)
        close(expec, jfine_softargmax(jnp.asarray(a).reshape(B, K, WW, C),
                                      jnp.asarray(b).reshape(B, K, WW, C), 5))
        chained = fine_matching(port.loftr_fine, t(r["f0w"]), t(r["f1w"]), 5)
    assert chained.shape == expec.shape
    kp = fine_coords_to_kpts(t(r["expec_f"]), t(r["ids"][5]), 5, 2.0)
    close(kp, np.asarray(r["ids"][5]) + np.asarray(r["expec_f"])[..., :2] * 4.0)


def test_regressor(ctx):
    r = ctx["ref"]
    port = ctx["port"]
    with torch.no_grad():
        feats = port.regress_features(t(r["c0"]), t(r["c1"]))
        close(feats, r["feats"])
        pose, gate = port.regress_fuse(t(r["feats"]), ctx["ts"])
    close(pose, r["pose"])
    close(gate, r["gate"])


def test_match_end_to_end(ctx):
    """FARLoFTR.match from the images: ids and validity equal, coarse
    features and refined points close (fine outputs on valid slots)."""
    r = ctx["ref"]
    rm = r["match"]
    with torch.no_grad():
        out = ctx["port"].match(ctx["tb"])
    m = out.matches
    np.testing.assert_array_equal(m.valid.numpy(), rm.valid)
    np.testing.assert_array_equal(m.i_ids.numpy(), rm.i_ids)
    np.testing.assert_array_equal(m.j_ids.numpy(), rm.j_ids)
    close(out.feat_c0, r["c0"])
    close(out.feat_c1, r["c1"])
    close(m.mconf, rm.mconf)
    close(m.mkpts1_f, rm.mkpts1_f)
    v = rm.valid
    close(m.expec_f.numpy()[v], rm.expec_f[v])


def _ts_pair():
    """A small config with the translation-scale head: JAX's own Flax init
    carried into the port through flax_to_state_dict (strict load)."""
    jcfg = small_config(jconfig, predict_translation_scale=True)
    tcfg = small_config(tconfig, predict_translation_scale=True)
    jb = JPairBatch(image0=jnp.zeros((1, 64, 64, 1)), image1=jnp.zeros((1, 64, 64, 1)),
                    K0=jnp.eye(3)[None], K1=jnp.eye(3)[None])
    jmodel = JFARLoFTR(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb))
    port = FARLoFTR(tcfg).eval()
    sd = flax_to_state_dict(variables, tcfg)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jmodel, variables, port


def test_translation_scale_head():
    """The head alone on the same NHWC coarse maps: the port (NCHW inside,
    flattened in JAX's (h, w, c) order) gives JAX's scale to 1e-5; and
    match() returns it from the backbone's maps, to 1e-4 max(1, |ref|)
    as the other match() outputs."""
    jmodel, variables, port = _ts_pair()
    rng = np.random.default_rng(7)
    f0, f1 = (rng.standard_normal((2, 8, 8, 32)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(f0), jnp.asarray(f1),
                                  method=lambda m, a, b: m.ts_head(a, b)))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = port.ts_head(nchw(f0), nchw(f1))
    assert out.shape == (2,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    im0, im1 = smooth_images(np.random.default_rng(8), 2, 64, 64)
    K = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    jb = JPairBatch(image0=jnp.asarray(im0), image1=jnp.asarray(im1),
                    K0=jnp.asarray(K), K1=jnp.asarray(K))
    jout = jax.jit(functools.partial(jmodel.apply, method=JFARLoFTR.match))(variables, jb)
    with torch.no_grad():
        tout = port.match(PairBatch(image0=torch.from_numpy(im0),
                                    image1=torch.from_numpy(im1),
                                    K0=torch.from_numpy(K), K1=torch.from_numpy(K)))
    close(tout.translation_scale, np.asarray(jout.translation_scale))


def test_match_with_resize_scales(ctx):
    """The two places match() applies per-pair resize scales (B, 2) <w, h>
    agree with JAX's: coarse_match on features with real mutual matches
    (as test_coarse_match makes them; the random-weight model's own
    features hold almost none, so its match() would only scale zeros),
    and the fine refinement of image 1's keypoints."""
    rng = np.random.default_rng(9)
    hw = (8, 10)
    L = hw[0] * hw[1]
    f1 = rng.standard_normal((2, L, 32)).astype(np.float32)
    perm = np.stack([rng.permutation(L) for _ in range(2)])
    f0 = np.take_along_axis(f1, perm[..., None], axis=1) \
        + 0.3 * rng.standard_normal((2, L, 32)).astype(np.float32)
    scale0 = np.array([[1.5, 2.0], [0.5, 1.25]], np.float32)
    scale1 = np.array([[2.0, 1.0], [1.0, 0.75]], np.float32)
    ref = jmatching.coarse_match(jnp.asarray(f0), jnp.asarray(f1), hw, hw, 8.0,
                                 ctx["jcfg"].match, scale0=jnp.asarray(scale0),
                                 scale1=jnp.asarray(scale1))
    out = tmatching.coarse_match(t(f0), t(f1), hw, hw, 8.0, ctx["tcfg"].match,
                                 scale0=t(scale0), scale1=t(scale1))
    ri, rj, rc, rv, rk0, rk1 = [np.asarray(a) for a in ref]
    assert rv.sum() >= 8
    np.testing.assert_array_equal(out[3].numpy(), rv)
    np.testing.assert_array_equal(out[1].numpy(), rj)
    close(out[4], rk0)
    close(out[5], rk1)
    expec = rng.uniform(-1, 1, (2, out[0].shape[1], 3)).astype(np.float32)
    kp = fine_coords_to_kpts(t(expec), out[5], 5, 2.0, t(scale1))
    close(kp, jfine_coords_to_kpts(jnp.asarray(expec), jnp.asarray(rk1), 5, 2.0,
                                   jnp.asarray(scale1)))
