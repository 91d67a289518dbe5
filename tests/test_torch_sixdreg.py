"""far_tpu_torch's map-free 6DReg and mapfree_forward against far_tpu.

The full-width port replays tests/golden/sixdreg_seed0.npz
(MapfreeRegression at 360x270) with the gates of
tests/test_golden_parity.py. At small widths (encoder blocks (1, 1, 1),
8 output channels, 1 transformer layer of 4 heads, hidden 32) and an odd
36x28 input, so that the decoder's skip maps are zero-padded
asymmetrically, one synthesized state dict feeds both packages (JAX
through convert_sixdreg_state_dict, the port through flax_to_state_dict)
and each module is held to 1e-4 * max|ref| in float32. mapfree_forward
is held to JAX's on a rigid scene's correspondences with JAX's draws.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu import pipeline as jpipeline
from far_tpu.models import sixdreg as jsixdreg
from far_tpu.solvers.pose_estimation import default_prior_pcl
from far_tpu.utils.convert_weights import convert_sixdreg_state_dict
from far_tpu_torch import pipeline as tpipeline
from far_tpu_torch.models import sixdreg as tsixdreg
from far_tpu_torch.solvers.pose_estimation import SolverConfig
from far_tpu_torch.utils import parity as tparity
from far_tpu_torch.utils.convert_weights import flax_to_state_dict, load_reference_state_dict
from test_torch_vitess import (
    _hooked,
    _solver_inputs,
    _sub,
    close,
    patch_matchers,
    scene_batches,
    scene_matcher_outputs,
    t,
    zeros_init,
)

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "golden" / "sixdreg_seed0.npz"
SMALL = dict(image_hw=(36, 28), encoder_blocks=(1, 1, 1), encoder_out_layers=8,
             transformer_layers=1, transformer_heads=4, hidden=32, dtype="float32")


def sixdreg_pair(seed=0, gate_bias=None, **over):
    """(JAX model, its variables, the port model, the synthesized state
    dict); ``gate_bias`` replaces the MoE's last bias."""
    kw = {**SMALL, **over}
    tcfg, jcfg = tsixdreg.SixDRegConfig(**kw), jsixdreg.SixDRegConfig(**kw)
    port = tsixdreg.MapfreeRegression(tcfg).eval()
    sd = tparity.synth_state_dict(
        tparity.sd_spec_of({k: v.numpy() for k, v in port.state_dict().items()}), seed)
    if gate_bias is not None:
        sd["moe_predictor.4.bias"] = np.full((2,), gate_bias, np.float32)
    jmodel = jsixdreg.MapfreeRegression(jcfg)
    img = jnp.zeros((1, *tcfg.image_hw, 3))
    variables, report = convert_sixdreg_state_dict(sd, zeros_init(
        lambda: jmodel.init(jax.random.PRNGKey(0), img, img, jnp.eye(3, 4)[None],
                            jnp.zeros((1, 3)))), jcfg)
    assert not report["missing"] and not report["unused"], report
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          flax_to_state_dict(variables, tcfg).items()}, strict=True)
    return jmodel, variables, port, sd


@pytest.fixture(scope="module")
def small():
    return sixdreg_pair()


def _pair_images(seed, B=2, hw=(36, 28)):
    rng = np.random.default_rng(seed)
    return [rng.random((B, *hw, 3)).astype(np.float32) for _ in range(2)]


def _nchw(a):
    return t(a).permute(0, 3, 1, 2).contiguous()


def test_config_copies_agree():
    assert dataclasses.asdict(tsixdreg.SixDRegConfig()) == \
        dataclasses.asdict(jsixdreg.SixDRegConfig())


def test_golden_replay():
    """The full-width port (f32) against every tap of the fixture, each gated
    at max(1e-3, 1e-3 max|tap|); the 360x270 encoder's maps are 92x68 (the
    skip maps zero-padded, not cropped)."""
    meta, inputs, _, taps = tparity.load_fixture(GOLDEN)
    sd = tparity.synth_state_dict(meta["sd_spec"], seed=meta["sd_seed"])
    port = tsixdreg.MapfreeRegression(tsixdreg.SixDRegConfig(dtype="float32")).eval()
    load_reference_state_dict(port, sd)
    got = _hooked(port, {"vol": "encoder", "gvol": "aggregator", "feats": "head",
                         "feats_tr": "transformer"})
    img = lambda k: t(inputs[k].transpose(0, 2, 3, 1))
    with torch.inference_mode():
        _, tr, p9, _ = port(img("image0_reg"), img("image1_reg"),
                            t(inputs["solver_rt"]), t(inputs["solver_inliers"]))
    ours = {"vol0": got["vol"][0], "vol1": got["vol"][1], "gvol": got["gvol"][0],
            "feats": got["feats"][0], "feats_tr": got["feats_tr"][0].transpose(1, 2),
            "pred_r6": p9[..., 3:], "pred_t": tr}
    assert set(taps) == set(ours)
    bad = {}
    for name, tap in taps.items():
        ref = np.asarray(tap, np.float32)
        out = ours[name].float().numpy()
        assert out.shape == ref.shape, (name, out.shape, ref.shape)
        err = float(np.abs(out - ref).max())
        if not err <= tparity.tap_tolerance("sixdreg", name, ref):
            bad[name] = err
    assert not bad, bad


def test_state_dict_round_trip():
    """flax_to_state_dict inverts JAX's convert_sixdreg_state_dict (its
    _perm_linear included) on the golden fixture's full-width state dict."""
    meta, *_ = tparity.load_fixture(GOLDEN)
    sd = tparity.synth_state_dict(meta["sd_spec"], seed=meta["sd_seed"])
    cfg = jsixdreg.SixDRegConfig(dtype="float32")
    jmodel = jsixdreg.MapfreeRegression(cfg)
    img = jnp.zeros((1, 360, 270, 3))
    variables, report = convert_sixdreg_state_dict(sd, zeros_init(
        lambda: jmodel.init(jax.random.PRNGKey(0), img, img, jnp.eye(3, 4)[None],
                            jnp.zeros((1, 3)))), cfg)
    assert not report["missing"] and not report["unused"], report
    back = flax_to_state_dict(variables, tsixdreg.SixDRegConfig(dtype="float32"))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_resunet_pads_odd_skips(small):
    jmodel, variables, port, _ = small
    x = _pair_images(1)[0]
    ref = jax.jit(jsixdreg.ResUNet(port.config).apply)(_sub(variables, "encoder"),
                                                        jnp.asarray(x))
    with torch.inference_mode():
        out = port.encoder(_nchw(x))
    assert tuple(out.shape[2:]) == (12, 8)
    close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("flags", [{}, dict(position_encoder_im1=True, normalise_dot=True,
                                            cv_half_channels=True, max_score_channel=False)])
def test_correlation_volume_warping(flags):
    """The aggregator against JAX's: the FAR configuration's (2 D + 3
    channels) and one with every other flag flipped (2 D + 4: the image-1
    grid, no max score)."""
    cfg = dict(SMALL, **flags)
    rng = np.random.default_rng(2)
    v0, v1 = (rng.normal(size=(2, 12, 8, 8)).astype(np.float32) for _ in range(2))
    ref = jax.jit(jsixdreg.CorrelationVolumeWarping(jsixdreg.SixDRegConfig(**cfg)).apply)(
        {}, jnp.asarray(v0), jnp.asarray(v1))
    out = tsixdreg.CorrelationVolumeWarping(tsixdreg.SixDRegConfig(**cfg))(_nchw(v0), _nchw(v1))
    assert out.shape[1] == 2 * 8 + (4 if flags else 3)
    close(out.permute(0, 2, 3, 1), ref)


def test_head_and_transformer_layer(small):
    jmodel, variables, port, _ = small
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 8, 19)).astype(np.float32)
    _, ref = jax.jit(jsixdreg.DeepResBlockHead(port.config).apply)(_sub(variables, "head"),
                                                          jnp.asarray(x))
    with torch.inference_mode():
        close(port.head(_nchw(x)).permute(0, 2, 3, 1), ref)
    tok = rng.normal(size=(2, 6, 256)).astype(np.float32)
    ref = jax.jit(jsixdreg.TorchTransformerEncoderLayer(256, 4).apply)(
        _sub(variables, "transformer_0"), jnp.asarray(tok))
    with torch.inference_mode():
        close(port.transformer.layers[0](t(tok)), ref)


@pytest.mark.parametrize("solver_preds", [True, False])
def test_mapfree_regression_whole(solver_preds, small):
    """(R, t, 9D pose, gate), with the solver pose and counts or without."""
    jmodel, variables, port, _ = small if solver_preds else \
        sixdreg_pair(seed=1, use_solver_preds=False)
    im0, im1 = _pair_images(4)
    rt, _ = _solver_inputs()
    counts = np.array([[40.0, 12.0, 3.0], [7.0, 2.0, 0.0]], np.float32)
    args = (rt, counts) if solver_preds else (None, None)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(im0), jnp.asarray(im1),
                                *(None if a is None else jnp.asarray(a) for a in args))
    with torch.inference_mode():
        out = port(t(im0), t(im1), *(None if a is None else t(a) for a in args))
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            close(o, r)


def test_mapfree_forward_matches_jax(monkeypatch):
    """Both matchers return one rigid scene's matches; the port gets the
    draws JAX takes from the key's split (far_tpu/pipeline.py:173) and
    JAX's prior probe cloud. Round 0 MAGSAC-scored RANSAC, round 1
    prior-biased: num_inliers of both rounds equal, (R, t, gate) within
    1e-3. The MoE leans on the solver (its last bias set to -3), so round
    1's prior lies near the scene's pose: around a random regressor's
    prior, prior scoring chooses among near-tied wrong hypotheses, where
    f32 summation order decides."""
    jmodel, variables, port, _ = sixdreg_pair(seed=2, gate_bias=-3.0)
    B = 2
    K = np.array([[2000.0, 0, 320], [0, 2000.0, 240], [0, 0, 1]], np.float32)
    jout, tout = scene_matcher_outputs(12, B, K)
    record = {}
    jmatcher, tmatcher = patch_matchers(monkeypatch, jout, tout, record)
    jb, tb = scene_batches(B, K)
    im0, im1 = _pair_images(5)
    key = jax.random.PRNGKey(6)

    def run(a, b, k):
        out = jpipeline.mapfree_forward(jmatcher, {}, jmodel, variables, jb, a, b, k)
        return out[:3], [e.num_inliers for e in record["jax"][-2:]]

    ref, jinl = jax.jit(run)(jnp.asarray(im0), jnp.asarray(im1), key)
    keys = jax.random.split(key, 2)
    cfgs = (SolverConfig(solver="ransac", pixel_thr=2.0, scoring="magsac")
            .ransac_config(False), SolverConfig(solver="prior_ransac").ransac_config(True))
    u = [t(jax.random.uniform(k, (B, *c.sampling()[:2]))) for k, c in zip(keys, cfgs)]
    with torch.inference_mode():
        out = tpipeline.mapfree_forward(tmatcher, port, tb, t(im0), t(im1), uniforms=u,
                                        prior_pcl=t(default_prior_pcl()))
    assert (np.asarray(jinl[0]) >= 25).all()
    for est, want in zip(record["port"], jinl):
        np.testing.assert_array_equal(est.num_inliers.numpy(), np.asarray(want))
    last = record["port"][-1]
    for name in ("num_inliers", "num_tight", "num_ultra_tight", "E"):
        assert torch.equal(getattr(out, name), getattr(last, name)), name
    assert torch.equal(out.solver_rt, last.rt34)
    for o, r in zip((out.R, out.t, out.gating), ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)


def test_entry_points_need_a_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for init, cfg in ((tpipeline.init_sixdreg, tsixdreg.SixDRegConfig(**SMALL)),
                      (tpipeline.init_vitess, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg)
        model = init(cfg, device="cpu")
        assert next(model.parameters()).device.type == "cpu" and not model.training
