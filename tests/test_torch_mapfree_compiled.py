"""The compiled map-free request (``far_tpu_torch.pipeline.build_mapfree_fn``)
and the plain references the benchmark judges it by, on the CPU.

At small widths (a 128x128 matcher with a 32-wide coarse stack and 64
matches; the 6DReg regressor with encoder blocks (1, 1, 1), 8 output
channels, one transformer layer of 4 heads, hidden 32, at an odd 36x28 so
that the decoder's skips are padded) one random state dict
(``h100bench/reference/weights.make_state_dict``) loads into the port's
modules and into the benchmark's plain float32 references
(``h100bench/reference/sixdreg.py``, ``far.py``), and each module of
``MapfreeRegression`` and the whole request are held to them with the
same draws. Then what the graph relies on: the draws taken outside equal
the eager ones, the regressor's trunk runs once a request to the answer
of the loop that ran it every round, the request marks its stages in
order, and on the CPU a call is the eager request. The card tests (a
replay against the eager request, bit for bit, with the LoFTR matcher and
with SuperPoint + SuperGlue) are marked ``cuda`` and skip here.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from far_tpu_torch import pipeline
from far_tpu_torch.data.synthetic import synthetic_batch
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils import prof as tprof
from far_tpu_torch.utils.config import (
    AttentionStackConfig,
    BackboneConfig,
    FARConfig,
    FineConfig,
    MatchConfig,
)
from h100bench.reference import judge_mapfree as jm
from h100bench.reference import sixdreg as rs
from h100bench.reference.far import FarReference, identity, shapes_from_config
from h100bench.reference.synthetic import make_pairs
from h100bench.reference.weights import make_state_dict

torch.set_num_threads(2)
SMALL = dict(image_hw=(36, 28), encoder_blocks=(1, 1, 1), encoder_out_layers=8,
             transformer_layers=1, transformer_heads=4, hidden=32, dtype="float32")
MATCHER = FARConfig(
    image_size=(128, 128), backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
    coarse=AttentionStackConfig(d_model=32, nhead=4), match=MatchConfig(max_matches=64, thr=0.0),
    fine=FineConfig(d_model=16, nhead=4), regress_rt=False, dtype="float32")


def _config_dict(cfg) -> dict:
    def lists(x):
        if isinstance(x, dict):
            return {k: lists(v) for k, v in x.items()}
        return list(x) if isinstance(x, tuple) else x
    return lists(dataclasses.asdict(cfg))


def _shapes(make):
    with torch.device("meta"):
        return {k: v.shape for k, v in make().state_dict().items()}


@pytest.fixture(scope="module")
def regressors():
    """(the port's MapfreeRegression, the reference) with one state dict."""
    cfg = SixDRegConfig(**SMALL)
    ref = rs.SixDRegReference(rs.shapes_from_config(_config_dict(cfg))).eval()
    sd = make_state_dict(_shapes(lambda: rs.SixDRegReference(ref.s)), 2 ** 33 + 9, "cpu")
    # BatchNorm statistics away from (0, 1), so that the folding is tested
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=torch.Generator().manual_seed(1))
        if k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=torch.Generator().manual_seed(2))
    ref.load_state_dict(sd)
    port = MapfreeRegression(cfg).eval()
    port.load_state_dict(sd)
    return port, ref


@pytest.fixture(scope="module")
def request_models():
    """(matcher, regressor) of the port and (matcher, regressor) of the
    references, from one state dict, and a scene's inputs."""
    reg_cfg = SixDRegConfig(**SMALL)
    mref = FarReference(shapes_from_config(_config_dict(MATCHER))).eval()
    rref = rs.SixDRegReference(rs.shapes_from_config(_config_dict(reg_cfg))).eval()
    sd = make_state_dict({**{"m." + k: v for k, v in _shapes(lambda: mref).items()},
                          **{"r." + k: v for k, v in _shapes(lambda: rref).items()}},
                         2 ** 32 + 6, "cpu")  # a draw that keeps 26 and 31 matches
    part = lambda p: {k[2:]: v for k, v in sd.items() if k.startswith(p)}
    mref.load_state_dict(part("m."))
    rref.load_state_dict(part("r."))
    matcher, reg = FARLoFTR(MATCHER).eval(), MapfreeRegression(reg_cfg).eval()
    matcher.load_state_dict(part("m."))
    reg.load_state_dict(part("r."))
    # smooth images, the second a shifted crop of the first: dense texture
    # for the matcher (the benchmark's splatted scenes keep few matches at
    # this size)
    batch = synthetic_batch(2, *MATCHER.image_size, "cpu", seed=3)
    r0, r1 = _images(12)
    return (matcher, reg), (mref, rref), batch, r0, r1


def _nchw(im):
    return im.permute(0, 3, 1, 2).contiguous()


def _close(out, ref, rel=1e-5):
    """float32 on both sides, the same products in other orders: within a
    few ulps of the reference's largest entry a few layers deep."""
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), (err, float(ref.abs().max()))


# ---- the modules of MapfreeRegression against the reference --------------------------

def _images(seed, B=2, hw=(36, 28)):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, *hw, 3, generator=g), torch.rand(B, *hw, 3, generator=g)


def _solver_pose(B=2):
    g = torch.Generator().manual_seed(7)
    R, _ = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))
    R = R * torch.linalg.det(R)[:, None, None]
    return torch.cat([R, torch.randn(B, 3, 1, generator=g)], -1), \
        torch.tensor([[40.0, 12.0, 3.0], [7.0, 2.0, 0.0]])


def _encoder(port, ref, im0, im1):
    return port.encoder(_nchw(im0)), ref.encoder.run(_nchw(im0), identity)


def _volume(port, ref, im0, im1):
    v0, v1 = port.encode(im0, im1)
    return port.aggregator(v0, v1), ref.volume(v0, v1)


def _head(port, ref, im0, im1):
    x = port.aggregator(*port.encode(im0, im1))
    y = x
    for i in range(3):
        y = getattr(ref.head, f"resblock{i + 1}").run(y, identity)
    return port.head(x), y


def _transformer(port, ref, im0, im1):
    tok = torch.randn(2, 6, 256, generator=torch.Generator().manual_seed(3))
    y = tok
    for layer in ref.transformer.layers:
        y = layer.run(y, identity)
    return port.transformer(tok), y


def _features(port, ref, im0, im1):
    return port.features(im0, im1), ref.features(im0, im1)


def _regress(port, ref, im0, im1):
    f = port.features(im0, im1)
    return port.regress(f), ref.regress(f)


def _blend(port, ref, im0, im1):
    f = port.features(im0, im1)
    p = port.regress(f)
    rt, counts = _solver_pose()
    R, t, _, gate = port.blend(f, p, rt, counts)
    Rr, tr, gr = ref.blend(f, p, rt, counts)
    return torch.cat([R.flatten(1), t, gate], 1), torch.cat([Rr.flatten(1), tr, gr], 1)


def _whole(port, ref, im0, im1):
    rt, counts = _solver_pose()
    R, t, _, gate = port(im0, im1, rt, counts)
    f = ref.features(im0, im1)
    Rr, tr, gr = ref.blend(f, ref.regress(f), rt, counts)
    return torch.cat([R.flatten(1), t, gate], 1), torch.cat([Rr.flatten(1), tr, gr], 1)


@pytest.mark.parametrize("part", [_encoder, _volume, _head, _transformer, _features, _regress,
                                  _blend, _whole], ids=lambda f: f.__name__.strip("_"))
def test_regressor_modules_match_the_reference(part, regressors):
    """Each stage of the port's 6DReg (ResUNet, correlation volume, head,
    transformer, the whole features, the pose MLP, the MoE blend, the
    model end to end) against the plain reference on the same state
    dict."""
    port, ref = regressors
    im0, im1 = _images(5)
    with torch.inference_mode():
        out, want = part(port, ref, im0, im1)
    _close(out, want)


def test_regress_then_blend_is_fuse(regressors):
    """``regress`` then ``blend`` is ``fuse``, and the blend moves the
    regressed pose it is given (the pose the request returns beside the
    fused one)."""
    port, _ = regressors
    im0, im1 = _images(6)
    rt, counts = _solver_pose()
    with torch.inference_mode():
        f = port.features(im0, im1)
        p = port.regress(f)
        a = port.blend(f, p, rt, counts)
        b = port.fuse(f, rt, counts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert p.shape == (2, 9) and not torch.equal(a[2], p)


# ---- the whole request against the references -----------------------------------------

def test_mapfree_request_matches_the_references(request_models):
    """``mapfree_forward`` against ``judge_mapfree.mapfree_forward`` (the
    references as a program) on one state dict with the same draws: the
    same set of matches but a near tie (K2 rounds the coarse features to
    bf16 in every dtype, so near-tied confidences may also come in another
    order), their
    confidence within that rounding, their fine positions and the
    regressed pose within float32 rounding. The solver rounds and the
    blend run on the program's own correspondences in the next test, as
    the benchmark judges them: in another order the same draws pick other
    samples."""
    (matcher, reg), (mref, rref), batch, r0, r1 = request_models
    u = pipeline.draw_mapfree_uniforms(2, torch.Generator().manual_seed(8))
    with torch.inference_mode():
        out = pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=u)
    ref = jm.mapfree_forward(mref, rref, batch.image0, batch.image1, batch.K0, batch.K1,
                             r0, r1, u)
    m = out.matches
    assert bool((m.valid.sum(-1) >= 8).all())  # every pair solves
    for b in range(2):
        def rows(o):
            v = o.valid[b]
            keys = (o.i_ids[b][v] * 10 ** 6 + o.j_ids[b][v]).tolist()
            return {k: (c, p) for k, c, p in zip(keys, o.mconf[b][v], o.mkpts1_f[b][v])}
        got, want = rows(m), rows(ref)
        # a mutual-nearest-neighbour decision at a near tie may go the
        # other way under K2's bf16 features: at most one match a pair
        assert len(set(got) ^ set(want)) <= 1, (sorted(got), sorted(want))
        both = sorted(set(got) & set(want))
        c, cr = (torch.stack([d[k][0] for k in both]) for d in (got, want))
        assert float((c.log() - cr.log()).abs().max()) < 0.5  # bf16 features in K2
        _close(*(torch.stack([d[k][1] for k in both]) for d in (got, want)))
    _close(out.regressed_9d, ref.regressed_9d)
    for o in (out.R, out.t, out.gating, out.solver_rt):
        assert bool(o.isfinite().all())


def test_judge_reads_the_request_as_correct(request_models):
    """The map-free judge reads the port's request at these widths as it
    reads a sound program: every gap at float32 rounding, the matches at
    the confidence's bf16 rounding."""
    (matcher, reg), (mref, rref), batch, r0, r1 = request_models
    u = pipeline.draw_mapfree_uniforms(2, torch.Generator().manual_seed(9))
    with torch.inference_mode():
        out = pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=u)
    fields = lambda o: {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}
    view = SimpleNamespace(**fields(out), **fields(out.matches))
    nums = jm.judge(mref, rref, batch.image0, batch.image1, batch.K0, batch.K1, r0, r1, view, u)
    assert nums["match_gap"] == 0.0 and nums["inlier_recount"] == 0.0
    assert nums["solver_gap"] == 0.0
    assert nums["reg_err"] < 1e-5 and nums["gate_err"] < 1e-5 and nums["rt_err"] < 1e-4
    assert nums["mconf_err"] < 0.5


# ---- what the graph relies on ---------------------------------------------------------

def test_uniforms_drawn_outside_are_the_eager_draws(request_models, monkeypatch):
    """The draws of ``draw_mapfree_uniforms`` are those an eager request
    takes from the same generator state, one (B, 2048, 8) tensor a round in
    order; a request given them answers as the request given the
    generator."""
    (matcher, reg), _, batch, r0, r1 = request_models
    seen = []
    real = pipeline.estimate_pose

    def spy(*a, **kw):
        seen.append(kw["uniforms"])
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "estimate_pose", spy)
    with torch.inference_mode():
        by_gen = pipeline.mapfree_forward(matcher, reg, batch, r0, r1,
                                          generator=torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    drawn = pipeline.draw_mapfree_uniforms(2, torch.Generator().manual_seed(11))
    assert [tuple(u.shape) for u in drawn] == [(2, 2048, 8)] * 2
    for u, d in zip(seen, drawn):
        assert torch.equal(u, d) and torch.equal(u, torch.rand((2, 2048, 8), generator=g))
    with torch.inference_mode():
        given = pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=drawn)
    for f in ("R", "t", "gating", "regressed_9d", "num_inliers"):
        assert torch.equal(getattr(given, f), getattr(by_gen, f)), f
    with pytest.raises(ValueError, match="need 2 uniform tensors"):
        pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=drawn[:1])


def _two_pass(matcher, reg_model, batch, image0_reg, image1_reg, uniforms):
    """The round loop with the regressor whole in every round, as the
    request ran it before its trunk was hoisted (and as the JAX package
    runs it): the fields of ``MapfreeOutput`` the rounds decide."""
    first_cfg, refine_cfg = pipeline.mapfree_solver_configs()
    m = matcher.match(batch).matches
    prior_rt = None
    for i, u in enumerate(uniforms):
        est = pipeline.estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid, prior_rt=prior_rt,
            cfg=first_cfg if i == 0 else refine_cfg, uniforms=u)
        vols = reg_model.encode(image0_reg, image1_reg)
        features = reg_model.tokens(reg_model.volume(*vols))
        pose_9d = reg_model.regress(features)
        counts = torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)
        R, t, _, gate = reg_model.blend(features, pose_9d, est.rt34, counts)
        prior_rt = torch.cat([R, t[..., None]], -1)
    return SimpleNamespace(R=R, t=t, gating=gate, regressed_9d=pose_9d, solver_rt=est.rt34,
                           num_inliers=est.num_inliers, num_tight=est.num_tight,
                           num_ultra_tight=est.num_ultra_tight)


def _recording(events, real, name=None):
    """``real`` (a method) that first appends ``name`` to ``events``, or,
    without a name, its first argument (a mark's stage)."""
    def call(self, *a, **kw):
        events.append(name or a[0])
        return real(self, *a, **kw)
    return call


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_trunk_once_answers_as_every_round(rounds, request_models, monkeypatch):
    """``mapfree_forward`` runs the regressor's image-only trunk once,
    whatever the number of rounds, and answers bit for bit as the loop
    that runs it whole in every round, on the same draws."""
    (matcher, reg), _, batch, r0, r1 = request_models
    u = pipeline.draw_mapfree_uniforms(2, torch.Generator().manual_seed(13),
                                       fine_pred_steps=rounds)
    with torch.inference_mode():
        want = _two_pass(matcher, reg, batch, r0, r1, u)
    passes = []
    monkeypatch.setattr(MapfreeRegression, "encode",
                        _recording(passes, MapfreeRegression.encode, "encode"))
    with torch.inference_mode():
        out = pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=u,
                                       fine_pred_steps=rounds)
    assert passes == ["encode"]
    for f in ("R", "t", "gating", "regressed_9d", "solver_rt", "num_inliers", "num_tight",
              "num_ultra_tight"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def test_mapfree_needs_a_round():
    """A request of no solver round has no pose to return: it raises before
    any work."""
    with pytest.raises(ValueError, match="at least 1"):
        pipeline.mapfree_forward(None, None, None, None, None, fine_pred_steps=0)


def test_mapfree_marks_its_stages_in_order(request_models, monkeypatch):
    """Under a sink, the request marks its start, the matcher's four
    stages, then four marks a round: solve, encode, volume, round. Round
    1 runs no trunk: its encode and volume marks come straight after its
    solve mark."""
    (matcher, reg), _, batch, r0, r1 = request_models
    stages = pipeline.mapfree_stages(2)
    assert stages == ("backbone", "coarse", "match", "fine", "solve.0", "encode.0", "volume.0",
                      "round.0", "solve.1", "encode.1", "volume.1", "round.1")
    slots = torch.zeros(len(stages) + 1, dtype=torch.int64)
    events = []
    for name in ("encode", "volume", "tokens", "regress", "blend"):
        monkeypatch.setattr(MapfreeRegression, name,
                            _recording(events, getattr(MapfreeRegression, name), name))
    monkeypatch.setattr(tprof.MarkSink, "mark", _recording(events, tprof.MarkSink.mark))
    with torch.inference_mode(), tprof.marking(tprof.MarkSink(slots)) as sink:
        pipeline.mapfree_forward(matcher, reg, batch, r0, r1,
                                 generator=torch.Generator().manual_seed(0))
    assert sink.names == [tprof.REQUEST_MARK, *stages]
    assert bool((slots > 0).all()) and bool((slots.diff() >= 0).all())
    rounds = events[events.index("fine") + 1:]
    assert rounds == ["solve.0", "encode", "encode.0", "volume", "volume.0", "tokens",
                      "regress", "blend", "round.0", "solve.1", "encode.1", "volume.1",
                      "blend", "round.1"]


def test_compiled_mapfree_on_the_cpu_is_eager(request_models):
    """On the CPU ``build_mapfree_fn`` runs the eager request: it captures
    nothing and answers as ``mapfree_forward``."""
    (matcher, reg), _, batch, r0, r1 = request_models
    fn = pipeline.build_mapfree_fn(matcher, reg)
    out = fn(batch, r0, r1, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        ref = pipeline.mapfree_forward(matcher, reg, batch, r0, r1,
                                       generator=torch.Generator().manual_seed(3))
    assert fn.graphs == {} and fn.prefix == "mapfree"
    for f in ("R", "t", "gating", "regressed_9d", "solver_rt", "num_inliers"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    with pytest.raises(RuntimeError, match="no request has run on the card"):
        fn.stage_ms()


def test_mapfree_signature(request_models):
    """The signature covers both models' storages and modes and every
    input: the regressor pair's shape or dtype, a module's mode or a moved
    parameter change it; equal inputs keep it."""
    (matcher, reg), _, batch, r0, r1 = request_models
    sig = lambda *a, **k: pipeline.request_signature((matcher, reg), a, **k)
    key = sig(batch, r0, r1)
    assert sig(batch, r0.clone(), r1.clone()) == key
    assert sig(batch, r0[:1], r1[:1]) != key and sig(batch, r0.double(), r1) != key
    assert sig(batch, r0, r1, uniforms=pipeline.draw_mapfree_uniforms(2)) != key
    reg.train()
    try:
        assert sig(batch, r0, r1) != key
    finally:
        reg.eval()
    assert sig(batch, r0, r1) == key


# ---- on a card ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "cell"])
def test_compiled_mapfree_on_card(card, size, tmp_path):
    """build_mapfree_fn on the card at small widths in float32 and at the
    cell's shapes (``mapfree_6dreg.reloc_b1``: B=1, a 720x544 matcher,
    ``SixDRegConfig()`` at 368x272, bf16): the first call captures, its
    warm-up launching one request's kernels (K1 16, K2 1, K3 1, K4 0, the
    polish's small-matrix kernels 6, the fused 5-point kernel 0) and its
    marks in order; replays of two scenes under set_sync_debug_mode
    ("error") launch through no wrapper and write every mark slot in
    order; the first call and both replays equal the eager
    mapfree_forward from the same generator state bit for bit, the first
    replay's output unchanged by the second; a profiler trace of a replay
    shows each route's kernels (K1-K4 by route, the small-matrix and the
    fused 5-point kernels) as often as the warm-up launched them, K1-K3 on
    their tensor-core routes in bf16; the capture counts under
    mapfree.capture.*: no node in round 1's encode and volume stages."""
    import json
    import re
    from collections import Counter

    from far_tpu_torch.ops import launch_counts
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax
    from far_tpu_torch.ops.fine_layer import fine_transformer
    from far_tpu_torch.ops.fivepoint import fivepoint_essential
    from far_tpu_torch.ops.loftr_layer import loftr_layer
    from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol
    from far_tpu_torch.ops.small_linalg import eigh_small, svd3

    if size == "small":
        B, reg_cfg = 2, SixDRegConfig(**SMALL)
        matcher = FARLoFTR(MATCHER).to(card).eval()
        reg = MapfreeRegression(reg_cfg).to(card).eval()
    else:
        B, reg_cfg = 1, SixDRegConfig(dtype="bfloat16")
        matcher = pipeline.init_model(FARConfig(image_size=(720, 544), regress_rt=False,
                                                dtype="bfloat16"), seed=0, device=card)
        reg = pipeline.init_sixdreg(reg_cfg, seed=1, device=card)

    def scene(seed):
        img0, img1, K, r0, r1, _ = make_pairs(B, matcher.config.image_size,
                                              torch.Generator(device=card).manual_seed(seed),
                                              card, channels=3, extra_hw=reg_cfg.image_hw)
        gray = lambda im: im.mean(-1, keepdim=True)
        return PairBatch(image0=gray(img0), image1=gray(img1), K0=K, K1=K), r0, r1

    scenes = (scene(4), scene(5))
    gen = torch.Generator(device=card)
    with torch.inference_mode():
        refs = [pipeline.mapfree_forward(matcher, reg, *x, generator=gen.manual_seed(2 + i))
                for i, x in enumerate(scenes)]
    fn = pipeline.build_mapfree_fn(matcher, reg)
    before, launched = tprof.counters(), launch_counts()
    first = fn(*scenes[0], generator=gen.manual_seed(2))
    after = tprof.counters()
    one = {k: v - launched[k] for k, v in launch_counts().items()}
    want = {loftr_layer: 16, dual_softmax_rowcol: 1, fine_transformer: 1,
            bilinear_dual_softmax: 0, eigh_small: 2, svd3: 4, fivepoint_essential: 0}
    assert {w: one[w, "launches"] for w in want} == want
    grew = {k for k, v in after.items() if v != before.get(k)}
    empty = ("encode.1", "volume.1")  # round 1 runs no trunk
    assert {f"mapfree.capture.nodes.{s}" for s in pipeline.mapfree_stages(2)
            if s not in empty} < grew
    assert not any(k.startswith("far.") for k in grew)
    for s in empty:
        k = f"mapfree.capture.nodes.{s}"
        assert after[k] - before.get(k, 0) == 0, k

    def fields(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            yield from (fields(v) if dataclasses.is_dataclass(v) else
                        [(f.name, v)] if isinstance(v, torch.Tensor) else [])

    slots = fn._last.slots
    with torch.inference_mode():
        slots.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*scenes[0], generator=gen.manual_seed(2))
        kept = [v.clone() for _, v in fields(out)]
        out2 = fn(*scenes[1], generator=gen.manual_seed(3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: v - launched[k] for k, v in launch_counts().items()} == one
    stamps = slots.tolist()
    assert len(stamps) == len(pipeline.mapfree_stages(2)) + 1
    assert min(stamps) > 0 and stamps == sorted(stamps)
    assert len(fn.graphs) == 1 and list(fn.stage_ms()) == list(pipeline.mapfree_stages(2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*scenes[0], generator=gen.manual_seed(2))
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]

    def symbol(name):  # "void tc::row_pass_kernel<64>(...)" -> "tc::row_pass_kernel"
        head = re.split(r"[<(]", name.replace("(anonymous namespace)", "anon"), maxsplit=1)[0]
        return "::".join((head.split() or [name])[-1].split("::")[-2:])

    seen = Counter(symbol(e["name"]) for e in events
                   if str(e.get("cat", "")).lower() == "kernel")
    # each route's own __global__ function (csrc/*.cu; anon: an anonymous
    # namespace) and its launches a wrapper call
    own = {(loftr_layer, "tc"): ("tc::row_pass_kernel", 1),
           (loftr_layer, "tf32"): ("tf32::split_weights_kernel", 1),
           (loftr_layer, "cuda"): ("anon::ln_kernel", 2),
           (dual_softmax_rowcol, "tc"): ("tc::combine_conf_kernel", 1),
           (dual_softmax_rowcol, "cuda"): ("anon::row_combine_kernel", 1),
           (fine_transformer, "tc"): ("tc::fine_tc_kernel", 1),
           (fine_transformer, "tf32"): ("tf32::fine_tf32_kernel", 1),
           (fine_transformer, "cuda"): ("anon::fine_kernel", 1),
           (bilinear_dual_softmax, "tc"): ("tc::main_kernel", 1),
           (bilinear_dual_softmax, "tf32"): ("tf32::main_tf32_kernel", 1),
           (bilinear_dual_softmax, "cuda"): ("anon::bilinear_tile_kernel", 1),
           (eigh_small, "cuda"): ("anon::eigh_kernel", 1),
           (svd3, "cuda"): ("anon::svd3_kernel", 1),
           (fivepoint_essential, "cuda"): ("anon::fivepoint_kernel", 1)}
    for (wrapper, route), (sym, per) in own.items():
        tc, tf32 = one.get((wrapper, "launches_tc"), 0), one.get((wrapper, "launches_tf32"), 0)
        calls = {"tc": tc, "tf32": tf32, "cuda": one[wrapper, "launches"] - tc - tf32}[route]
        assert seen[sym] == per * calls, (sym, seen[sym], calls)
    if size == "cell":
        for w in (loftr_layer, dual_softmax_rowcol, fine_transformer):
            assert one[w, "launches_tc"] == one[w, "launches"], w
    assert all(torch.equal(v, k) for (_, v), k in zip(fields(out), kept))
    for got, ref in ((first, refs[0]), (out, refs[0]), (out2, refs[1])):
        for (name, a), (_, b) in zip(fields(got), fields(ref)):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_compiled_mapfree_superglue_on_card(card):
    """build_mapfree_fn over SuperPoint + SuperGlue at the cell's shapes
    (``mapfree_6dreg_superglue.reloc_b1``: B=1, a 720x544 pair, 2,048
    keypoints a side, 9 (self, cross) rounds, ``SixDRegConfig()`` at
    368x272, bf16): the first call captures, with the marks request,
    detect, gnn, sinkhorn and four a round in order and counters under
    mapfree_sg.capture.* only (every stage's nodes but round 1's empty
    encode and volume); replays of two scenes under set_sync_debug_mode
    ("error") write every mark slot in order; the first call and both
    replays equal the eager mapfree_forward from the same generator
    state bit for bit, the first replay's output unchanged by the
    second."""
    from far_tpu_torch.models.superglue import SuperGlueConfig
    from far_tpu_torch.models.superglue_matcher import SuperGlueMatcher
    from far_tpu_torch.models.superpoint import SuperPointConfig
    from far_tpu_torch.utils.convert_weights import init_weights

    matcher = init_weights(SuperGlueMatcher(
        SuperPointConfig(nms_radius=3, max_keypoints=2048, dtype="bfloat16"),
        SuperGlueConfig(match_threshold=1e-4, dtype="bfloat16")), 0).to(card).eval()
    reg_cfg = SixDRegConfig(dtype="bfloat16")
    reg = pipeline.init_sixdreg(reg_cfg, seed=1, device=card)

    def scene(seed):
        img0, img1, K, r0, r1, _ = make_pairs(1, (720, 544),
                                              torch.Generator(device=card).manual_seed(seed),
                                              card, channels=3, extra_hw=reg_cfg.image_hw)
        gray = lambda im: im.mean(-1, keepdim=True)
        return PairBatch(image0=gray(img0), image1=gray(img1), K0=K, K1=K), r0, r1

    scenes = (scene(4), scene(5))
    gen = torch.Generator(device=card)
    with torch.inference_mode():
        refs = [pipeline.mapfree_forward(matcher, reg, *x, generator=gen.manual_seed(2 + i))
                for i, x in enumerate(scenes)]
    stages = pipeline.mapfree_stages(2, ("detect", "gnn", "sinkhorn"))
    fn = pipeline.build_mapfree_fn(matcher, reg)
    before = tprof.counters()
    first = fn(*scenes[0], generator=gen.manual_seed(2))
    after = tprof.counters()
    grew = {k for k, v in after.items() if v != before.get(k)}
    empty = ("encode.1", "volume.1")  # round 1 runs no trunk
    assert {f"mapfree_sg.capture.nodes.{s}" for s in stages if s not in empty} < grew
    assert all(k.startswith("mapfree_sg.capture.") for k in grew), grew
    for s in empty:
        k = f"mapfree_sg.capture.nodes.{s}"
        assert after[k] - before.get(k, 0) == 0, k

    def fields(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            yield from (fields(v) if dataclasses.is_dataclass(v) else
                        [(f.name, v)] if isinstance(v, torch.Tensor) else [])

    slots = fn._last.slots
    with torch.inference_mode():
        slots.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*scenes[0], generator=gen.manual_seed(2))
        kept = [v.clone() for _, v in fields(out)]
        out2 = fn(*scenes[1], generator=gen.manual_seed(3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    stamps = slots.tolist()
    assert len(stamps) == len(stages) + 1
    assert min(stamps) > 0 and stamps == sorted(stamps)
    assert len(fn.graphs) == 1 and tuple(fn.stage_ms()) == stages
    assert all(torch.equal(v, k) for (_, v), k in zip(fields(out), kept))
    assert bool(out.matches.kvalid0.all()) and bool(out.matches.valid.any())
    for got, ref in ((first, refs[0]), (out, refs[0]), (out2, refs[1])):
        for (name, a), (_, b) in zip(fields(got), fields(ref)):
            assert torch.equal(a, b), name
