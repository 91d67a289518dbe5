"""The FARConfig options far_tpu_torch once refused, against far_tpu.

The 16/4 backbone (a 1/16 coarse and a 1/4 fine map), GroupNorm in the
backbone, and full (softmax) attention in the coarse and fine stacks, at
``test_torch_modules.small_config``'s widths on the CPU. The weights are
the port's seeded init, carried into the JAX tree by the port's mapping
and back by ``flax_to_state_dict`` (the JAX package's converter has no
16/4 or GroupNorm entries). Per option: the matcher's taps, ``far_forward`` on
tests/test_torch_pipeline.py's scene replay, and one stubbed train step
against ``make_train_step``. Tolerances are stated where they are
checked.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import far_tpu.train.trainer as jtrainer
import far_tpu_torch.models.transformer as ttransformer
import far_tpu_torch.train.trainer as ttrainer
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.types import PairBatch as JPairBatch
from far_tpu.utils import config as jconfig
from far_tpu_torch.models.backbone import gn
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.train.trainer import Trainer
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import (
    _inverse,
    build_loftr_mapping,
    flax_to_state_dict,
    init_weights,
)
from test_torch_modules import small_config, smooth_images
from test_torch_pipeline import far_forward_against_jax
from test_torch_train import _fixed_estimate, _stub, pairs, rel_close

torch.set_num_threads(2)

SIZE = (128, 160)  # 16/4: an 8x10 coarse grid, 32x40 fine


def option_over(mod, option):
    """The overrides of ``small_config`` that turn one option on, from
    either package's config module. 16/4: the coarse map has
    block_dims[3] = coarse.d_model channels, the fine map block_dims[1]
    = fine.d_model."""
    if option == "16_4":
        return dict(backbone=mod.BackboneConfig(initial_dim=16, block_dims=(16, 16, 24, 32),
                                                resolution=(16, 4)),
                    predict_translation_scale=True)
    if option == "group":
        return dict(backbone=mod.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32),
                                                norm="group"))
    return dict(coarse=mod.AttentionStackConfig(d_model=32, nhead=4, attention="full"),
                fine=mod.FineConfig(d_model=16, nhead=4, attention="full"))


def jax_pair(option, size=SIZE, seed=0):
    """(JAX config, port config, JAX model, its variables (numpy), the
    port's model in eval mode with the same weights): the port's own
    deterministic init (``init_weights``), carried into the JAX tree by
    the port's mapping and back by ``flax_to_state_dict``, which must
    give every tensor back bit for bit."""
    jcfg = small_config(jconfig, image_size=size, **option_over(jconfig, option))
    tcfg = small_config(tconfig, image_size=size, **option_over(tconfig, option))
    port = init_weights(FARLoFTR(tcfg), seed=seed).eval()
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    H, W = size
    jb = JPairBatch(image0=jnp.zeros((1, H, W, 1)), image1=jnp.zeros((1, H, W, 1)),
                    K0=jnp.eye(3)[None], K1=jnp.eye(3)[None])
    jmodel = JFARLoFTR(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    variables = jax.tree.map(lambda a: np.full(a.shape, np.nan, a.dtype), shapes)
    P, S = build_loftr_mapping(tcfg)
    for entries, tree in ((P, variables["params"]), (S, variables.get("batch_stats", {}))):
        for key, path, tf in entries:
            node = tree
            for k in path[:-1]:
                node = node[k]
            assert node[path[-1]].shape == tf(state[key]).shape, key
            node[path[-1]] = tf(state[key])
    assert not any(np.isnan(a).any() for a in jax.tree.leaves(variables))  # all filled
    back = flax_to_state_dict(variables, tcfg)
    assert sorted(back) == sorted(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v, state[k], err_msg=k)
    return jcfg, tcfg, jmodel, variables, port


def close(out, ref, rel, what):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("option", ["16_4", "group", "full"])
def test_option_match_taps_match_jax(option):
    """The backbone's coarse and fine maps of both images, the
    transformed coarse tokens (feat_c0/1) and the translation scale
    (16/4) of the port's own ``match`` within 1e-4 max|ref|; then the
    fine stage (window gather, the fine stack, the soft-argmax) on the
    JAX package's coarse selection, maps and tokens: expec_f within 1e-4
    max|ref|. The selection itself is not compared here: both packages
    round the tokens to bf16 for K2 (far_tpu/models/matching.py), so a
    1e-6 difference can flip a rounding and move a confidence by 1e-2;
    test_torch_modules holds it on equal inputs. 16/4 gives the 8x10
    coarse grid and the 32x40 fine map."""
    jcfg, tcfg, jmodel, variables, port = jax_pair(option)
    rng = np.random.default_rng(21)
    im0, im1 = smooth_images(rng, 2, *SIZE, shift=(16, 16))
    K = np.tile(np.array([[100.0, 0, 80], [0, 100.0, 64], [0, 0, 1]], np.float32)[None],
                (2, 1, 1))
    jb = JPairBatch(image0=jnp.asarray(im0), image1=jnp.asarray(im1),
                    K0=jnp.asarray(K), K1=jnp.asarray(K))

    def taps(m, batch):
        imgs = jnp.concatenate([batch.image0, batch.image1], axis=0)
        return m.backbone(imgs, False), m.match(batch)

    (feat_c, feat_f), ref = jax.jit(functools.partial(jmodel.apply, method=taps))(variables, jb)
    s = tcfg.backbone.resolution
    assert feat_c.shape[1:3] == (SIZE[0] // s[0], SIZE[1] // s[0]) == tcfg.coarse_hw
    assert feat_f.shape[1:3] == (SIZE[0] // s[1], SIZE[1] // s[1])
    tb = PairBatch(image0=torch.from_numpy(im0), image1=torch.from_numpy(im1),
                   K0=torch.from_numpy(K), K1=torch.from_numpy(K))
    imgs = torch.cat([tb.image0, tb.image1]).permute(0, 3, 1, 2)
    a = lambda x: torch.from_numpy(np.array(x))
    jm = ref.matches
    with torch.inference_mode():
        c, f = port.backbone(imgs)
        out = port.match(tb)
        expec_f = port.fine_stage(a(feat_f[:2]), a(feat_f[2:]), a(ref.feat_c0),
                                  a(ref.feat_c1), a(jm.i_ids).long(), a(jm.j_ids).long())
    close(c.permute(0, 2, 3, 1), feat_c, 1e-4, "backbone coarse")
    close(f.permute(0, 2, 3, 1), feat_f, 1e-4, "backbone fine")
    close(out.feat_c0, ref.feat_c0, 1e-4, "feat_c0")
    close(out.feat_c1, ref.feat_c1, 1e-4, "feat_c1")
    assert int(np.asarray(jm.valid).sum()) >= 1
    close(expec_f, jm.expec_f, 1e-4, "expec_f")
    if tcfg.predict_translation_scale:
        close(out.translation_scale, ref.translation_scale, 1e-4, "translation_scale")


@pytest.mark.parametrize("option", ["16_4", "group", "full"])
def test_option_far_forward_matches_jax(option, monkeypatch):
    """far_forward on tests/test_torch_pipeline.py's scene replay (both
    matchers handed JAX's output and a rigid scene's correspondences):
    valid, success and num_inliers equal, R, t, gating and the solver's
    pose within 1e-3 (and, with 16/4's scale head, the scale). Under
    16/4 the EMM's epipolar basis and the scale head take the 8x10
    coarse grid. Seed 1: with seed 0's GroupNorm weights the JAX
    package's own prior round keeps 19 inliers on one pair, under the
    harness's 20 that shows the scene was found."""
    jcfg, tcfg, jmodel, variables, port = jax_pair(option, seed=1)
    if option == "16_4":
        assert port.loftr_regress.emm.cross_attn.grid_hw == (8, 10)
    far_forward_against_jax(jmodel, variables, port, jcfg, tcfg, True, monkeypatch)


def test_full_attention_runs_neither_k1_nor_k3(monkeypatch):
    """With attention="full" in both stacks the matcher never calls K1's
    or K3's wrapper (the JAX package routes full attention past its
    kernels); with linear attention it calls both."""
    calls = []

    def spy(name, real):
        def f(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return f

    monkeypatch.setattr(ttransformer, "loftr_layer_auto",
                        spy("K1", ttransformer.loftr_layer_auto))
    monkeypatch.setattr(ttransformer, "fine_transformer_auto",
                        spy("K3", ttransformer.fine_transformer_auto))
    rng = np.random.default_rng(22)
    im0, im1 = smooth_images(rng, 1, *SIZE)
    K = torch.eye(3)[None]
    tb = PairBatch(image0=torch.from_numpy(im0), image1=torch.from_numpy(im1), K0=K, K1=K)
    for option, want in (("full", set()), ("group", {"K1", "K3"})):
        calls.clear()
        port = jax_pair(option)[-1]
        with torch.inference_mode():
            port.match(tb)
        assert set(calls) == want, (option, calls)


@pytest.mark.parametrize("values", ["quarters", "normal"])
def test_groupnorm_bf16_matches_flax(values):
    """GroupNorm on a bfloat16 map against Flax's nn.GroupNorm(num_groups=8,
    dtype=bfloat16): float32 statistics, epsilon 1e-6, one rounding.
    "quarters": values k/4, whose float32 sums are exact in any order, so
    the two packages' statistics agree bit for bit and so must the
    outputs. "normal": the statistics differ in their last float32 bit
    (the two libraries sum in other orders), which moves at most 1 in
    1000 outputs by one bf16 ulp at a rounding boundary; the rest are
    equal. In float32 within 1e-6 max|ref| either way."""
    rng = np.random.default_rng(23)
    if values == "quarters":
        x = rng.integers(-64, 64, size=(2, 12, 10, 48)).astype(np.float32) / 4
    else:
        x = (rng.normal(size=(2, 12, 10, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(1.0, 0.3, 48).astype(np.float32)
    bias = rng.normal(0.0, 0.3, 48).astype(np.float32)
    m = torch.nn.GroupNorm(8, 48, eps=1e-6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        xt = torch.from_numpy(x).to(dt)
        ref = fnn.GroupNorm(num_groups=8, dtype=jdt).apply(
            params, jnp.asarray(xt.float().numpy()).astype(jdt))
        with torch.no_grad():
            out = gn(xt.permute(0, 3, 1, 2), m).permute(0, 2, 3, 1)
        assert out.dtype == dt
        ref = np.asarray(ref.astype(jnp.float32))
        if dt == torch.float32:
            close(out, ref, 1e-6, "float32")
            continue
        out = out.float().numpy()
        differ = out != ref
        if values == "quarters":
            assert not differ.any()
        else:
            assert differ.mean() <= 1e-3
            ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[differ]))) - 7)
            np.testing.assert_array_equal(np.abs(out - ref)[differ], ulp)


def test_groupnorm_refuses_196_channels():
    """FARConfig's default block_dims (128, 196, 256) under GroupNorm:
    both packages raise Flax's "does not divide" ValueError."""
    jcfg = jconfig.FARConfig(backbone=jconfig.BackboneConfig(norm="group"))
    jb = JPairBatch(image0=jnp.zeros((1, 480, 640, 1)), image1=jnp.zeros((1, 480, 640, 1)),
                    K0=jnp.eye(3)[None], K1=jnp.eye(3)[None])
    with pytest.raises(ValueError, match=r"does not divide the number of channels \(196\)"):
        jax.eval_shape(lambda: JFARLoFTR(jcfg).init(jax.random.PRNGKey(0), jb))
    with pytest.raises(ValueError, match=r"does not divide the number of channels \(196\)"):
        FARLoFTR(tconfig.FARConfig(backbone=tconfig.BackboneConfig(norm="group")))


# A train step's deltas against the JAX package's, relative to max|ref|,
# each the sum of the two packages' float32 errors rounded up, measured
# on these steps against the port's own step in float64
# (utils/float64.py:float64_compute): in the backbone the JAX package's
# reaches 8.0e-2 (16/4's layer3.0.downsample.0, through the train-mode
# BatchNorms; the port's 4.4e-6 there); past it 1e-4 holds, but with full
# attention the port's own reaches 1.8e-4 (loftr_fine.layers.0.k_proj) and
# the two differ by 1.3e-4 in loftr_coarse.layers.0.v_proj.
# test_option_backbone_grads_against_jax_float64 and
# test_full_attention_stack_grads_against_jax_float64 hold the port's
# backbone and full-attention gradients to 1e-5 of JAX's float64.
BACKBONE_TOL = 1e-1
STEP_TOL = {"group": 1e-4, "16_4": 1e-4, "full": 3e-4}


@pytest.mark.parametrize("option", ["group", "16_4"])
def test_option_backbone_grads_against_jax_float64(option):
    """The GroupNorm and 16/4 backbones in train mode, alone, under a
    fixed cotangent of both outputs: the port's float32 gradients within
    1e-5 max|ref| of the JAX package's backbone run in float64 (x64 on,
    dtype float64), as tests/test_torch_train.py holds the 8/2
    BatchNorm one. The JAX package's own float32 gradient is printed
    beside it."""
    from far_tpu.models import backbone as jbackbone

    tcfg = small_config(tconfig, **option_over(tconfig, option))
    port = init_weights(FARLoFTR(tcfg), seed=0)
    sd = {k[len("backbone."):]: v.numpy() for k, v in port.state_dict().items()
          if k.startswith("backbone.")}
    bb = port.backbone.train()
    tb, _ = pairs((64, 64))
    imgs = np.concatenate([tb.image0.numpy(), tb.image1.numpy()])
    c, f = bb(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    rng = np.random.default_rng(13)
    wc = rng.normal(size=c.permute(0, 2, 3, 1).shape)
    wf = rng.normal(size=f.permute(0, 2, 3, 1).shape)
    ((c.permute(0, 2, 3, 1) * torch.from_numpy(wc).float()).sum()
     + (f.permute(0, 2, 3, 1) * torch.from_numpy(wf).float()).sum()).backward()
    bcfg = tcfg.backbone
    cls = jbackbone.ResNetFPN_8_2 if bcfg.resolution[0] == 8 else jbackbone.ResNetFPN_16_4
    P, S = build_loftr_mapping(tcfg)
    params, stats = {}, {}
    for entries, tree in ((P, params), (S, stats)):
        for key, path, tf in entries:
            if path[0] == "backbone":
                node = tree
                for k in path[1:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = tf(sd[key[len("backbone."):]])

    def grads(dtype):
        jbb = cls(initial_dim=bcfg.initial_dim, block_dims=tuple(bcfg.block_dims),
                  norm=bcfg.norm, dtype=dtype)
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

        def loss(p):
            (cc, ff), _ = jbb.apply({"params": p, "batch_stats": cast(stats)},
                                    jnp.asarray(imgs, dtype), True, mutable=["batch_stats"])
            return jnp.sum(cc * jnp.asarray(wc, dtype)) + jnp.sum(ff * jnp.asarray(wf, dtype))

        g = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(cast(params)))
        full = {"params": {"backbone": g}, "batch_stats": {"backbone": stats}}
        return {k: v for k, v in _backbone_sd(full, tcfg).items()}

    g32 = grads(jnp.float32)
    jax.config.update("jax_enable_x64", True)
    try:
        g64 = grads(jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    worst = 0.0
    for name, p in bb.named_parameters():
        ref = g64[name]
        rel_close(p.grad, ref, 1e-5, name)
        worst = max(worst, float(np.abs(g32[name] - ref).max() / np.abs(ref).max()))
    print(f"{option}: the JAX package's float32 backbone gradient, largest relative "
          f"error against its float64 one: {worst:.3g}")


def test_full_attention_stack_grads_against_jax_float64():
    """The coarse stack with full attention (4 self/cross pairs, 32 wide,
    4 heads) over 2 x 64 tokens, under a fixed cotangent of both
    outputs: the port's float32 gradients of every weight and of both
    inputs within 1e-5 max|ref| of the JAX package's stack run in
    float64. The JAX package's own float32 gradient is printed beside
    it (see ATTENTION_TOL)."""
    from far_tpu.models.transformer import LocalFeatureTransformer as JStack

    names = ("self", "cross") * 4
    port = init_weights(ttransformer.LocalFeatureTransformer(32, 4, names, attention="full"),
                        seed=3)
    rng = np.random.default_rng(14)
    x0, x1, w0, w1 = (rng.normal(size=(2, 64, 32)) for _ in range(4))
    t0, t1 = (torch.from_numpy(a).float().requires_grad_() for a in (x0, x1))
    o0, o1 = port.train()(t0, t1)
    ((o0 * torch.from_numpy(w0).float()).sum() + (o1 * torch.from_numpy(w1).float()).sum()).backward()
    from far_tpu_torch.utils.convert_weights import _stack_entries

    params = {}
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    for key, path, tf in _stack_entries("", (), names):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = tf(sd[key[1:]])

    def grads(dtype):
        stack = JStack(32, 4, names, attention="full", dtype=dtype)
        cast = lambda a: jnp.asarray(a, dtype)

        def loss(p, a, b):
            y0, y1 = stack.apply({"params": p}, a, b)
            return jnp.sum(y0 * cast(w0)) + jnp.sum(y1 * cast(w1))

        g, ga, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jax.tree.map(cast, params), cast(x0), cast(x1))
        out = {"x0": np.asarray(ga), "x1": np.asarray(gb)}
        for key, path, tf in _stack_entries("", (), names):
            node = g
            for k in path:
                node = node[k]
            out[key[1:]] = _inverse(tf)(np.asarray(node))
        return out

    g32 = grads(jnp.float32)
    jax.config.update("jax_enable_x64", True)
    try:
        g64 = grads(jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    ours = dict(port.named_parameters())
    worst = 0.0
    for name, ref in g64.items():
        got = {"x0": t0, "x1": t1}.get(name, ours.get(name))
        rel_close(got.grad, ref, 1e-5, name)
        worst = max(worst, float(np.abs(g32[name] - ref).max() / np.abs(ref).max()))
    print(f"full attention: the JAX package's float32 stack gradient, largest relative "
          f"error against its float64 one: {worst:.3g}")


def _backbone_sd(variables, tcfg):
    """The backbone's entries of ``flax_to_state_dict`` for a tree that
    holds only the backbone, keyed without the ``backbone.`` prefix."""
    P, S = build_loftr_mapping(tcfg)
    out = {}
    for entries, tree in ((P, variables["params"]), (S, variables["batch_stats"])):
        for key, path, tf in entries:
            if path[0] != "backbone":
                continue
            node = tree
            for k in path:
                node = node[k]
            out[key[len("backbone."):]] = np.asarray(node) if tf.__name__ == "_ident" \
                else _inverse(tf)(node)
    return out


@pytest.mark.parametrize("option,size,data_seed", [("group", (64, 64), 2),
                                                   ("full", (64, 64), 0),
                                                   ("16_4", (192, 256), 1)])
def test_option_train_step_matches_jax(option, size, data_seed, monkeypatch):
    """One train step under the option, the solver stubbed to one fixed
    estimate in both packages and SGD(lr=1), as
    tests/test_torch_train.py::test_train_step_matches_jax holds it: the
    metrics within 1e-4 relative, every parameter's delta within STEP_TOL
    max|ref| of the tensor plus one rounding of max|p| (the backbone's
    within BACKBONE_TOL), BatchNorm statistics within 1e-5, and
    the same parameters moved in both. 16/4 at 192x256 (a 12x16 coarse
    grid): no coarse match of the random model lands within the fine
    loss's window there (loss_f 0 in both), so the fine stack and the
    FPN's 1/4 level stay still in both, as the scale head does (its loss
    weight is 0); GroupNorm and full attention move more than 90 %."""
    jcfg, tcfg, jmodel, variables, _ = jax_pair(option, size)
    tb, jb = pairs(size, seed=data_seed)
    tx = optax.sgd(1.0)
    state = jtrainer.create_train_state(jmodel, variables, tx)
    est = _fixed_estimate(2)
    monkeypatch.setattr(jtrainer, "estimate_pose", _stub(est, jnp.asarray))
    jstate, jmetrics = jax.jit(jtrainer.make_train_step(jmodel, tx))(
        state, jb, jax.random.PRNGKey(3))
    jstate, jmetrics = jax.tree.map(np.asarray, (jstate, jmetrics))

    sd = flax_to_state_dict(variables, tcfg)
    trainer = Trainer(tcfg, device="cpu")
    trainer.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=1.0)
    monkeypatch.setattr(ttrainer, "estimate_pose",
                        _stub(est, lambda a: torch.from_numpy(np.array(a))))
    metrics = trainer.step(tb)
    assert metrics["num_matches"] == float(jmetrics["num_matches"]) >= 2
    for k, v in metrics.items():
        rel_close(np.float64(v), np.float64(jmetrics[k]), 1e-4, k)
    delta = jax.tree.map(lambda a, b: a - b, jstate.params, variables["params"])
    ref_delta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats}, tcfg)
    moved, ref_moved = set(), set()
    for name, p in trainer.model.named_parameters():
        d = (p.detach() - torch.from_numpy(np.array(sd[name]))).numpy()
        ref = ref_delta[name]
        ulp = 2.0 ** -23 * float(np.abs(sd[name]).max())
        rel = BACKBONE_TOL if name.startswith("backbone.") else STEP_TOL[option]
        np.testing.assert_allclose(d, ref, rtol=0, atol=rel * float(np.abs(ref).max()) + ulp,
                                   err_msg=name)
        if np.abs(ref).max() > 0:
            ref_moved.add(name)
        if np.abs(d).max() > 0:
            moved.add(name)
    assert moved == ref_moved
    n = len(list(trainer.model.parameters()))
    if option == "16_4":
        assert float(jmetrics["loss_f"]) == metrics["loss_f"] == 0.0
        assert not any(k.startswith(("loftr_fine.", "ts_head.")) for k in moved)
        assert len(moved) > 0.5 * n
    else:
        assert metrics["loss_f"] > 0 and len(moved) > 0.9 * n
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jstate.batch_stats}, tcfg)
    for name, v in trainer.model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            rel_close(v, stats[name], 1e-5, name)
