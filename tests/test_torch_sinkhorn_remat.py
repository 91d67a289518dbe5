"""Sinkhorn coarse matching, backbone remat and the bfloat16 training
step of far_tpu_torch against the JAX package's, on the CPU.

Small configuration (``test_torch_modules.small_config``). Sinkhorn:
``log_sinkhorn`` and ``sinkhorn_confidence`` against
``far_tpu/models/matching.py``'s, ``FARLoFTR.match`` with
``match_type="sinkhorn"`` in eval and train mode, ``bin_score`` through
the weight converters, and one SGD step with the solver stubbed against
``make_train_step``. Remat: the same step under each ``cfg.remat``, its
gradients and BatchNorm statistics against the step without it. bfloat16:
the stubbed step of ``tests/test_torch_train.py`` with ``dtype=
"bfloat16"`` in both packages. Each tolerance is stated where it is
checked.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import far_tpu.train.trainer as jtrainer
import far_tpu_torch.train.trainer as ttrainer
from far_tpu.models import matching as jmatching
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.utils import config as jconfig
from far_tpu.utils.convert_weights import convert_loftr_state_dict
from far_tpu_torch.models import matching as tmatching
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.train.optim import OptimConfig
from far_tpu_torch.train.trainer import Trainer
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import (
    build_loftr_mapping,
    flax_to_state_dict,
    init_weights,
)
from test_torch_modules import small_config
from test_torch_train import _BACKBONE_STAGES, _fixed_estimate, _stub, pairs, rel_close, t

torch.set_num_threads(2)


def _configs(match_type="dual_softmax", **over):
    """(JAX config, port config) at the small widths."""
    return tuple(small_config(mod, match=mod.MatchConfig(max_matches=32, thr=0.0,
                                                         match_type=match_type), **over)
                 for mod in (jconfig, tconfig))


def _jax_variables(jcfg, sd, jb):
    """The JAX model's variables from the port's state dict. The JAX
    LoFTR converter has no bin_score entry (only SuperGlue's has), so the
    dustbin score is set here by hand."""
    jmodel = JFARLoFTR(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_loftr_state_dict(
        {f"matcher.{k}": v for k, v in sd.items() if k != "bin_score"}, zeros, jcfg)
    assert not report["missing"] and not report["unused"], report
    if "bin_score" in sd:
        assert "bin_score" in variables["params"]
        variables["params"]["bin_score"] = np.asarray(sd["bin_score"])
    return jmodel, variables


# ---- Sinkhorn ----------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 3])
def test_log_sinkhorn_and_confidence_match_jax(iters):
    """float32, B=2, L=7 != S=9: the log assignment (B, L+1, S+1) and the
    confidence (B, L, S) within 1e-5 max|ref| of JAX's."""
    rng = np.random.default_rng(iters)
    scores = rng.normal(size=(2, 7, 9)).astype(np.float32)
    bin_score = np.float32(0.7)
    ours = tmatching.log_sinkhorn(t(scores), torch.tensor(bin_score), iters)
    ref = jmatching.log_sinkhorn(jnp.asarray(scores), jnp.asarray(bin_score), iters)
    assert ours.shape == (2, 8, 10)
    rel_close(ours, ref, 1e-5, "log_sinkhorn")
    f0 = rng.normal(size=(2, 7, 16)).astype(np.float32)
    f1 = rng.normal(size=(2, 9, 16)).astype(np.float32)
    conf = tmatching.sinkhorn_confidence(t(f0), t(f1), torch.tensor(bin_score), iters)
    jconf = jmatching.sinkhorn_confidence(jnp.asarray(f0), jnp.asarray(f1),
                                          jnp.asarray(bin_score), iters)
    assert conf.dtype == torch.float32 and conf.shape == (2, 7, 9)
    rel_close(conf, jconf, 1e-5, "sinkhorn_confidence")


@pytest.fixture(scope="module")
def sinkhorn_pair():
    """A Sinkhorn FARLoFTR (init_weights, seed 0, bin_score moved off its
    initial 1.0), the JAX model with the same weights, two 64x64 pairs."""
    jcfg, tcfg = _configs("sinkhorn")
    model = FARLoFTR(tcfg)
    init_weights(model, 0)
    assert float(model.bin_score.detach()) == tcfg.match.skh_init_bin_score
    with torch.no_grad():
        model.bin_score.fill_(0.35)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    tb, jb = pairs((64, 64))
    jmodel, variables = _jax_variables(jcfg, sd, jb)
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, sd=sd, tb=tb, jb=jb,
                jmodel=jmodel, variables=variables)


@pytest.mark.parametrize("train", [False, True])
def test_sinkhorn_match_matches_jax(sinkhorn_pair, train):
    """FARLoFTR.match with match_type='sinkhorn' in eval and train mode:
    ids and validity equal JAX's, keypoints within 1e-4 max|ref|, the
    train-mode confidence matrix within 1e-4 max|ref| (None in eval, as
    JAX's): its inputs come through the backbone and the coarse stack
    ~1e-5 apart, and the exponential of the log assignment adds to that."""
    ctx = sinkhorn_pair
    model = ctx["model"].train(train)
    out = model.match(ctx["tb"])
    apply = functools.partial(ctx["jmodel"].apply, method=JFARLoFTR.match)
    if train:
        ref, _ = apply(ctx["variables"], ctx["jb"], True, mutable=["batch_stats"])
    else:
        ref = apply(ctx["variables"], ctx["jb"])
    m, jm = out.matches, ref.matches
    assert int(m.valid.sum()) >= 4
    for k in ("i_ids", "j_ids", "valid"):
        np.testing.assert_array_equal(getattr(m, k).numpy(), np.asarray(getattr(jm, k)), k)
    for k in ("mkpts0_f", "mkpts1_f", "mconf"):
        rel_close(getattr(m, k), getattr(jm, k), 1e-4, k)
    assert (out.conf_matrix is None) == (ref.conf_matrix is None) == (not train)
    if train:
        rel_close(out.conf_matrix, ref.conf_matrix, 1e-4, "conf_matrix")


def test_bin_score_converts_both_ways(sinkhorn_pair):
    """build_loftr_mapping has bin_score for Sinkhorn only; the state dict
    goes to the JAX tree through the mapping and back through
    flax_to_state_dict unchanged, and loads with strict=True."""
    ctx = sinkhorn_pair
    P, _ = build_loftr_mapping(ctx["tcfg"])
    assert ("bin_score", ("bin_score",)) in [(k, p) for k, p, _ in P]
    assert "bin_score" not in [k for k, _, _ in build_loftr_mapping(_configs()[1])[0]]
    params = jax.tree.map(np.asarray, ctx["variables"]["params"])
    for key, path, tf in P:
        node = params
        for p in path[:-1]:
            node = node[p]
        np.testing.assert_array_equal(node[path[-1]], tf(ctx["sd"][key]), err_msg=key)
    back = flax_to_state_dict({"params": params,
                               "batch_stats": ctx["variables"]["batch_stats"]}, ctx["tcfg"])
    assert back.keys() == ctx["sd"].keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, ctx["sd"][k], err_msg=k)
    fresh = FARLoFTR(ctx["tcfg"])
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)
    assert float(fresh.bin_score.detach()) == pytest.approx(0.35)


# ---- one stubbed SGD step against make_train_step -----------------------------


def _jax_stub_step(jmodel, variables, jb, est, key=jax.random.PRNGKey(3)):
    tx = optax.sgd(1.0)
    state = jtrainer.create_train_state(jmodel, variables, tx)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "estimate_pose", _stub(est, jnp.asarray))
    try:
        new, metrics = jax.jit(jtrainer.make_train_step(jmodel, tx))(state, jb, key)
    finally:
        mp.undo()
    return jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, metrics)


def _port_stub_step(tcfg, sd, tb, est, monkeypatch):
    trainer = Trainer(tcfg, device="cpu")
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=1.0)
    monkeypatch.setattr(ttrainer, "estimate_pose", _stub(est, t))
    return trainer, trainer.step(tb)


def _compare_step(trainer, metrics, sd, variables, jstate, jmetrics, tcfg, tol):
    """The losses and grad_norm, every parameter's delta (= -grad) and the
    running statistics against JAX's step; ``tol`` holds the relative
    tolerances: 'metrics', 'delta', 'backbone' (the stride-2 stages) and
    'stats'. A delta's tolerance adds one rounding of max|p| (SGD's p - g
    is rounded to p's ulp in both packages)."""
    for k, v in metrics.items():
        ref = float(jmetrics[k])
        assert abs(v - ref) <= tol["metrics"] * max(abs(ref), 1e-30), (k, v, ref)
    delta = jax.tree.map(lambda a, b: a - b, jstate.params, variables["params"])
    ref_delta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats}, tcfg)
    n_moved = 0
    for name, p in trainer.model.named_parameters():
        d = (p.detach() - torch.from_numpy(sd[name])).numpy()
        ref = ref_delta[name]
        rel = tol["backbone" if name.startswith(_BACKBONE_STAGES) else "delta"]
        atol = rel * float(np.abs(ref).max()) + 2.0 ** -23 * float(np.abs(sd[name]).max())
        np.testing.assert_allclose(d, ref, rtol=0, atol=atol, err_msg=name)
        n_moved += bool(np.abs(ref).max() > 0)
    assert n_moved > 0.9 * len(list(trainer.model.parameters()))
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jstate.batch_stats}, tcfg)
    for name, v in trainer.model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            rel_close(v, stats[name], tol["stats"], name)


# test_train_step_matches_jax's tolerances (tests/test_torch_train.py)
F32_TOL = dict(metrics=1e-4, delta=1e-4, backbone=5e-2, stats=1e-5)


def test_sinkhorn_train_step_matches_jax(sinkhorn_pair, monkeypatch):
    """One step with match_type='sinkhorn', the solver stubbed in both
    packages and SGD(lr=1), at test_train_step_matches_jax's tolerances:
    losses and grad_norm 1e-4 relative, deltas 1e-4 max|ref| (the
    backbone's stride-2 stages 5e-2), statistics 1e-5; bin_score's delta
    among them and nonzero."""
    ctx = sinkhorn_pair
    est = _fixed_estimate(2)
    jstate, jmetrics = _jax_stub_step(ctx["jmodel"], ctx["variables"], ctx["jb"], est)
    trainer, metrics = _port_stub_step(ctx["tcfg"], ctx["sd"], ctx["tb"], est, monkeypatch)
    assert metrics["loss_c"] > 0 and metrics["num_matches"] >= 2
    _compare_step(trainer, metrics, ctx["sd"], ctx["variables"], jstate, jmetrics,
                  ctx["tcfg"], F32_TOL)
    moved = float(trainer.model.bin_score.detach()) - float(ctx["sd"]["bin_score"])
    ref = float(jstate.params["bin_score"]) - float(ctx["sd"]["bin_score"])
    assert moved != 0.0 and abs(moved - ref) <= 1e-4 * abs(ref) + 2.0 ** -23


# ---- the bfloat16 step against JAX --------------------------------------------


def _stub_steps(dtype, monkeypatch):
    """(port metrics, JAX metrics, port deltas, JAX deltas) of the stubbed
    SGD step at the small widths in ``dtype``, from init_weights(seed 0)."""
    jcfg, tcfg = _configs(dtype=dtype)
    model = FARLoFTR(tcfg)
    init_weights(model, 0)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    tb, jb = pairs((64, 64))
    jmodel, variables = _jax_variables(jcfg, sd, jb)
    est = _fixed_estimate(2)
    jstate, jmetrics = _jax_stub_step(jmodel, variables, jb, est)
    trainer, metrics = _port_stub_step(tcfg, sd, tb, est, monkeypatch)
    delta = jax.tree.map(lambda a, b: a - b, jstate.params, variables["params"])
    jdelta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats}, tcfg)
    pdelta = {n: (p.detach() - torch.from_numpy(sd[n])).numpy()
              for n, p in trainer.model.named_parameters()}
    return metrics, {k: float(v) for k, v in jmetrics.items()}, pdelta, jdelta


def test_bf16_train_step_matches_jax(monkeypatch):
    """test_train_step_matches_jax's setup (small widths, the solver
    stubbed, SGD lr=1) with dtype='bfloat16' in both packages, and in
    float32 as the yardstick. Both packages round activations to bf16 (8
    bits of mantissa) where the same math is ordered differently, and a
    near-tie in the coarse match then picks another match (num_matches 2.5
    against 2.0 here), so per-element tolerances mean nothing. Held: the
    total loss within 1e-2 relative and each loss term within 5e-2 of
    JAX's bf16 step, num_matches within 1 a pair; and for the gradient of
    each part of the model (backbone, coarse transformer, fine stage,
    regressor, all) the relative L2 distance between the two packages'
    bf16 steps at most 1.5 x the larger of each package's own distance from
    its f32 step (two independent bf16 errors of that size are ~1.41 x
    apart; a fault of the port would add to that), while the f32 steps
    agree within 1e-4."""
    p32, j32, pd32, jd32 = _stub_steps("float32", monkeypatch)
    p16, j16, pd16, jd16 = _stub_steps("bfloat16", monkeypatch)
    assert abs(p16["loss"] - j16["loss"]) <= 1e-2 * abs(j16["loss"])
    for k in ("loss_c", "loss_f", "loss_rot", "loss_tr"):
        assert abs(p16[k] - j16[k]) <= 5e-2 * abs(j16[k]), (k, p16[k], j16[k])
    assert abs(p16["num_matches"] - j16["num_matches"]) <= 1.0

    def dist(a, b, names):
        a = np.concatenate([np.ravel(a[n]) for n in names])
        b = np.concatenate([np.ravel(b[n]) for n in names])
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    report = {}
    for part in ("backbone", "loftr_coarse", "fine", "loftr_regress", ""):
        names = sorted(n for n in pd16 if n.startswith(part))
        assert names
        f32 = dist(pd32, jd32, names)
        ours, jax_own, port_own = (dist(pd16, jd16, names), dist(jd16, jd32, names),
                                   dist(pd16, pd32, names))
        report[part or "all"] = (ours, jax_own, port_own, f32)
        assert f32 <= 1e-4 * (50 if part == "backbone" else 1), (part, f32)
        assert ours <= 1.5 * max(jax_own, port_own), (part, report[part or "all"])
    print("bf16 step: (port vs JAX, JAX bf16 vs f32, port bf16 vs f32, f32 port vs JAX)"
          " relative L2 of the gradients:", report, "losses", p16, j16)


# ---- remat ------------------------------------------------------------------


def _grads_and_stats(tcfg, sd, tb, est, monkeypatch):
    model_trainer = Trainer(tcfg, device="cpu")
    model_trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    monkeypatch.setattr(ttrainer, "estimate_pose", _stub(est, t))
    losses, _ = model_trainer.loss(tb)
    losses.total.backward()
    model = model_trainer.model
    return ({k: float(v.detach()) for k, v in losses.scalars().items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {n: v.clone() for n, v in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}, model)


@pytest.mark.parametrize("match_type", ["dual_softmax", "sinkhorn"])
@pytest.mark.parametrize("remat", [True, "full", "selective"])
def test_remat_step_equals_plain_step(remat, match_type, monkeypatch):
    """A float32 step's losses and every gradient under cfg.remat within
    1e-6 max|g| of the step without it; the running statistics within 1e-7
    (a second update in the backward's recompute would move them with
    momentum 0.81: ~4e-1 here); the model in eval gives the same match."""
    _, base = _configs(match_type)
    est = _fixed_estimate(2)
    tb, _ = pairs((64, 64))
    model = FARLoFTR(base)
    init_weights(model, 0)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    l0, g0, s0, m0 = _grads_and_stats(base, sd, tb, est, monkeypatch)
    cfg = dataclasses.replace(base, remat=remat)
    l1, g1, s1, m1 = _grads_and_stats(cfg, sd, tb, est, monkeypatch)
    assert l1.keys() == l0.keys() and g1.keys() == g0.keys()
    for k, v in l0.items():
        assert abs(l1[k] - v) <= 1e-6 * max(abs(v), 1e-30), k
    for n, g in g0.items():
        assert float((g1[n] - g).abs().max()) <= 1e-6 * float(g.abs().max()), n
    moved = 0.0
    for n, s in s0.items():
        assert float((s1[n] - s).abs().max()) <= 1e-7 * max(float(s.abs().max()), 1.0), n
        moved = max(moved, float((s - torch.from_numpy(sd[n])).abs().max()))
    assert moved > 1e-3   # the statistics did move, once
    with torch.no_grad():
        a, b = m0.eval().match(tb).matches, m1.eval().match(tb).matches
    for k in ("i_ids", "j_ids", "valid", "mkpts1_f"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("remat", [True, "selective"])
def test_remat_train_step_matches_plain(remat):
    """The counterpart of tests/test_train.py's remat test: one AdamW step
    (lr 1e-4) of 8 pairs with the real 8-point solver and the same draws,
    loss within 1e-4 and grad_norm within 1e-3 relative of the plain
    step's."""
    rng = np.random.default_rng(0)
    B, H, W = 8, 64, 64
    T = torch.eye(4).expand(B, 4, 4).contiguous()
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]).expand(B, 3, 3).contiguous()
    batch = PairBatch(image0=t(rng.uniform(size=(B, H, W, 1)).astype(np.float32)),
                      image1=t(rng.uniform(size=(B, H, W, 1)).astype(np.float32)),
                      K0=K, K1=K, T_0to1=T, T_1to0=T,
                      depth0=torch.full((B, H, W), 2.0), depth1=torch.full((B, H, W), 2.0))

    def one_step(remat):
        cfg = small_config(tconfig, remat=remat)
        trainer = Trainer(cfg, OptimConfig(lr=1e-4, warmup_steps=0, scheduler="none"),
                          device="cpu").init(seed=0)
        m = trainer.step(batch, generator=torch.Generator().manual_seed(0))
        return m["loss"], m["grad_norm"]

    loss_p, gn_p = one_step(False)
    loss_r, gn_r = one_step(remat)
    assert np.isfinite(loss_r)
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-4)
    np.testing.assert_allclose(gn_r, gn_p, rtol=1e-3)
