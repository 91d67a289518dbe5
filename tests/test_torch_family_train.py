"""far_tpu_torch's ViTEss and map-free 6DReg training against far_tpu's.

The same inputs, made with numpy from seeds, go through both packages:
the dataset wrappers and collates (bit-equal), the rotation functions the
losses use, every map-free loss and ``combined_loss``, the presets, and
one step of each family trainer against ``far_tpu.train.family_trainers``
from identical weights (a state dict synthesized for the port and
converted for JAX, as ``tests/test_torch_vitess.py`` and
``tests/test_torch_sixdreg.py`` do). Sizes are the JAX family test's
small configurations (``tests/test_family_training.py``) at 64x64 in
float32, except ``d_im``: the JAX package's map-free layers take their
width from the head (256 channels) whatever ``d_im`` says, the port's from
``d_im``, so both run 256. Each tolerance is stated where it is checked.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import far_tpu.train.family_trainers as jfam
import far_tpu_torch.train.family_trainers as tfam
from far_tpu import configs as jconfigs
from far_tpu.data import datasets as jdatasets
from far_tpu.geometry import rotations as jrot
from far_tpu.train import mapfree_losses as jlosses
from far_tpu_torch import configs as tconfigs
from far_tpu_torch.data import synthetic as tdata
from far_tpu_torch.geometry import rotations as trot
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.vitess import ViTEss
from far_tpu_torch.train import checkpoint as tckpt
from far_tpu_torch.train import mapfree_losses as tlosses
from far_tpu_torch.train.optim import OptimConfig
from far_tpu_torch.utils.convert_weights import flax_to_state_dict
from test_torch_sixdreg import sixdreg_pair
from test_torch_vitess import vitess_pair

torch.set_num_threads(2)
HW = (64, 64)
# the JAX family test's small ViTEss (dim 48, depth 2, 3 heads, fc 64)
VITESS_SMALL = dict(depth=2)
# and its small map-free model (d_im 256, see the module note)
SIXDREG_SMALL = dict(image_hw=HW, hidden=64, transformer_heads=2)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_close(out, ref, rel, what=""):
    """|out - ref| <= rel * max|ref| elementwise."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))


# ---- datasets and collates --------------------------------------------------


def _datasets(kind, tmp_path=None, n=3):
    """(port dataset, JAX dataset) of one wrapper over synthetic pairs."""
    pair = lambda mod: mod.SyntheticPairDataset(n=n, hw=HW, seed=1)
    if kind == "gt_corr":
        mk = lambda mod: mod.GTCorrespondenceDataset(pair(mod), max_matches=64,
                                                     outlier_pct=0.25, seed=2)
    elif kind == "solver_pose":
        mk = lambda mod: mod.SolverPoseDataset(pair(mod), seed=3)
    else:
        rng = np.random.default_rng(4)
        path = tmp_path / "poses.npz"
        np.savez(path, rt=rng.normal(size=(n, 3, 4)), num_corr=rng.integers(0, 400, n))
        mk = lambda mod: mod.SolverPoseDataset(pair(mod), pose_npz=path)
    return mk(tdata), mk(jdatasets)


@pytest.mark.parametrize("kind", ["gt_corr", "solver_pose", "solver_pose_npz"])
def test_dataset_wrappers_equal_jax(kind, tmp_path):
    """Every field of every sample bit-equal to the JAX package's."""
    ours, ref = _datasets(kind, tmp_path)
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
            else:
                assert a[k] == b[k], (i, k)
    if kind == "gt_corr":
        assert ours[0]["corr_valid"].sum() > 30


def _rgb_sample(s, seed):
    s = dict(s)
    rng = np.random.default_rng(seed)
    for k in ("image0", "image1"):
        s[f"{k}_rgb"] = rng.random((*HW, 3)).astype(np.float32)
    return s


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_collates_equal_jax(rgb):
    """collate_vitess (gated and not) and collate_sixdreg bit-equal to
    JAX's, with _rgb's grayscale tiling or the samples' own RGB."""
    fix = (lambda s, i: _rgb_sample(s, i)) if rgb else (lambda s, i: s)
    for kind, ours_fn, ref_fn in (("solver_pose", tfam.collate_vitess, jfam.collate_vitess),
                                  ("gt_corr", tfam.collate_sixdreg, jfam.collate_sixdreg)):
        ds, _ = _datasets(kind)
        samples = [fix(ds[i], i) for i in range(3)]
        variants = [samples]
        if kind == "solver_pose":  # one sample without a solver pose: ungated
            variants.append(samples[:2] + [tdata.SyntheticPairDataset(n=3, hw=HW, seed=1)[2]])
        for batch_samples in variants:
            ours, ref = ours_fn(batch_samples, "cpu"), ref_fn(batch_samples)
            for f in dataclasses.fields(ref):
                a, b = getattr(ours, f.name), getattr(ref, f.name)
                if b is None:
                    assert a is None, f.name
                    continue
                b = np.asarray(b)
                assert a.device.type == "cpu"
                assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), f.name


# ---- rotations ----------------------------------------------------------------


def _branch_rotations():
    """Rotations whose largest Shepperd pivot is each of the four: near the
    identity (trace), and 180 deg and 179.9 deg about axes near x, y, z,
    plus random ones."""
    rng = np.random.default_rng(5)
    out = [np.eye(3), random_rotations(rng, 1)[0] @ np.diag([1, 1, 1])]
    for axis in np.eye(3):
        for ang in (np.pi, np.radians(179.9)):
            a = axis + 0.05 * rng.normal(size=3)
            a /= np.linalg.norm(a)
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            out.append(np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K)
    out = np.concatenate([np.stack(out), random_rotations(rng, 16)])
    return out.astype(np.float32)


def test_matrix_to_quaternion_all_branches():
    """matrix_to_quaternion within 1e-6 of JAX's on rotations that take
    each of its four branches (near 180 deg included), and back through
    quaternion_to_matrix."""
    R = _branch_rotations()
    q = trot.matrix_to_quaternion(t(R))
    ref = np.asarray(jrot.matrix_to_quaternion(jnp.asarray(R)))
    m = R
    pivots = np.stack([m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                       -m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], -m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]])
    assert set(pivots.argmax(0)) == {0, 1, 2, 3}
    np.testing.assert_allclose(q.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trot.quaternion_to_matrix(q).numpy(), R, rtol=0, atol=1e-5)


def test_rotation_functions_match_jax():
    """quaternion_to_matrix (unnormalised input), rotation_angle,
    geodesic_distance and so3_project (with the det(U V^T) = -1 sign fix)
    within 1e-6 of JAX's."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(32, 4)).astype(np.float32) * 3
    rel_close(trot.quaternion_to_matrix(t(q)), jrot.quaternion_to_matrix(jnp.asarray(q)), 1e-6)
    R1, R2 = _branch_rotations(), random_rotations(rng, len(_branch_rotations()))
    rel_close(trot.rotation_angle(t(R1)), jrot.rotation_angle(jnp.asarray(R1)), 1e-6)
    rel_close(trot.geodesic_distance(t(R1), t(R2)),
              jrot.geodesic_distance(jnp.asarray(R1), jnp.asarray(R2)), 1e-6)
    M = np.concatenate([rng.normal(size=(16, 3, 3)),
                        R2[:8] + 0.1 * rng.normal(size=(8, 3, 3))]).astype(np.float32)
    flips = np.linalg.det(M) < 0
    assert flips.any() and (~flips).any()
    out = trot.so3_project(t(M))
    rel_close(out, jrot.so3_project(jnp.asarray(M)), 1e-6)
    assert np.allclose(np.linalg.det(out.numpy()), 1.0, atol=1e-5)


# ---- map-free losses --------------------------------------------------------


def _loss_inputs(name, seed=7, B=6):
    rng = np.random.default_rng(seed)
    if name == "rot_bin_loss":
        logits = rng.normal(size=(B, 900)).astype(np.float32) * 2
        euler = np.stack([rng.uniform(-179, 179, B), rng.uniform(-89, 89, B),
                          rng.uniform(-179, 179, B)], -1).astype(np.float32)
        euler[0] = (179.5, 0.5, -180.4)   # ties to even and the edges
        return logits, euler
    if name.startswith("rot"):
        return random_rotations(rng, B), random_rotations(rng, B)
    return (rng.normal(size=(B, 3)).astype(np.float32),
            rng.normal(size=(B, 3)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(jlosses.ROT_LOSSES) + sorted(jlosses.TRANS_LOSSES))
def test_loss_matches_jax(name):
    """Each registered loss within 1e-6 relative of JAX's, and the
    registries hold the same names."""
    assert sorted(tlosses.ROT_LOSSES) == sorted(jlosses.ROT_LOSSES)
    assert sorted(tlosses.TRANS_LOSSES) == sorted(jlosses.TRANS_LOSSES)
    reg_t = {**tlosses.ROT_LOSSES, **tlosses.TRANS_LOSSES}
    reg_j = {**jlosses.ROT_LOSSES, **jlosses.TRANS_LOSSES}
    a, b = _loss_inputs(name)
    ours = reg_t[name](t(a), t(b))
    ref = reg_j[name](jnp.asarray(a), jnp.asarray(b))
    assert float(ref) > 0
    rel_close(ours, ref, 1e-6, name)


@pytest.mark.parametrize("lam", [1.0, 0.0])
def test_combined_loss_matches_jax(lam):
    """combined_loss's total and parts within 1e-6 relative, and with
    lam = 0 the gradients of s_r and s_t (and of the predictions, both
    branches) within 1e-6 of jax.grad's."""
    rng = np.random.default_rng(8)
    Rp, Rg = random_rotations(rng, 4), random_rotations(rng, 4)
    tp, tg = rng.normal(size=(2, 4, 3)).astype(np.float32)
    s = np.array([0.3, -0.2], np.float32)

    def jtotal(Rp, tp, s):
        kw = dict(s_r=s[0], s_t=s[1]) if lam == 0.0 else {}
        return jlosses.combined_loss(Rp, tp, jnp.asarray(Rg), jnp.asarray(tg), lam=lam, **kw)

    (ref, ref_parts), ref_grads = jax.value_and_grad(jtotal, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(s))
    args = [t(Rp).requires_grad_(), t(tp).requires_grad_(), t(s).requires_grad_()]
    kw = dict(s_r=args[2][0], s_t=args[2][1]) if lam == 0.0 else {}
    total, parts = tlosses.combined_loss(args[0], args[1], t(Rg), t(tg), lam=lam, **kw)
    rel_close(total, ref, 1e-6, "total")
    for k in ("rot_loss", "trans_loss"):
        rel_close(parts[k], ref_parts[k], 1e-6, k)
    total.backward()
    for a, g, what in zip(args, ref_grads, ("R_pred", "t_pred", "s_r, s_t")):
        if lam != 0.0 and what == "s_r, s_t":
            assert a.grad is None
            continue
        rel_close(a.grad, g, 1e-6, what)
    if lam == 0.0:
        with pytest.raises(ValueError, match="s_r and s_t"):
            tlosses.combined_loss(args[0], args[1], t(Rg), t(tg), lam=0.0)


# ---- presets ------------------------------------------------------------------


@pytest.mark.parametrize("preset,args", [("matterport", ()), ("interiornet", ()),
                                         ("interiornet", ("",)), ("streetlearn", ()),
                                         ("streetlearn", ("",)), ("mapfree", ())])
def test_presets_equal_jax(preset, args):
    """Every field of each preset, nested configurations and curricula
    included, equal to the JAX package's; the same preset names."""
    assert tconfigs.PRESETS.keys() == jconfigs.PRESETS.keys()
    ours, ref = tconfigs.PRESETS[preset](*args), jconfigs.PRESETS[preset](*args)
    assert type(ours.model).__name__ == type(ref.model).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


# ---- one train step against far_tpu.train.family_trainers ----------------------


def _estimate(B):
    """A solver result independent of the correspondences, for both
    packages' stubs (fields of both PoseEstimates)."""
    rng = np.random.default_rng(12)
    c, s = np.cos(0.2), np.sin(0.2)
    R = np.tile(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)[None], (B, 1, 1))
    return dict(R=R, t=np.tile(np.array([0.3, -0.1, 0.9], np.float32), (B, 1)),
                num_inliers=rng.integers(5, 40, B).astype(np.float32),
                num_tight=rng.integers(0, 5, B).astype(np.float32),
                num_ultra_tight=np.zeros(B, np.float32))


def _stub(est, conv):
    fields = {k: conv(v) for k, v in est.items()}
    return lambda *a, **kw: types.SimpleNamespace(**fields)


def _vitess_batches(gated, B=2):
    ds = tdata.SyntheticPairDataset(n=B, hw=HW, seed=0)
    if gated:
        ds = tdata.SolverPoseDataset(ds, seed=0)
    samples = [ds[i] for i in range(B)]
    return tfam.collate_vitess(samples, "cpu"), jfam.collate_vitess(samples)


def _sixdreg_batches(B=2, **kw):
    ds = tdata.GTCorrespondenceDataset(tdata.SyntheticPairDataset(n=B, hw=HW, seed=0),
                                       max_matches=128, **kw)
    samples = [ds[i] for i in range(B)]
    return tfam.collate_sixdreg(samples, "cpu"), jfam.collate_sixdreg(samples)


def _jax_state(jtr, variables, extra=()):
    """The JAX trainer's state from converted variables, with SGD(lr=1)."""
    jtr.tx = optax.sgd(1.0)
    params = {**variables["params"], **{k: jnp.zeros((), jnp.float32) for k in extra}}
    return jtr._make_state({**variables, "params": params})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cache():
    """Results that several tests share: the synthesized weights and the
    JAX package's steps, each made once."""
    return {}


def _cached(cache, key, make):
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _pair(cache, family, variant):
    """(JAX config, JAX variables as numpy, port config, port state dict)
    from one synthesized state dict; ViTEss gated or not by ``variant``,
    the map-free model the same for every lam."""
    def make():
        if family == "vitess":
            jmodel, variables, port, _ = vitess_pair(use_loftr_gating=variant, **VITESS_SMALL)
            jcfg = jmodel.config
        else:
            jmodel, variables, port, _ = sixdreg_pair(**SIXDREG_SMALL)
            jcfg = jmodel.cfg
        return jcfg, _np_tree(variables), port.config, port.state_dict()
    return _cached(cache, ("pair", family, variant if family == "vitess" else None), make)


def _setup(cache, family, variant, monkeypatch, stub=True):
    """(port trainer with the synthesized weights, JAX trainer, port batch,
    JAX batch, the JAX variables, the stubbed solver estimate or None).
    ``variant``: gated (ViTEss) or lam (6DReg); with ``stub`` the map-free
    solver is stubbed to the same fixed estimate in both packages."""
    jcfg, variables, tcfg, sd = _pair(cache, family, variant)
    est = None
    if family == "vitess":
        jtr = jfam.ViTEssTrainer(jcfg, devices=jax.devices()[:1])
        ttr = tfam.ViTEssTrainer(tcfg, device="cpu")
        tb, jb = _vitess_batches(variant)
    else:
        jtr = jfam.SixDRegTrainer(jcfg, lam=variant, devices=jax.devices()[:1])
        ttr = tfam.SixDRegTrainer(tcfg, lam=variant, device="cpu")
        tb, jb = _sixdreg_batches()
        if stub:
            est = _estimate(2)
            monkeypatch.setattr(jfam, "estimate_pose", _stub(est, jnp.asarray))
            monkeypatch.setattr(tfam, "estimate_pose", _stub(est, t))
    ttr.model.load_state_dict(sd, strict=True)
    return ttr, jtr, tb, jb, variables, est


def _jax_step(cache, family, variant, jtr, jb, variables):
    """The JAX trainer's step with SGD(lr=1) (state, metrics as numpy),
    once per (family, variant)."""
    extra = ("s_r", "s_t") if family == "sixdreg" and variant == 0.0 else ()

    def make():
        state, metrics = jtr.step(_jax_state(jtr, variables, extra), jb,
                                  jax.random.PRNGKey(3))
        return _np_tree(state), _np_tree(metrics)
    return _cached(cache, ("step", family, variant), make)


def _run_both(cache, family, variant, monkeypatch):
    """(port trainer after one SGD(lr=1) step, its metrics, the JAX step's
    state and metrics, the starting variables, the starting port model)."""
    ttr, jtr, tb, jb, variables, _ = _setup(cache, family, variant, monkeypatch)
    extra = ("s_r", "s_t") if family == "sixdreg" and variant == 0.0 else ()
    assert sorted(ttr.extra) == sorted(extra)
    jstate, jmetrics = _jax_step(cache, family, variant, jtr, jb, variables)
    port = type(ttr.model)(ttr.model.config)
    port.load_state_dict(ttr.model.state_dict())
    ttr.optimizer = torch.optim.SGD(ttr.parameters(), lr=1.0)
    metrics = ttr.step(tb)
    return ttr, metrics, jstate, jmetrics, variables, port


# Tolerances of a parameter's delta, relative to max|ref|, where 1e-4 is
# below the JAX package's own float32 error: test_step_grads_against_jax_
# float64 measures JAX's float32 gradient and the port's against JAX's
# float64 one on the CPU (it prints the largest of each), and each
# tolerance is the sum of the two, rounded up. ViTEss at B=2: in the
# ResNet18 trunk and the RAFT block JAX's error reaches 1.9e-2
# (layer2.0.conv2, alone) and the port's 1.0e-3 (layer1.1.bn2, gated),
# held to 3e-2; past the trunk JAX's reaches 1.44e-4 (pos_embed, gated)
# and the port's 2.7e-5, held to 2e-4. Map-free: through the ResUNet's
# stem, encoder1 and encoder2.0 JAX's reaches 5.81e-3 and the port's
# 5.80e-3 (encoder2.0.conv2: both float32 runs are that far from float64
# there), held to 1.2e-2; every later tensor to 1e-4 (JAX 5.03e-5, the
# port 2.09e-5).
STEP_TOL = {"vitess": ((("resnet.", "extractor_final_conv."), 3e-2), ((), 2e-4)),
            "sixdreg": ((("encoder.firstconv.", "encoder.firstbn.", "encoder.encoder1.",
                          "encoder.encoder2.0."), 1.2e-2), ((), 1e-4))}
# convolution biases that feed a train-mode BatchNorm: their gradient is 0
# in exact arithmetic (the normalisation removes them), so each package's
# is rounding noise; held to 1e-5 of the convolution weight's largest
ZERO_GRAD = ViTEss.BIAS_BEFORE_BN + MapfreeRegression.BIAS_BEFORE_BN


def step_tol(family, name):
    for prefixes, rel in STEP_TOL[family]:
        if not prefixes or name.startswith(prefixes):
            return rel


def _check_step(family, ttr, metrics, jstate, jmetrics, variables, port):
    """Losses and grad_norm within 1e-4 relative; every parameter's delta
    (= -grad under SGD(1)) within step_tol * max|ref delta| + one ulp of
    max|p| (SGD's p - g is rounded to p's ulp in both packages), the
    ZERO_GRAD biases' deltas in both packages below 1e-5 of their weight's;
    s_r and s_t within 1e-4 relative; the running statistics within 1e-5
    relative."""
    assert metrics.keys() == set(jmetrics.keys())
    for k, v in jmetrics.items():
        rel_close(np.float64(metrics[k]), np.float64(v), 1e-4, k)
    rel_close(np.float64(metrics["grad_norm"]), np.float64(jmetrics["grad_norm"]), 1e-4,
              "grad_norm")
    cfg = port.config
    model_keys = [k for k in jstate.params if k not in ("s_r", "s_t")]
    delta = {k: jax.tree.map(np.subtract, jstate.params[k], variables["params"][k])
             for k in model_keys}
    ref_delta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats}, cfg)
    start = port.state_dict()
    ours = {name: (p.detach() - start[name]).numpy()
            for name, p in ttr.model.named_parameters()}
    n_moved = 0
    for name, d in ours.items():
        ref = ref_delta[name]
        ulp = 2.0 ** -23 * float(start[name].abs().max())
        if name in ZERO_GRAD:
            scale = 1e-5 * float(np.abs(ref_delta[name[:-4] + "weight"]).max()) + ulp
            assert np.abs(d).max() <= scale and np.abs(ref).max() <= scale, name
            continue
        np.testing.assert_allclose(d, ref, rtol=0, err_msg=name,
                                   atol=step_tol(family, name) * float(np.abs(ref).max()) + ulp)
        n_moved += bool(np.abs(ref).max() > 0)
    assert n_moved > 0.9 * len(ours)
    for k, p in ttr.extra.items():
        assert abs(float(jstate.params[k])) > 0, k
        rel_close(p.detach(), jstate.params[k], 1e-4, k)
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jstate.batch_stats}, cfg)
    new_sd = ttr.model.state_dict()
    names = [n for n in new_sd if n.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        rel_close(new_sd[name], stats[name], 1e-5, name)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64: put in place of a
    JAX module's ``jnp`` (x64 on), its compute dtype and its casts are
    float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


_F64_MODULES = ("far_tpu.models.vitess", "far_tpu.models.regressor",
                "far_tpu.models.attention", "far_tpu.ops.bilinear_attention",
                "far_tpu.models.sixdreg", "far_tpu.train.family_trainers",
                "far_tpu.train.mapfree_losses", "far_tpu.geometry.rotations")


def _port_float64_grads(cache, family, variant, est, monkeypatch):
    """The port's gradients of the same step under ``float64_compute`` (the
    model made float64, the batch collated and the solver's stubbed
    estimate made inside the mode), as numpy."""
    from far_tpu_torch.utils.float64 import float64_compute

    trainer = _setup(cache, family, variant, monkeypatch)[0]
    trainer.model.double()
    with float64_compute():
        if est is not None:
            monkeypatch.setattr(tfam, "estimate_pose", _stub(est, t))
        batch = (_vitess_batches(variant) if family == "vitess" else _sixdreg_batches())[0]
        loss, _ = trainer.loss(batch)
        loss.backward()
    grads = {n: p.grad.numpy() for n, p in trainer.model.named_parameters()}
    assert {g.dtype for g in grads.values()} == {np.dtype(np.float64)}
    return grads


@pytest.mark.parametrize("family,variant", [("vitess", False), ("vitess", True),
                                            ("sixdreg", 1.0)],
                         ids=["vitess-alone", "vitess-gated", "sixdreg"])
def test_step_grads_against_jax_float64(family, variant, monkeypatch, cache):
    """The loss's gradients in float32, the port's and the JAX package's,
    against the JAX package run in float64 (x64 on, its modules' float32
    read as float64; the solver stubbed): past the trunk (STEP_TOL) the
    port's within 5e-5 of max|ref| (measured 2.1e-5 to 2.7e-5); in the
    trunk no further than 1.5x JAX's own float32 error on the same tensor,
    or 5e-5. The ZERO_GRAD biases' float64
    gradient is below 1e-12 of max|weight grad|. These measurements set
    STEP_TOL. The port run in float64 (``float64_compute``, which
    chip_smoke.py's phase 13 (c) uses to hold the card to the CPU) is
    within 2e-5 of JAX's float64 gradient, 1e-12 for the ZERO_GRAD
    biases (measured 1.8e-6 to 4.2e-6: the two float64 runs differ in
    more than rounding, e.g. constants kept in float32, but by 10^2 to
    10^4 less than either float32 run)."""
    import importlib

    trainer, jtr, tb, jb, variables, est = _setup(cache, family, variant, monkeypatch)
    key = jax.random.PRNGKey(3)
    # JAX's float32 gradient: minus its SGD(lr=1) step's delta (exact to an
    # ulp of the parameter, below 1e-7 of max|g| here)
    jstate, _ = _jax_step(cache, family, variant, jtr, jb, variables)
    neg = jax.tree.map(np.subtract, variables["params"],
                       {k: jstate.params[k] for k in variables["params"]})
    g32 = flax_to_state_dict({"params": neg, "batch_stats": variables["batch_stats"]},
                             trainer.model.config)
    loss, _ = trainer.loss(tb)
    loss.backward()
    jax.config.update("jax_enable_x64", True)
    try:
        for m in _F64_MODULES:
            monkeypatch.setattr(importlib.import_module(m), "jnp", _Float64Numpy())
        if est is not None:
            monkeypatch.setattr(jfam, "estimate_pose",
                                _stub(est, lambda a: jnp.asarray(a, jnp.float64)))
        f64 = lambda tree: jax.tree.map(
            lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a,
            tree)
        g64 = _np_tree(jax.jit(jax.grad(jtr._loss, has_aux=True))(
            f64(variables["params"]), f64(variables["batch_stats"]), f64(jb), key)[0])
    finally:
        jax.config.update("jax_enable_x64", False)
    g64 = flax_to_state_dict({"params": g64, "batch_stats": variables["batch_stats"]},
                             trainer.model.config)
    port64 = _port_float64_grads(cache, family, variant, est, monkeypatch)
    trunk = STEP_TOL[family][0][0]
    worst = {}   # (in the trunk, whose) -> (relative error, tensor)
    for name, p in trainer.model.named_parameters():
        ref = g64[name]
        if name in ZERO_GRAD:
            w = np.abs(g64[name[:-4] + "weight"]).max()
            assert np.abs(ref).max() <= 1e-12 * w, name
            assert np.abs(port64[name]).max() <= 1e-12 * w, name
            continue
        scale = float(np.abs(ref).max())
        err64 = float(np.abs(port64[name] - ref).max()) / scale
        worst["float64", "port"] = max(worst.get(("float64", "port"), (0.0, "")), (err64, name))
        assert err64 <= 2e-5, (name, err64)
        ours = float(np.abs(p.grad.numpy() - ref).max()) / scale
        theirs = float(np.abs(g32[name] - ref).max()) / scale
        in_trunk = name.startswith(trunk)
        for who, err in (("port", ours), ("jax", theirs)):
            worst[in_trunk, who] = max(worst.get((in_trunk, who), (0.0, "")), (err, name))
        bound = max(5e-5, 1.5 * theirs) if in_trunk else 5e-5
        assert ours <= bound, (name, ours, theirs)
    where = {True: "trunk", False: "past the trunk", "float64": "float64_compute"}
    print(f"{family} {variant}: against JAX's float64, the largest relative errors: "
          + "; ".join(f"{where[k[0]]} {k[1]} {v[0]:.3g} ({v[1]})"
                      for k, v in sorted(worst.items(), key=str)))


@pytest.mark.parametrize("gated", [False, True], ids=["alone", "gated"])
def test_vitess_step_matches_jax(gated, monkeypatch, cache):
    """One ViTEssTrainer step at B=2 against JAX's from the same weights,
    SGD(lr=1): see _check_step. ``norm3`` (also ``downsample.1``) moves
    its statistics once and is updated once."""
    ttr, metrics, jstate, jmetrics, variables, port = _run_both(cache, "vitess", gated, monkeypatch)
    _check_step("vitess", ttr, metrics, jstate, jmetrics, variables, port)
    raft = ttr.model.extractor_final_conv
    assert raft.norm3 is raft.downsample[1]


@pytest.mark.parametrize("lam", [1.0, 0.0])
def test_sixdreg_step_matches_jax(lam, monkeypatch, cache):
    """One SixDRegTrainer step at B=2 with the solver stubbed to the same
    fixed estimate in both packages, SGD(lr=1): see _check_step; with
    lam = 0, s_r and s_t (the trainer's, not the model's) move as JAX's
    extra leaves do, and the model's state dict has no such key."""
    ttr, metrics, jstate, jmetrics, variables, port = _run_both(cache, "sixdreg", lam, monkeypatch)
    _check_step("sixdreg", ttr, metrics, jstate, jmetrics, variables, port)
    assert not {"s_r", "s_t"} & {k.split(".")[-1] for k in ttr.model.state_dict()}
    MapfreeRegression(port.config).load_state_dict(ttr.model.state_dict(), strict=True)


def test_sixdreg_step_real_solver(cache):
    """The MAGSAC round inside the step, the port fed the uniforms the JAX
    trainer draws from its key (estimate_pose hands the key to
    prior_ransac unsplit), on GT correspondences of rigid scenes: the
    solver's mean inlier count equal, the losses and grad_norm within 1e-4
    relative of JAX's step."""
    ttr, jtr, tb, jb, variables, _ = _setup(cache, "sixdreg", 1.0, None, stub=False)
    key = jax.random.PRNGKey(9)
    _, jmetrics = jtr.step(_jax_state(jtr, variables), jb, key)
    ttr.optimizer = torch.optim.SGD(ttr.parameters(), lr=1.0)
    n, S, _ = ttr.solver_cfg.ransac_config(False).sampling()
    uniforms = t(jax.random.uniform(key, (2, n, S)))
    metrics = ttr.step(tb, uniforms=uniforms)
    assert metrics["solver_inliers"] == float(jmetrics["solver_inliers"]) > 50
    for k in ("loss", "loss_rot", "loss_tr", "grad_norm"):
        rel_close(np.float64(metrics[k]), np.float64(jmetrics[k]), 1e-4, k)


@pytest.mark.parametrize("family", ["vitess", "sixdreg"])
def test_eval_step_matches_jax(family, monkeypatch, cache):
    """eval_step (the model in eval mode, running statistics) within 1e-4
    relative of JAX's eval_step, and nothing of the trainer changes:
    parameters, statistics, step count, optimizer count."""
    ttr, jtr, tb, jb, variables, _ = _setup(cache, family,
                                             True if family == "vitess" else 1.0, monkeypatch)
    jmetrics = jtr.eval_step(_jax_state(jtr, variables), jb, jax.random.PRNGKey(3))
    before = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    metrics = ttr.eval_step(tb)
    assert metrics.keys() == set(jmetrics.keys())
    for k, v in jmetrics.items():
        rel_close(np.float64(metrics[k]), np.float64(v), 1e-4, k)
    for k, v in ttr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert ttr.model.training and ttr.step_count == 0 and ttr.optimizer.count == 0


def test_pooling_path_batchnorm_momentum():
    """ViTEss's pooling path (fusion_transformer=False) has Flax's default
    BatchNorm momentum 0.99 (far_tpu/models/vitess.py pool_bn1/2), the
    other BatchNorms 0.9: one train-mode update of each kind within 1e-6
    of flax.linen.BatchNorm's."""
    import flax.linen as fnn

    from far_tpu_torch.models.backbone import bn
    from far_tpu_torch.models.vitess import ViTEssConfig

    model = ViTEss(ViTEssConfig(dim=48, depth=2, fusion_transformer=False,
                                pool_size=4, dtype="float32")).train()
    x = np.random.default_rng(9).normal(size=(2, 16, 5, 5)).astype(np.float32) * 2 + 1
    for module, momentum in ((model.pool_transformer_output[1], 0.99),
                             (model.resnet.bn1, 0.9)):
        module = type(module)(16, momentum=module.momentum).train()
        with torch.no_grad():
            module.running_mean.normal_()
            module.running_var.uniform_(0.5, 2.0)
        # copies: bn updates the torch buffers in place
        stats = {"mean": jnp.asarray(module.running_mean.numpy().copy()),
                 "var": jnp.asarray(module.running_var.numpy().copy())}
        y = bn(t(x), module)
        params = {"scale": jnp.ones(16), "bias": jnp.zeros(16)}
        ref, upd = fnn.BatchNorm(use_running_average=False, momentum=momentum).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x.transpose(0, 2, 3, 1)),
            mutable=["batch_stats"])
        rel_close(y.permute(0, 2, 3, 1), ref, 1e-5, "output")
        rel_close(module.running_mean, upd["batch_stats"]["mean"], 1e-6, "mean")
        rel_close(module.running_var, upd["batch_stats"]["var"], 1e-6, "var")


# ---- checkpoints, the device rule ------------------------------------------------


def test_checkpoint_round_trip_with_kendall_cipolla(tmp_path):
    """Two lam = 0 steps, save through CheckpointManager, restore into a
    fresh trainer: the same model state, s_r and s_t, optimizer state and
    step, and the next step gives the same metrics."""
    cfg = SixDRegConfig(dtype="float32", encoder_blocks=(1, 1, 1), encoder_out_layers=8,
                        transformer_layers=1, **SIXDREG_SMALL)
    opt = OptimConfig(lr=1e-3, warmup_steps=0, scheduler="none")
    tb, _ = _sixdreg_batches()
    gen = lambda: torch.Generator().manual_seed(5)
    a = tfam.SixDRegTrainer(cfg, opt, lam=0.0, device="cpu").init(seed=1)
    for _ in range(2):
        a.step(tb, generator=gen())
    assert all(abs(float(p)) > 0 for p in a.extra.values())
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    mgr.save(a.step_count, a.state_dict(), {"loss": 1.0})
    b = tfam.SixDRegTrainer(cfg, opt, lam=0.0, device="cpu")
    b.load_state_dict(tckpt.CheckpointManager(tmp_path / "ckpt").restore())
    assert b.step_count == 2 and b.optimizer.count == a.optimizer.count == 2
    for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), n
    for k in ("s_r", "s_t"):
        assert torch.equal(a.extra[k], b.extra[k]), k
    assert a.step(tb, generator=gen()) == b.step(tb, generator=gen())
    with pytest.raises(KeyError, match="s_r"):
        tfam.SixDRegTrainer(cfg, opt, lam=1.0, device="cpu").load_state_dict(a.state_dict())


def test_trainers_need_a_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from far_tpu_torch.models.vitess import ViTEssConfig

    small_v = ViTEssConfig(dim=48, depth=2, num_heads=3, fc_hidden=64, dtype="float32")
    small_s = SixDRegConfig(dtype="float32", encoder_blocks=(1, 1, 1), encoder_out_layers=8,
                            transformer_layers=1, **SIXDREG_SMALL)
    for make in (lambda **kw: tfam.ViTEssTrainer(small_v, **kw),
                 lambda **kw: tfam.SixDRegTrainer(small_s, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        tr = make(device="cpu")
        assert next(tr.model.parameters()).device.type == "cpu" and tr.model.training
    tb, _ = _vitess_batches(False)
    tr = tfam.ViTEssTrainer(small_v, device="cpu")
    tb.images = tb.images.to("meta")
    with pytest.raises(ValueError, match="batch on meta"):
        tr.step(tb)
