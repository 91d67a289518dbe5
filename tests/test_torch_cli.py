"""far_tpu_torch's command-line entry points against far_tpu's, on the CPU.

``apply_overrides``, ``add_common_args``, ``build_dataset`` and
``_check_batch_intrinsics`` against the JAX package's; ``evaluate_far``
with the network guard's trained weights (restored from a port
checkpoint) and the sampler draws JAX's evaluation loop makes, against
``far_tpu.cli.evaluate.main`` on an orbax checkpoint of the same weights;
then every CLI's ``main`` with ``--device cpu`` at ``tests/test_cli.py``'s
small widths, and without it (no card here) raising. Each tolerance is
stated where it is checked.
"""

import argparse
import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far_tpu.cli.evaluate as jevaluate
import far_tpu_torch.cli.evaluate as tevaluate
import far_tpu_torch.cli.train as ttrain
from far_tpu.models.sixdreg import SixDRegConfig as JSixDRegConfig
from far_tpu.models.vitess import ViTEss as JViTEss
from far_tpu.models.vitess import ViTEssConfig as JViTEssConfig
from far_tpu.solvers.pose_estimation import default_prior_pcl
from far_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from far_tpu.utils import cli as jcli
from far_tpu.utils import config as jconfig
from far_tpu_torch.cli import demo as tdemo
from far_tpu_torch.cli import precompute as tprecompute
from far_tpu_torch.cli import submission as tsubmission
from far_tpu_torch.data import datasets as tdatasets
from far_tpu_torch.eval import mapfree_benchmark as tbench
from far_tpu_torch.eval import metrics as tmetrics
from far_tpu_torch.models.sixdreg import SixDRegConfig
from far_tpu_torch.models.vitess import ViTEssConfig
from far_tpu_torch.pipeline import init_model
from far_tpu_torch.tools.guard import GUARD_NPZ, TINY_SETS, tiny_config
from far_tpu_torch.train.checkpoint import CheckpointManager
from far_tpu_torch.utils import cli as tcli
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import flax_to_state_dict, load_flax_npz
from test_torch_data import jax_native, write_mapfree_scene  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# tests/test_cli.py's small widths
_SMALL_SETS = [
    "backbone.initial_dim=16", "backbone.block_dims=16,24,32",
    "coarse.d_model=32", "coarse.nhead=4",
    "match.max_matches=32", "match.thr=0.0",
    "fine.d_model=16", "fine.nhead=4",
    "regress.d_model=32", "regress.emm_heads=4", "regress.hidden=64",
    "solver.num_hypotheses=64",
]
SETS = [a for s in _SMALL_SETS for a in ("--set", s)]
SMALL = ["--dataset", "synthetic", "--image_size", "64x64", "--n_synthetic", "8",
         "--batch_size", "4", "--dtype", "float32", "--device", "cpu"] + SETS
VITESS_SMALL = [
    "--model", "vitess", "--dataset", "synthetic", "--image_size", "64x64",
    "--n_synthetic", "4", "--batch_size", "2", "--dtype", "float32", "--device", "cpu",
    "--set", "dim=48", "--set", "depth=2", "--set", "fc_hidden=64",
    "--set", "feature_hw=8,8", "--set", "grid_fx=4.0", "--set", "grid_fy=4.0",
]
SIXDREG_SMALL = ["--set", "image_hw=64,64", "--set", "hidden=64",
                 "--set", "transformer_heads=2"]


def _dirs(tmp_path, name):
    return ["--ckpt_dir", str(tmp_path / name / "ckpt"), "--log_dir", str(tmp_path / name / "logs")]


# ---- the shared plumbing ---------------------------------------------------------


def test_apply_overrides_matches_jax():
    """Each family's config with the small sets (ints, floats, bools,
    tuples of ints and of strings) equal to JAX's, field by field; a bad
    leaf raises the same TypeError, a bad inner key the same
    AttributeError."""
    far = _SMALL_SETS + ["coarse.layer_names=self,cross", "regress.use_simple_moe=false",
                         "solver.solver=ransac"]
    pairs = [(tconfig.FARConfig(), jconfig.FARConfig(), far),
             (ViTEssConfig(), JViTEssConfig(), ["dim=48", "feature_hw=8,8", "grid_fx=4.0",
                                                "use_loftr_gating=true"]),
             (SixDRegConfig(), JSixDRegConfig(), ["image_hw=64,64", "hidden=64"])]
    for ours, ref, sets in pairs:
        a, b = tcli.apply_overrides(ours, sets), jcli.apply_overrides(ref, sets)
        assert dataclasses.asdict(a) == dataclasses.asdict(b) != dataclasses.asdict(ref)
    for bad, exc in (("match.no_such_field=1", TypeError), ("no_such.field=1", AttributeError)):
        with pytest.raises(exc) as ours:
            tcli.apply_overrides(tconfig.FARConfig(), [bad])
        with pytest.raises(exc) as ref:
            jcli.apply_overrides(jconfig.FARConfig(), [bad])
        assert str(ours.value) == str(ref.value)
    with pytest.raises(TypeError, match="no_such_field"):
        tcli.apply_overrides(tconfig.FARConfig(), ["match.no_such_field=1"])


def test_common_args_and_build_dataset_match_jax(tmp_path, jax_native):
    """The same flags and defaults as JAX's, plus --device (cuda); the
    synthetic and map-free datasets they build give JAX's samples."""
    for argv in ([], [a for a in SMALL if a not in ("--device", "cpu")] + ["--seed", "3"]):
        ours = vars(tcli.add_common_args(argparse.ArgumentParser()).parse_args(argv))
        ref = vars(jcli.add_common_args(argparse.ArgumentParser()).parse_args(argv))
        assert ours.pop("device") == "cuda"
        assert ours == ref
    args = types.SimpleNamespace(dataset="synthetic", image_size="48x64", n_synthetic=3)
    ours, ref = tcli.build_dataset(args), jcli.build_dataset(args)
    assert len(ours) == len(ref) == 3
    for k, v in ours[2].items():
        np.testing.assert_array_equal(v, ref[2][k], err_msg=k)
    write_mapfree_scene(tmp_path / "val" / "s00000", 10)
    args = types.SimpleNamespace(dataset="mapfree", data_dir=tmp_path, split="val")
    ours, ref = tcli.build_dataset(args), jcli.build_dataset(args)
    assert isinstance(ours, tdatasets.MapFreeDataset) and len(ours) == len(ref) == 2
    np.testing.assert_array_equal(ours[1]["image1_reg"], ref[1]["image1_reg"])
    with pytest.raises(ValueError, match="unknown dataset"):
        tcli.build_dataset(types.SimpleNamespace(dataset="kitti"))


def test_check_batch_intrinsics_matches_jax():
    """tests/test_cli.py's cases: the Matterport camera passes, another
    camera and differing frames raise, with JAX's messages."""
    cfg_t = tconfig.FARConfig(image_size=(480, 640), dtype="float32")
    cfg_j = jconfig.FARConfig(image_size=(480, 640), dtype="float32")

    def batch_with(f, k1_scale=1.0):
        K = np.array([[[f, 0, 320.0], [0, f, 240.0], [0, 0, 1.0]]], np.float32)
        K1 = K.copy()
        K1[0, 0, 0] *= k1_scale
        return types.SimpleNamespace(K0=torch.from_numpy(K), K1=torch.from_numpy(K1))

    tevaluate._check_batch_intrinsics(batch_with(517.0), cfg_t)
    tevaluate._check_batch_intrinsics(batch_with(320.0))   # no config: frames only
    for batch, match in ((batch_with(320.0), "basis constants"),
                         (batch_with(517.0, 2.0), "differ between frames")):
        with pytest.raises(ValueError, match=match) as ours:
            tevaluate._check_batch_intrinsics(batch, cfg_t)
        with pytest.raises(ValueError) as ref:
            jevaluate._check_batch_intrinsics(
                types.SimpleNamespace(K0=batch.K0.numpy(), K1=batch.K1.numpy()), cfg_j)
        assert str(ours.value) == str(ref.value)


# ---- evaluate_far against JAX's evaluation CLI --------------------------------------------

GUARD_SETS = [
    f"backbone.initial_dim={TINY_SETS['backbone']['initial_dim']}",
    "backbone.block_dims=" + ",".join(map(str, TINY_SETS["backbone"]["block_dims"])),
    f"coarse.d_model={TINY_SETS['coarse']['d_model']}",
    f"coarse.nhead={TINY_SETS['coarse']['nhead']}",
    "coarse.layer_names=" + ",".join(TINY_SETS["coarse"]["layer_names"]),
] + [f"{grp}.{k}={v}" for grp in ("match", "fine", "regress", "solver")
     for k, v in TINY_SETS[grp].items()]
N_EVAL, B_EVAL = 16, 8
EVAL_ARGV = ["--dataset", "synthetic", "--image_size", "64x64", "--dtype", "float32",
             "--n_synthetic", str(N_EVAL), "--batch_size", str(B_EVAL)] + \
    [a for s in GUARD_SETS for a in ("--set", s)]


def _jax_draws(cfg, key):
    """far_tpu/pipeline.py:94,106's sampler draws from one batch's key."""
    so = cfg.solver
    k0, k1 = jax.random.split(key)
    keys = [k0] + list(jax.random.split(k1, so.fine_pred_steps - 1))
    hyps = [so.num_hypotheses] + [so.refine_num_hypotheses] * (so.fine_pred_steps - 1)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (B_EVAL, max(h // 20, 1), 5))))
            for k, h in zip(keys, hyps)]


def _geodesic_deg(A, B):
    """The angle in degrees of the rotation between each A[i] and B[i]."""
    cos = (np.einsum("nij,nij->n", A, B) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _angle_deg(a, b):
    """The angle in degrees between each a[i] and b[i]."""
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


@pytest.fixture(scope="module")
def jax_evaluation(tmp_path_factory):
    """far_tpu.cli.evaluate.main with the guard's weights saved as an
    orbax checkpoint: its fused table, the per-pair lists it aggregated,
    and the draws of its loop (it splits PRNGKey(seed) once a batch)."""
    root = tmp_path_factory.mktemp("jax_eval")
    variables, _ = load_flax_npz(GUARD_NPZ)
    mgr = JCheckpointManager(root / "ckpt")
    mgr.save(0, variables)
    mgr.close()
    seen = []
    real = jevaluate.aggregate_metrics
    mp = pytest.MonkeyPatch()
    mp.setattr(jevaluate, "aggregate_metrics", lambda acc: seen.append(acc) or real(acc))
    table = jevaluate.main(EVAL_ARGV + ["--ckpt_dir", str(root / "ckpt"),
                                        "--out_dir", str(root / "out")])
    mp.undo()
    cfg = jcli.apply_overrides(jconfig.FARConfig(image_size=(64, 64), dtype="float32"),
                               GUARD_SETS)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(N_EVAL // B_EVAL):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(cfg, sub))
    return dict(table=table, acc=seen[0], draws=draws, out=root / "out")


def test_aggregate_of_jax_evaluation_equals_jax_table(jax_evaluation):
    """JAX's per-pair arrays through the port's aggregation: JAX's table,
    exactly."""
    np.testing.assert_equal(tmetrics.aggregate_metrics(jax_evaluation["acc"]),
                            jax_evaluation["table"])


def test_evaluate_far_matches_jax(jax_evaluation, tmp_path, monkeypatch):
    """The guard's weights restored from a port checkpoint, JAX's draws and
    prior cloud: identifiers and dset size equal JAX's, every pair's
    rotation error within 1 deg of JAX's (the tolerance and reason of
    test_torch_validation.py::test_validate_far_matches_jax), and the same
    files written, pred_R of JAX's shape and orthonormal. Then the written
    poses and the solver's errors against JAX's, pair by pair, each
    tolerance beside the largest difference measured on the CPU."""
    variables, _ = load_flax_npz(GUARD_NPZ)
    sd = flax_to_state_dict(variables, tiny_config())
    CheckpointManager(tmp_path / "ckpt").save(
        0, {"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "step": 0})
    args = tevaluate.parse_args(EVAL_ARGV + ["--device", "cpu", "--ckpt_dir",
                                             str(tmp_path / "ckpt"),
                                             "--out_dir", str(tmp_path / "out")])
    assert tevaluate.far_config(args) == tiny_config()
    model = tevaluate._restore_variables(args.ckpt_dir,
                                         init_model(tevaluate.far_config(args), device="cpu"))
    seen = []
    real = tevaluate.aggregate_metrics
    monkeypatch.setattr(tevaluate, "aggregate_metrics", lambda acc: seen.append(acc) or real(acc))
    table = tevaluate.evaluate_far(model, tcli.build_dataset(args), args,
                                   uniforms=jax_evaluation["draws"],
                                   prior_pcl=torch.from_numpy(np.array(default_prior_pcl())))
    ref, jacc = jax_evaluation["table"], jax_evaluation["acc"]
    assert table.keys() == ref.keys()
    assert seen[0]["identifiers"] == jacc["identifiers"] == \
        [f"syn_{i}_0#syn_{i}_1" for i in range(N_EVAL)]
    assert table["dset size"] == ref["dset size"] == N_EVAL
    diff = np.abs(np.asarray(seen[0]["R_errs"]) - np.asarray(jacc["R_errs"]))
    assert diff.max() < 1.0, np.stack([seen[0]["R_errs"], jacc["R_errs"]])
    assert all(np.isfinite(v) for v in table.values())
    out, jout = tmp_path / "out", jax_evaluation["out"]
    assert sorted(p.name for p in out.iterdir()) == sorted(p.name for p in jout.iterdir())
    pred, jpred = np.load(out / "pred_R.npy"), np.load(jout / "pred_R.npy")
    assert pred.shape == jpred.shape == (N_EVAL, 3, 3)
    np.testing.assert_allclose(pred @ pred.transpose(0, 2, 1), np.broadcast_to(np.eye(3), pred.shape),
                               atol=1e-5)
    # the fused pose each package wrote, pair by pair: the rotation
    # between the two within 1.5 deg (measured 1.07), the angle between
    # the two translations within 5 deg (measured 3.61) and the
    # translation errors within 4 deg (measured 2.91)
    assert _geodesic_deg(pred, jpred).max() < 1.5, _geodesic_deg(pred, jpred)
    pt, jpt = np.load(out / "pred_t.npy"), np.load(jout / "pred_t.npy")
    assert pt.shape == jpt.shape == (N_EVAL, 3)
    assert _angle_deg(pt, jpt).max() < 5.0, _angle_deg(pt, jpt)
    np.testing.assert_allclose(seen[0]["t_errs"], jacc["t_errs"], rtol=0, atol=4.0)
    # the solver's pose: on the 9 pairs whose fused poses agree within
    # 0.1 deg (RANSAC kept the same winner), its rotation errors within
    # 2 deg (measured 1.25) and translation errors within 4 deg (measured
    # 2.36); elsewhere near-tied hypotheses of an 8-point RANSAC on the
    # guard's 64 matches pick other winners (up to 163 deg apart)
    same = _geodesic_deg(pred, jpred) < 0.1
    assert same.sum() >= N_EVAL // 2, _geodesic_deg(pred, jpred)
    for k, tol in (("solver_R_errs", 2.0), ("solver_t_errs", 4.0)):
        np.testing.assert_allclose(np.asarray(seen[0][k])[same], np.asarray(jacc[k])[same],
                                   rtol=0, atol=tol, err_msg=k)
    for name in (f"results_{tevaluate.far_config(args).solver.solver}.txt",
                 f"results_{tevaluate.far_config(args).solver.solver}_solverpose.txt"):
        keys = [ln.split(":")[0] for ln in (out / name).read_text().splitlines()]
        assert keys == [ln.split(":")[0] for ln in (jout / name).read_text().splitlines()]


# ---- every CLI on the CPU ----------------------------------------------------------------


def test_evaluate_cli_far(tmp_path):
    table = tevaluate.main(SMALL + ["--max_batches", "1", "--out_dir", str(tmp_path)])
    assert table["dset size"] == 4 and "rot mean err" in table
    cdf = np.load(tmp_path / "error_cdf.npy")
    assert (np.diff(cdf) >= 0).all() and np.load(tmp_path / "pred_t.npy").shape == (4, 3)
    assert (tmp_path / "results_prior_ransac_solverpose.txt").exists()


@pytest.mark.parametrize("gated", [False, True])
def test_evaluate_cli_vitess(tmp_path, gated):
    """--model vitess against far_tpu.cli.evaluate's, with JAX's ViTEss
    init (small widths) saved as an orbax checkpoint and, through
    flax_to_state_dict, as a port checkpoint: every pair's pred_R (the
    un-normalised 6d prediction decoded with the row convention) within
    1e-4 of JAX's (measured 7.5e-7), and the table within 1e-3 deg
    (measured 0); the gated model reads the same cached solver poses."""
    extra = ["--set", "use_loftr_gating=true"] if gated else []
    sets = [a for prev, a in zip(VITESS_SMALL + extra, (VITESS_SMALL + extra)[1:])
            if prev == "--set"]
    jcfg = jcli.apply_overrides(JViTEssConfig(dtype="float32"), sets)
    sp, nc = (jnp.tile(jnp.eye(3, 4)[None], (2, 1, 1)), jnp.zeros((2,))) if gated else (None, None)
    variables = jax.device_get(JViTEss(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((2, 2, 64, 64, 3)), sp, nc, train=False))
    mgr = JCheckpointManager(tmp_path / "jckpt")
    mgr.save(0, variables)
    mgr.close()
    sd = flax_to_state_dict(variables, tcli.apply_overrides(ViTEssConfig(dtype="float32"), sets))
    CheckpointManager(tmp_path / "ckpt").save(
        0, {"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, "step": 0})
    ref = jevaluate.main([a for a in VITESS_SMALL if a not in ("--device", "cpu")] + extra +
                         ["--ckpt_dir", str(tmp_path / "jckpt"), "--out_dir", str(tmp_path / "j")])
    table = tevaluate.main(VITESS_SMALL + extra + ["--ckpt_dir", str(tmp_path / "ckpt"),
                                                   "--out_dir", str(tmp_path)])
    assert "large overlap, rot mean err" in table and "small overlap, rot median err" in table
    assert (tmp_path / "results.txt").exists()
    pred, jpred = np.load(tmp_path / "pred_R.npy"), np.load(tmp_path / "j" / "pred_R.npy")
    assert pred.shape == jpred.shape == (4, 3, 3)
    np.testing.assert_allclose(pred, jpred, rtol=0, atol=1e-4)
    assert _geodesic_deg(pred[:1], pred[1:]).min() > 1.0   # the pairs' rotations differ
    assert table.keys() == ref.keys()   # an empty overlap bucket reads NaN in both
    np.testing.assert_allclose([table[k] for k in ref], list(ref.values()), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mapfree", [False, True])
def test_demo_cli(mapfree):
    argv = ["--synthetic", "--image_size", "64x64", "--dtype", "float32", "--device", "cpu"]
    if mapfree:
        argv += ["--mapfree", "--reg_size", "64x48"]
    rt = tdemo.main(argv + SETS)
    assert rt.shape == (3, 4) and np.isfinite(rt).all()
    np.testing.assert_allclose(rt[:, :3] @ rt[:, :3].T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw,reg_hw", [((480, 640), (368, 272)), ((64, 64), (64, 48)),
                                       ((48, 64), (96, 128))])
def test_reg_image_matches_jax_resize(hw, reg_hw, channels):
    """demo --mapfree's regressor input against far_tpu/cli/demo.py's
    jax.image.resize "bilinear" (antialiased when it shrinks), gray tiled
    to RGB after the resize: at the demo's default sizes, the CPU test's,
    and an upsample, within 1e-5 (measured 3.7e-6)."""
    img = np.random.default_rng(channels).uniform(size=(*hw, channels)).astype(np.float32)
    ours = tdemo._reg_image(img, *reg_hw, torch.device("cpu")).numpy()
    ref = jax.image.resize(jnp.asarray(img)[None], (1, *reg_hw, channels), "bilinear")
    ref = np.asarray(jnp.tile(ref, (1, 1, 1, 3 // channels)))
    assert ours.shape == ref.shape == (1, *reg_hw, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_precompute_cli(tmp_path, monkeypatch):
    """loftr writes one (n, 4) entry a pair under JAX's keys, which 6DReg
    training then reads (--corr_npz); sift writes the JAX CLI's store
    bit for bit (both on OpenCV), without touching a device; superglue
    on the JAX CLI's SuperPoint/SuperGlue init (PRNGKey(0) and (1),
    carried by flax_to_state_dict) writes its store, every entry within
    1e-4 px. Both CLIs' superglue run at 256 keypoints and threshold 0
    (the default 0.2 keeps no match of random weights)."""
    out = tmp_path / "corr.npz"
    store = tprecompute.main(["--dataset", "synthetic", "--image_size", "64x64",
                              "--n_synthetic", "2", "--matcher", "loftr", "--out", str(out),
                              "--dtype", "float32", "--device", "cpu"] + SETS)
    z = np.load(out)
    assert sorted(z.files) == sorted(store) == ["syn_0_0-syn_0_1", "syn_1_0-syn_1_1"]
    assert all(z[k].ndim == 2 and z[k].shape[1] == 4 and np.isfinite(z[k]).all()
               for k in z.files)
    import far_tpu.cli.precompute as jprecompute
    import far_tpu.models.superglue as jsg
    import far_tpu.models.superpoint as jsp
    from far_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
    from far_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig

    for mod, name, kw in ((jsp, "SuperPointConfig", dict(max_keypoints=256)),
                          (jsg, "SuperGlueConfig", dict(match_threshold=0.0))):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))

    def carried_models(dtype, device):
        """The JAX CLI's init (far_tpu/cli/precompute.py), in the port."""
        sp = jsp.SuperPointTPU(jsp.SuperPointConfig(dtype=dtype))
        sg = jsg.SuperGlueTPU(jsg.SuperGlueConfig(dtype=dtype))
        dummy = jnp.zeros((1, 64, 64, 1))
        sp_vs = sp.init(jax.random.PRNGKey(0), dummy)
        k, s, v, d = sp.apply(sp_vs, dummy)
        sg_vs = sg.init(jax.random.PRNGKey(1), k, s, v, d, k, s, v, d, image_hw=(64, 64))
        out = []
        for module, cfg, vs in ((SuperPoint, SuperPointConfig(max_keypoints=256, dtype=dtype),
                                 sp_vs),
                                (SuperGlue, SuperGlueConfig(match_threshold=0.0, dtype=dtype),
                                 sg_vs)):
            sd = flax_to_state_dict(jax.tree.map(np.asarray, vs), cfg)
            m = module(cfg)
            m.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
                              strict=True)
            out.append(m.to(device).eval())
        return out

    monkeypatch.setattr(tprecompute, "superglue_models", carried_models)
    for matcher in ("sift", "superglue"):
        argv = ["--dataset", "synthetic", "--image_size", "64x64", "--n_synthetic", "2",
                "--matcher", matcher, "--dtype", "float32"]
        ours = tprecompute.main(argv + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
        jprecompute.main(argv + ["--out", str(tmp_path / "j.npz")])
        ref = np.load(tmp_path / "j.npz")
        got = np.load(tmp_path / "t.npz")
        assert sorted(got.files) == sorted(ref.files) == sorted(ours)
        assert sum(len(ref[k]) for k in ref.files) >= 2, matcher  # matches were made
        for k in ref.files:
            if matcher == "sift":
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    # the store feeds 6DReg training through CachedCorrespondenceDataset
    trainer = ttrain.main(["--model", "sixdreg", "--dataset", "synthetic", "--image_size",
                           "64x64", "--n_synthetic", "2", "--batch_size", "2", "--dtype",
                           "float32", "--device", "cpu", "--steps", "1", "--sampler",
                           "sequential", "--corr_npz", str(out), "--corr_max_matches", "32"]
                          + SIXDREG_SMALL + _dirs(tmp_path, "six"))
    assert trainer.step_count == 1


def test_submission_cli_then_scored(tmp_path, capsys):
    """A val scene of 20 queries (4 pairs at sample factor 5) through the
    map-free pipeline, restored from a {matcher, regressor} checkpoint:
    the zip holds 4 finite poses, the scorer reads it."""
    root = tmp_path / "mapfree"
    write_mapfree_scene(root / "val" / "s00000", 20, wh=(64, 48))
    matcher_argv = ["--matcher_hw", "48x64", "--reg_hw", "48x64", "--dtype", "float32",
                    "--device", "cpu"] + SETS
    from far_tpu_torch.pipeline import init_sixdreg

    args = tsubmission.parse_args(["--data_dir", str(root)] + matcher_argv)
    mcfg = tcli.apply_overrides(
        tconfig.FARConfig(image_size=(48, 64), dtype="float32", regress_rt=False), args.overrides)
    matcher = init_model(mcfg, seed=5, device="cpu")
    reg = init_sixdreg(SixDRegConfig(image_hw=(48, 64), dtype="float32"), seed=6, device="cpu")
    CheckpointManager(tmp_path / "ckpt").save(
        0, {"matcher": matcher.state_dict(), "regressor": reg.state_dict()})
    writer = tsubmission.main(["--data_dir", str(root), "--out", str(tmp_path / "sub.zip"),
                               "--max_pairs", "4", "--ckpt_dir", str(tmp_path / "ckpt")]
                              + matcher_argv)
    lines = writer._scenes["s00000"]
    assert [ln.split()[0] for ln in lines] == [f"seq1/frame_{i:05d}.jpg" for i in (0, 5, 10, 15)]
    assert all(np.isfinite([float(x) for x in ln.split()[1:]]).all() for ln in lines)
    capsys.readouterr()
    tbench.main([str(tmp_path / "sub.zip"), "--dataset_path", str(root)])
    assert '"Estimates for % of frames": 1.0' in capsys.readouterr().out


def test_train_cli_far_resume_then_evaluate(tmp_path):
    """Two steps write the log and a checkpoint; --resume takes no further
    step; evaluate --ckpt_dir restores the checkpoint's weights exactly."""
    argv = SMALL + ["--steps", "2", "--log_every", "1", "--sampler", "sequential",
                    "--val_every", "2", "--val_n", "4"] + _dirs(tmp_path, "a")
    trainer = ttrain.main(argv)
    lines = (tmp_path / "a" / "logs" / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and trainer.step_count == 2   # 2 steps, 1 val pass
    assert (tmp_path / "a" / "ckpt" / "best" / "2.pt").exists()
    again = ttrain.main(argv + ["--resume"])
    assert again.step_count == 2
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    args = tevaluate.parse_args(SMALL + ["--ckpt_dir", str(tmp_path / "a" / "ckpt")])
    model = tevaluate._restore_variables(args.ckpt_dir,
                                         init_model(tevaluate.far_config(args), device="cpu"))
    saved = CheckpointManager(tmp_path / "a" / "ckpt").restore()["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    table = tevaluate.main(SMALL + ["--max_batches", "1", "--ckpt_dir",
                                    str(tmp_path / "a" / "ckpt"), "--out_dir", str(tmp_path)])
    assert "rot mean err" in table
    with pytest.raises(ValueError, match="do not match the model config"):
        tevaluate.main(SMALL + ["--set", "coarse.d_model=48", "--ckpt_dir",
                                str(tmp_path / "a" / "ckpt"), "--out_dir", str(tmp_path)])


def test_train_cli_debug_nans_resets(tmp_path, monkeypatch):
    """--debug_nans trains with anomaly detection on and the non-finite
    skip off, and leaves anomaly detection as it found it."""
    seen = []

    class Spy(ttrain.Trainer):
        def step(self, *a, **kw):
            seen.append((torch.is_anomaly_enabled(), self.optimizer.cfg.skip_nonfinite))
            return super().step(*a, **kw)

    monkeypatch.setattr(ttrain, "Trainer", Spy)
    assert not torch.is_anomaly_enabled()
    ttrain.main(SMALL + ["--steps", "1", "--sampler", "sequential", "--debug_nans"]
                + _dirs(tmp_path, "d"))
    assert seen == [(True, False)] and not torch.is_anomaly_enabled()


@pytest.mark.parametrize("preset", ["interiornet", "mapfree"])
def test_train_cli_presets(tmp_path, preset):
    """One step of each family preset at small widths (the gated ViTEss
    through SolverPoseDataset, 6DReg on ground-truth correspondences),
    then a subepoch pass for ViTEss; the losses are finite and the
    checkpoint restores into evaluate --model vitess."""
    small = VITESS_SMALL[2:] if preset == "interiornet" else \
        SMALL[:-len(SETS)] + SIXDREG_SMALL
    # the presets train in bfloat16; float32 here
    trainer = ttrain.main(["--preset", preset, "--steps", "1", "--log_every", "1",
                           "--sampler", "sequential", "--set", "dtype=float32"]
                          + small + _dirs(tmp_path, "p"))
    assert trainer.step_count == 1
    rec = json.loads((tmp_path / "p" / "logs" / "train_metrics.jsonl").read_text())
    assert np.isfinite(rec["loss"])
    if preset == "interiornet":
        assert trainer.cfg.use_loftr_gating and trainer.cfg.dataset == "interiornet_T"
        table = tevaluate.main(VITESS_SMALL + ["--set", "use_loftr_gating=true",
                                               "--set", "dataset=interiornet_T",
                                               "--ckpt_dir", str(tmp_path / "p" / "ckpt"),
                                               "--out_dir", str(tmp_path / "e")])
        assert table["pct successful fits"] == 100.0
        tr = ttrain.main(VITESS_SMALL + ["--steps", "2", "--subepochs", "2",
                                         "--sampler", "sequential"] + _dirs(tmp_path, "s"))
        log = (tmp_path / "s" / "logs" / "train_metrics.jsonl").read_text()
        assert tr.step_count == 2 and "val/loss" in log
    else:
        assert isinstance(trainer.cfg, SixDRegConfig) and trainer.optimizer.cfg.lr == 1e-5


@pytest.mark.parametrize("cli", ["evaluate", "evaluate_vitess", "demo", "demo_mapfree",
                                 "precompute", "submission", "train"])
def test_clis_need_a_card_unless_cpu(cli, tmp_path):
    """Without --device cpu every CLI asks for CUDA, and without a card
    that raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    argv = {"evaluate": (tevaluate.main, ["--out_dir", str(tmp_path)]),
            "evaluate_vitess": (tevaluate.main, ["--model", "vitess"]),
            "demo": (tdemo.main, ["--synthetic"]),
            "demo_mapfree": (tdemo.main, ["--synthetic", "--mapfree"]),
            "precompute": (tprecompute.main, ["--out", str(tmp_path / "c.npz")]),
            "submission": (tsubmission.main, ["--data_dir", str(tmp_path)]),
            "train": (ttrain.main, _dirs(tmp_path, "t"))}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        argv[0](argv[1])
    assert not list(tmp_path.iterdir())
