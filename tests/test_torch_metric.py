"""far_tpu_torch's classical map-free baseline against far_tpu's, on the CPU.

The metric-scale solvers and the DLT-PnP RANSAC (``solvers/metric.py``)
on the scenes of ``tests/test_metric_solvers.py``, the port fed the
uniforms the JAX package draws from its key, and
``FeatureMatchingModel``'s three solvers behind an oracle
``PrecomputedMatching`` (ground-truth correspondences of rigid synthetic
scenes written to an ``.npz`` store). Each tolerance is stated where it
is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu.data import datasets as jdatasets
from far_tpu.models import feature_matching as jfm
from far_tpu.models.sixdreg import FeatureMatchingModel as JFeatureMatchingModel
from far_tpu.solvers import metric as jmetric
from far_tpu_torch.data import synthetic as tdata
from far_tpu_torch.geometry.rotations import geodesic_distance
from far_tpu_torch.models import feature_matching as tfm
from far_tpu_torch.models.sixdreg import FeatureMatchingModel
from far_tpu_torch.solvers import metric as tmetric
from test_metric_solvers import metric_scene, pad

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_close(out, ref, rel, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def _scene(seed, n=128, N=160, outliers=0, corrupt_depth=False):
    """One metric_scene padded to N slots, batched: (R, t unit, kp0, kp1,
    depth0, depth1, K, valid, t metric) as numpy."""
    rng = np.random.default_rng(seed)
    K, R, tt, uv0, uv1, d0, d1, _ = metric_scene(rng, n=n)
    m = len(uv0)
    if outliers:
        uv1 = uv1.copy()
        uv1[:m // outliers] = rng.uniform([0, 0], [160, 120], size=(m // outliers, 2))
    if corrupt_depth:   # a third of the depths tripled, as the JAX test does
        bad = np.round(uv0[::3]).astype(int)
        d0 = d0.copy()
        d0[np.clip(bad[:, 1], 0, 119), np.clip(bad[:, 0], 0, 159)] *= 3.0
    b = lambda a: np.asarray(a, np.float32)[None]
    return dict(R=b(R), t=b(tt / np.linalg.norm(tt)), kp0=b(pad(uv0, N)), kp1=b(pad(uv1, N)),
                d0=b(d0), d1=b(d1), K=b(K), valid=pad(np.ones(m, bool), N, False)[None],
                t_metric=tt)


def test_backproject_3d_matches_jax():
    """backproject_3d within 1e-5 relative of JAX's on random pixels and depths."""
    rng = np.random.default_rng(0)
    kp = rng.uniform(0, 160, (2, 50, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 9, (2, 50)).astype(np.float32)
    K = np.stack([np.array([[100.0, 0, 80], [0, 110, 60], [0, 0, 1]], np.float32)] * 2)
    rel_close(tmetric.backproject_3d(t(kp), t(depth), t(K)),
              jmetric.backproject_3d(jnp.asarray(kp), jnp.asarray(depth), jnp.asarray(K)),
              1e-5)


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "bad_depth"])
def test_metric_scales_match_jax(corrupt):
    """metric_scale_mean and metric_scale_ransac (the (N, N) vote) within
    1e-5 relative of JAX's, the vote counts and ok flags equal; a third
    of image 0's depths tripled in the second case."""
    s = _scene(1, corrupt_depth=corrupt)
    args = ("R", "t", "kp0", "kp1", "d0", "d1", "K", "K", "valid")
    ours = tmetric.metric_scale_mean(*(t(s[k]) for k in args))
    ref = jmetric.metric_scale_mean(*(jnp.asarray(s[k]) for k in args))
    rel_close(ours[0], ref[0], 1e-5, "mean t")
    assert bool(ours[1][0]) == bool(ref[1][0])
    ours = tmetric.metric_scale_ransac(*(t(s[k]) for k in args))
    ref = jmetric.metric_scale_ransac(*(jnp.asarray(s[k]) for k in args))
    rel_close(ours[0], ref[0], 1e-5, "ransac t")
    assert float(ours[1][0]) == float(ref[1][0]) > 10
    assert bool(ours[2][0]) == bool(ref[2][0])
    np.testing.assert_allclose(np.linalg.norm(ours[0][0].numpy()),
                               np.linalg.norm(s["t_metric"]), rtol=0.1)


@pytest.mark.parametrize("outliers,seed", [(0, 2), (4, 3)], ids=["clean", "outliers"])
def test_pnp_ransac_matches_jax(outliers, seed):
    """pnp_ransac on tests/test_metric_solvers.py's scenes (200 points, a
    quarter of image 1's points replaced by uniform ones in the second),
    the port fed JAX's draws from the same key, in float64 and float32:
    the inlier counts and ok equal; R and t within 1e-10 of JAX's in
    float64, and within 1e-3 in float32 (measured 1.04e-4 on R and
    5.0e-4 on t, clean scene; there both packages' float32 answers lie
    1.6e-2 (R) and 7.9e-2 (t) from the float64 one: 4 steps of inverse
    iteration on the 12x12 normal matrix of unnormalised coordinates
    amplify rounding); the pose right (< 3 deg, |t - t_gt| < 0.15
    without outliers)."""
    s = _scene(seed, n=200, N=256, outliers=outliers)
    cfg_j = jmetric.PnPConfig(num_hypotheses=256)
    cfg_t = tmetric.PnPConfig(num_hypotheses=256)
    key = jax.random.PRNGKey(seed)
    args = ("kp0", "kp1", "d0", "K", "K", "valid")
    u = np.asarray(jax.random.uniform(key, (1, cfg_j.num_hypotheses, cfg_j.sample_size)))
    run_j = jax.jit(lambda k, *a: jmetric.pnp_ransac(k, *a, cfg_j))
    for dt, tol in ((np.float64, 1e-10), (np.float32, 1e-3)):
        cast = lambda a: a.astype(dt) if a.dtype == np.float32 else a
        jax.config.update("jax_enable_x64", dt == np.float64)
        try:
            ref = run_j(key, *(jnp.asarray(cast(s[k])) for k in args))
            ref = [np.asarray(r) for r in ref]
        finally:
            jax.config.update("jax_enable_x64", False)
        ours = tmetric.pnp_ransac(*(t(cast(s[k])) for k in args), cfg=cfg_t,
                                  uniforms=t(cast(u)))
        assert ours[0].dtype == (torch.float64 if dt == np.float64 else torch.float32)
        for i, what in ((0, "R"), (1, "t")):
            np.testing.assert_allclose(ours[i].numpy(), ref[i], rtol=0, atol=tol,
                                       err_msg=f"{what} {dt.__name__}")
        assert float(ours[2][0]) == float(ref[2][0]) and bool(ours[3][0]) == bool(ref[3][0])
    err = np.degrees(float(geodesic_distance(ours[0][0], t(s["R"][0]))))
    assert err < (3.0 if not outliers else 5.0), err
    assert np.abs(ours[1][0].numpy() - s["t_metric"]).max() < (0.15 if not outliers else 0.3)


def test_pad_matches_and_precomputed_matching(tmp_path):
    """pad_matches (truncate, pad, empty) and PrecomputedMatching on an
    .npz store (a stored pair, a longer one, a missing one) equal to
    JAX's bit for bit."""
    rng = np.random.default_rng(4)
    store = {"a-b": rng.uniform(0, 100, (30, 4)).astype(np.float32),
             "c-d": rng.uniform(0, 100, (80, 4)).astype(np.float32)}
    path = tmp_path / "corr.npz"
    np.savez(path, **store)
    for pts in (store["a-b"], store["c-d"], np.zeros((0, 4), np.float32)):
        for ours, ref in zip(tfm.pad_matches(pts[:, :2], pts[:, 2:], 64),
                             jfm.pad_matches(pts[:, :2], pts[:, 2:], 64)):
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    tm, jm = tfm.PrecomputedMatching(path, 64), jfm.PrecomputedMatching(path, 64)
    for names in (("a", "b"), ("c", "d"), ("x", "y")):
        for ours, ref in zip(tm.match(*names), jm.match(*names)):
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref), names
    assert tm.match("c", "d")[2].sum() == 64 and tm.match("x", "y")[2].sum() == 0


@pytest.fixture(scope="module")
def oracle_store(tmp_path_factory):
    """Ground-truth correspondences (0.5 px noise, a quarter outliers) of
    2 synthetic scenes at 480x640, written as a PrecomputedMatching
    store; the samples keep their depth, intrinsics and pose."""
    ds = tdata.GTCorrespondenceDataset(tdata.SyntheticPairDataset(n=2, hw=(480, 640), seed=3),
                                       max_matches=256, noise_pix=0.5, outlier_pct=0.25,
                                       seed=3)
    samples = [ds[i] for i in range(len(ds))]
    path = tmp_path_factory.mktemp("oracle") / "corr.npz"
    np.savez(path, **{"-".join(s["pair_names"]): s["correspondences"][s["corr_valid"]]
                      .reshape(-1, 4) for s in samples})
    return path, samples


@pytest.mark.parametrize("solver", ["essential", "essential_metric", "pnp"])
def test_feature_matching_model_matches_jax(solver, oracle_store, monkeypatch):
    """FeatureMatchingModel behind the oracle matcher, the port fed the
    draws the JAX model makes from its key (pnp_ransac's (1, 1024, 6), or
    estimate_pose's (1, 2048, 8)): the inlier counts equal, R and t within
    1e-3 of JAX's (test_torch_pipeline's bound for the polished 8-point
    fit; PnP within 1e-4), on every scene; and the pose right (rotation
    under 2 deg). The JAX model's solvers run under jax.jit (it calls them
    op by op, which takes ~5 s a pair on the CPU)."""
    import far_tpu.solvers as jsolvers

    monkeypatch.setattr(jsolvers, "estimate_pose",
                        jax.jit(jsolvers.estimate_pose, static_argnames=("cfg",)))
    monkeypatch.setattr(jmetric, "pnp_ransac", jax.jit(jmetric.pnp_ransac,
                                                       static_argnames=("cfg",)))
    monkeypatch.setattr(jmetric, "metric_scale_ransac",
                        jax.jit(jmetric.metric_scale_ransac, static_argnums=(9,)))
    path, samples = oracle_store
    ours = FeatureMatchingModel(tfm.PrecomputedMatching(path, 256), solver, device="cpu")
    ref = JFeatureMatchingModel(jfm.PrecomputedMatching(path, 256), solver)
    shape = (1, 1024, 6) if solver == "pnp" else (1, 2048, 8)
    for i, s in enumerate(samples):
        key = jax.random.PRNGKey(10 + i)
        args = (*s["pair_names"], s["K0"], s["K1"], s["depth0"], s["depth1"])
        R, tt, n = ours.estimate(*args, uniforms=t(jax.random.uniform(key, shape)))
        jR, jt, jn = ref.estimate(key, *args)
        tol = 1e-4 if solver == "pnp" else 1e-3
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=tol)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=tol)
        assert n == jn > 30, (i, n, jn)
        err = np.degrees(float(geodesic_distance(R, t(s["T_0to1"][:3, :3]))))
        assert err < 2.0, (i, err)


def test_feature_matching_model_device_rule(oracle_store):
    path, _ = oracle_store
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FeatureMatchingModel(tfm.PrecomputedMatching(path))
    with pytest.raises(ValueError, match="solver"):
        FeatureMatchingModel(tfm.PrecomputedMatching(path), "sift", device="cpu")
