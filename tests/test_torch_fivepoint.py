"""far_tpu_torch's Nister 5-point solver and 5-point RANSAC against far_tpu.

The same numpy inputs go through both packages on the CPU. The port
keeps the JAX package's algorithm, constants and candidate order, and
agrees with it stage by stage to the tolerances stated per test. End to
end the candidates of the two float32 implementations agree only where
the problem is well conditioned: det C(z) is nearly singular, so C(z)
values a few ulp apart (the packages sum C(z) = Q V^-T in different
orders, 7.6e-7 relative apart) move the interpolated degree-10
polynomial by ~2 %, and roots that Durand-Kerner cannot pin in 64 steps
land elsewhere. Both find the true solution of the same problems; the
tests hold them to that, and to the agreement that f32 allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far_tpu.geometry.fivepoint as J
import far_tpu_torch.geometry.fivepoint as T
from far_tpu.solvers.pose_estimation import SolverConfig as JSolverConfig
from far_tpu.solvers.pose_estimation import default_prior_pcl
from far_tpu.solvers.pose_estimation import estimate_pose as jestimate
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose
from test_fivepoint import make_minimal_pair
from test_torch_pipeline import _scene_matches

torch.set_num_threads(2)
B_MIN = 64  # minimal problems, as tests/test_fivepoint.py:70-85


@pytest.fixture(scope="module")
def minimal():
    """64 exact minimal problems and both packages' candidates."""
    triples = [make_minimal_pair(s) for s in range(B_MIN)]
    p1 = np.stack([t[0] for t in triples])
    p2 = np.stack([t[1] for t in triples])
    Egt = np.stack([t[2] for t in triples])
    Ej, vj = (np.asarray(a) for a in J.run_5point_essential(jnp.asarray(p1),
                                                          jnp.asarray(p2)))
    Et, vt = (a.numpy() for a in T.run_5point_essential(torch.from_numpy(p1),
                                                        torch.from_numpy(p2)))
    return dict(p1=p1, p2=p2, Egt=Egt, Ej=Ej, vj=vj, Et=Et, vt=vt)


def _hits(E, valid, Egt):
    """Per problem: a valid candidate aligned with the truth (|cos| > 0.999)."""
    al = np.abs((E * Egt[:, None]).sum((-2, -1))) / (
        np.linalg.norm(E, axis=(-2, -1)) * np.linalg.norm(Egt, axis=(-2, -1))[:, None]
        + 1e-12)
    return np.where(valid, al, 0).max(-1) > 0.999


def _sign_free_dist(a, b):
    return np.minimum(np.abs(a - b).max((-2, -1)), np.abs(a + b).max((-2, -1)))


def test_fixed_constants_equal_jax():
    """The five fixed tables, element for element."""
    np.testing.assert_array_equal(T._XY_NODES, J._XY_NODES)
    np.testing.assert_array_equal(T._VINV_T, J._VINV_T)
    np.testing.assert_array_equal(T._Z_NODES, J._Z_NODES)
    np.testing.assert_array_equal(T._WINV_Z, J._WINV_Z)
    np.testing.assert_array_equal(T._basis_rotations(2), J._basis_rotations(2))
    np.testing.assert_array_equal(T._det_mix(10), J._det_mix(10))


@pytest.mark.parametrize("name", ["det_gauss", "det_gauss_mixed"])
def test_determinants_match_jax(name):
    """64 random 10x10 matrices, rtol 1e-3 (det_gauss_mixed up to its one
    global sign det(Q); it sums Q M in the JAX package's order, and is
    then equal to it bit for bit on the CPU)."""
    M = np.random.default_rng(0).normal(size=(64, 10, 10)).astype(np.float32)
    ref = np.asarray(getattr(J, name)(jnp.asarray(M)))
    out = getattr(T, name)(torch.from_numpy(M)).numpy()
    if name == "det_gauss_mixed":
        out = out * np.sign((out * ref).sum())
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=0)
    if name == "det_gauss":
        np.testing.assert_allclose(out, np.linalg.det(M.astype(np.float64)),
                                   rtol=1e-3, atol=1e-4)


def test_durand_kerner_matches_jax_on_known_roots():
    """test_fivepoint.py's polynomials (32 of degree 10, real roots in
    [-3, 3]): at every root the JAX package pins (within 1e-3 (1 + |z|)
    of a true root), the port's slot agrees with JAX's to 2e-3 (1 + |z|)
    (99.7 % of them to 1e-3). Clustered roots that neither pins in 64
    steps wander apart under f32 rounding."""
    true = np.sort(np.random.default_rng(0).uniform(-3, 3, (32, 10)), axis=-1)
    coeffs = np.stack([np.poly(r)[::-1] for r in true]).astype(np.float32)
    ref = np.asarray(J.durand_kerner_roots(jnp.asarray(coeffs)))
    out = T.durand_kerner_roots(torch.from_numpy(coeffs)).numpy()
    assert out.dtype == np.complex64 and out.shape == (32, 10)
    scale = 1.0 + np.abs(ref)
    pinned = (np.abs(ref.real[..., None] - true[:, None, :]).min(-1) < 1e-3 * scale) \
        & (np.abs(ref.imag) < 1e-3)
    assert pinned.mean() > 0.85
    err = np.abs(out - ref) / scale
    assert err[pinned].max() < 2e-3, err[pinned].max()
    assert (err[pinned] < 1e-3).mean() > 0.99


def test_stages_match_jax_on_jax_inputs(minimal):
    """Each stage on the JAX package's own inputs: the nullspace (as a
    projector, bases differ by their sign and rotation freedom) to 1e-4,
    C(z) to 1e-5 of its largest entry, and Durand-Kerner on the JAX
    package's 128 degree-10 polynomials: 99 % of the slots within
    1e-3 (1 + |z|)."""
    p1, p2 = minimal["p1"], minimal["p2"]
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                  np.ones_like(x1)], -1).astype(np.float32)
    bj = np.asarray(J._nullspace4(jnp.asarray(A)))
    bt = T._nullspace4(torch.from_numpy(A)).numpy()
    proj = lambda b: b @ np.swapaxes(b, -1, -2)
    np.testing.assert_allclose(proj(bt), proj(bj), rtol=0, atol=1e-4)

    Eb = np.swapaxes(bj, -1, -2).reshape(B_MIN, 4, 3, 3)
    Ebr = np.einsum("rkm,bmij->brkij", J._basis_rotations(2), Eb).astype(np.float32)
    z = np.broadcast_to(J._Z_NODES.astype(np.float32), (B_MIN, 2, 11)).copy()
    cj = np.asarray(J._c_of_z(jnp.asarray(Ebr), jnp.asarray(z)))
    ct = T._c_of_z(torch.from_numpy(Ebr), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5 * np.abs(cj).max())

    det = np.asarray(J.det_gauss_mixed(jnp.asarray(cj)))
    coeffs = (det / (np.abs(det).max(-1, keepdims=True) + 1e-12)) @ J._WINV_Z.T
    coeffs = coeffs.astype(np.float32)
    rj = np.asarray(J.durand_kerner_roots(jnp.asarray(coeffs)))
    rt = T.durand_kerner_roots(torch.from_numpy(coeffs)).numpy()
    assert (np.abs(rt - rj) / (1 + np.abs(rj)) < 1e-3).mean() > 0.99


def test_run_5point_essential_against_jax(minimal):
    """End to end on the 64 minimal problems (see the module note): the
    port alone recovers the truth in >= 85 % (tests/test_fivepoint.py's
    bar) and wherever the JAX package does; the valid masks agree on
    >= 85 % of slots (89.7 % measured; no more, because the f32
    conditioning of det C(z) moves the spurious near-real roots), and
    >= 85 % of the port's candidates on the essential manifold
    (|2 E E^T E - tr(E E^T) E| < 1e-3) have one of the JAX package's
    within 1e-3, up to sign (90.7 % measured)."""
    Ej, vj, Et, vt, Egt = (minimal[k] for k in ("Ej", "vj", "Et", "vt", "Egt"))
    assert Et.shape == (B_MIN, 20, 3, 3) and vt.shape == (B_MIN, 20)
    hit_t, hit_j = _hits(Et, vt, Egt), _hits(Ej, vj, Egt)
    assert hit_t.sum() >= int(0.85 * B_MIN), hit_t.sum()
    assert (hit_t | ~hit_j).all()
    assert (vt == vj).mean() >= 0.85

    def on_manifold(E, valid):
        E = E.astype(np.float64)
        EEt = E @ np.swapaxes(E, -1, -2)
        tr = np.trace(EEt, axis1=-2, axis2=-1)[..., None, None]
        return valid & (np.abs(2 * EEt @ E - tr * E).max((-2, -1)) < 1e-3)

    mt, mj = on_manifold(Et, vt), on_manifold(Ej, vj)
    found = [_sign_free_dist(Ej[b][mj[b]], Et[b, c][None]).min(initial=np.inf) < 1e-3
             for b in range(B_MIN) for c in np.where(mt[b])[0]]
    assert np.mean(found) >= 0.85, np.mean(found)


def test_candidates_satisfy_constraints_and_stay_finite(minimal):
    """tests/test_fivepoint.py's checks on the port: problem 3's valid
    candidates meet the five epipolar constraints to 5e-3 and |det E| <
    5e-2; every valid candidate has ||E||_F = sqrt(2), every masked slot
    is the identity; an all-identical sample gives finite output."""
    Et, vt, p1, p2 = minimal["Et"], minimal["vt"], minimal["p1"], minimal["p2"]
    h1 = np.concatenate([p1[3], np.ones((5, 1), np.float32)], -1)
    h2 = np.concatenate([p2[3], np.ones((5, 1), np.float32)], -1)
    E3 = Et[3][vt[3]]
    assert len(E3) > 0
    assert np.abs(np.einsum("ni,cij,nj->cn", h2, E3, h1)).max() < 5e-3
    assert (np.abs(np.linalg.det(E3.astype(np.float64))) < 5e-2).all()
    np.testing.assert_allclose(np.linalg.norm(Et[vt], axis=(-2, -1)), 2 ** 0.5,
                               rtol=1e-5)
    np.testing.assert_array_equal(Et[~vt], np.broadcast_to(np.eye(3), Et[~vt].shape))
    p = torch.zeros(1, 5, 2)
    E, valid = T.run_5point_essential(p, p)
    assert torch.isfinite(E).all()


def _scene(seed):
    """_scene_matches at f = 2000 px: its 0.1 px noise sits 40x below the
    3e-7 squared threshold, so no true inlier is borderline."""
    rng = np.random.default_rng(seed)
    K1 = np.array([[2000.0, 0, 320], [0, 2000.0, 240], [0, 0, 1]], np.float32)
    kp0, kp1, valid = _scene_matches(rng, 4, K1, 64, 40, 8)
    return kp0, kp1, valid, np.tile(K1[None], (4, 1, 1))


@pytest.mark.parametrize("seed", [1, 2])
def test_5pt_estimate_pose_matches_jax(seed):
    """5-point RANSAC (1024 hypotheses: 51 samples of 5) on scenes with 8
    outliers among 40 matches, handed the JAX sampler's (B, 51, 5)
    uniforms, in the no-prior round and then the prior round (the prior:
    the JAX package's first-round pose): num_inliers equal, R and t
    within 1e-3. The polish makes the two agree: it re-fits the same
    inliers. Where it is refused (it would lose an inlier) a round keeps
    its raw 5-point hypothesis, and those differ between the packages at
    f32 level (see the module note): seeds 0 and 3 of this generator do
    that in the prior round, with t 3.7e-3 and 8.7e-3 apart."""
    kp0, kp1, valid, K = _scene(seed)
    pcl = np.array(default_prior_pcl())
    key = jax.random.PRNGKey(1)
    prior = None
    for solver in ("prior_ransac_noprior", "prior_ransac"):
        cfg = SolverConfig(solver=solver, num_hypotheses=1024, minimal_solver="5pt")
        n_samples, S, _ = cfg.ransac_config(False).sampling()
        assert (n_samples, S) == (51, 5)
        u = jax.random.uniform(key, (4, n_samples, S))
        ref = jestimate(key, jnp.asarray(kp0), jnp.asarray(kp1), jnp.asarray(K),
                        jnp.asarray(K), jnp.asarray(valid),
                        prior_rt=None if prior is None else jnp.asarray(prior),
                        cfg=JSolverConfig(solver=solver, num_hypotheses=1024,
                                          minimal_solver="5pt"))
        out = estimate_pose(
            torch.from_numpy(kp0), torch.from_numpy(kp1), torch.from_numpy(K),
            torch.from_numpy(K), torch.from_numpy(valid),
            prior_rt=None if prior is None else torch.from_numpy(prior), cfg=cfg,
            prior_pcl=torch.from_numpy(pcl), uniforms=torch.from_numpy(np.array(u)))
        assert (np.asarray(ref.num_inliers) >= 32).all()
        np.testing.assert_array_equal(out.num_inliers.numpy(), np.asarray(ref.num_inliers))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-3)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-3)
        prior = np.asarray(ref.rt34)


def test_5pt_uniforms_shape_is_checked():
    kp0, kp1, valid, K = _scene(0)
    cfg = SolverConfig(num_hypotheses=256, minimal_solver="5pt")
    with pytest.raises(ValueError, match=r"\(4, 12, 5\)"):
        estimate_pose(torch.from_numpy(kp0), torch.from_numpy(kp1),
                      torch.from_numpy(K), torch.from_numpy(K),
                      torch.from_numpy(valid), cfg=cfg,
                      uniforms=torch.zeros(4, 256, 8))
