"""far_tpu_torch end to end against far_tpu, and the port's guard rails.

The slice: the port's far_forward (8-point solver, both RANSAC rounds,
MoE fusion) against JAX's far_forward on the same weights and images,
with JAX's sampler uniforms and JAX's prior point cloud handed to the
port. Equal: num_inliers and success. Within 1e-3: R, t, gating and the
solver's pose. E equal up to sign (eigh/SVD sign conventions differ
between libraries), checked on the solver alone.
"""

import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu import pipeline as jpipeline
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.pipeline import build_inference_fn as jbuild
from far_tpu.solvers.pose_estimation import default_prior_pcl
from far_tpu.types import PairBatch as JPairBatch
from far_tpu.utils import config as jconfig
from far_tpu.utils.convert_weights import convert_loftr_state_dict
from far_tpu_torch.pipeline import far_forward, init_model, make_solver_configs
from far_tpu_torch.types import MatcherOutput, MatchResult, PairBatch
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import build_loftr_mapping, init_weights
from test_torch_modules import build_pair, small_config, smooth_images

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _init_weights_pair(jcfg, tcfg):
    """The port's own deterministic init, carried into the JAX model. The
    JAX package's converter has no entries for the translation-scale
    head; its weights go through the port's mapping, turned forward."""
    from far_tpu_torch.models.loftr import FARLoFTR

    port = init_weights(FARLoFTR(tcfg).eval(), seed=0)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    sd = {f"matcher.{k}": v for k, v in state.items() if not k.startswith("ts_head.")}
    H, W = jcfg.image_size
    jb = JPairBatch(image0=jnp.zeros((1, H, W, 1)), image1=jnp.zeros((1, H, W, 1)),
                    K0=jnp.eye(3)[None], K1=jnp.eye(3)[None])
    jmodel = JFARLoFTR(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_loftr_state_dict(sd, zeros, jcfg)
    assert not report["missing"] and not report["unused"], report
    for torch_key, path, tf in build_loftr_mapping(tcfg)[0]:
        if torch_key.startswith("ts_head."):
            node = variables["params"]
            for k in path[:-1]:
                node = node[k]
            assert node[path[-1]].shape == tf(state[torch_key]).shape
            node[path[-1]] = tf(state[torch_key])
    return jmodel, variables, port


def _as_torch_matcher_output(jout):
    a = lambda x: torch.from_numpy(np.array(x))
    m = jout.matches
    matches = MatchResult(
        i_ids=a(m.i_ids).long(), j_ids=a(m.j_ids).long(), mconf=a(m.mconf),
        valid=a(m.valid), mkpts0=a(m.mkpts0), mkpts1=a(m.mkpts1),
        mkpts0_f=a(m.mkpts0_f), mkpts1_f=a(m.mkpts1_f), expec_f=a(m.expec_f))
    return MatcherOutput(matches=matches, feat_c0=a(jout.feat_c0),
                         feat_c1=a(jout.feat_c1))


def _scene_matches(rng, B, K, n_slots, n_valid, n_outliers):
    """Correspondences of a rigid scene seen by two cameras with
    intrinsics K: 0.1 px noise, ``n_outliers`` random pairs among the
    ``n_valid`` valid slots, the rest padding. Returns (mkpts0, mkpts1,
    valid) as numpy arrays."""
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (B, n_slots, 3))
    ang = rng.normal(0, 0.1, (B, 3))
    R = np.stack([_rotvec_to_matrix(a) for a in ang])
    t = rng.normal(0, 0.5, (B, 3))
    p1 = np.einsum("bij,bnj->bni", R, pts) + t[:, None]

    def proj(p):
        uv = p[..., :2] / p[..., 2:3]
        return uv * K[0, 0] + K[:2, 2]

    kp0 = proj(pts) + rng.normal(0, 0.1, (B, n_slots, 2))
    kp1 = proj(p1) + rng.normal(0, 0.1, (B, n_slots, 2))
    kp1[:, :n_outliers] = rng.uniform(0, 2 * K[:2, 2], (B, n_outliers, 2))
    valid = np.arange(n_slots)[None].repeat(B, 0) < n_valid
    kp0, kp1 = kp0 * valid[..., None], kp1 * valid[..., None]
    return kp0.astype(np.float32), kp1.astype(np.float32), valid


def _rotvec_to_matrix(a):
    th = np.linalg.norm(a)
    k = a / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


@pytest.mark.parametrize("weights,size,scene,solver,scale_head", [
    ("synth", (64, 64), False, "8pt", False),
    ("port_init", (128, 160), True, "8pt", False),
    ("port_init", (128, 160), True, "5pt", False),
    ("port_init", (128, 160), True, "8pt", True),
])
def test_far_forward_matches_jax(weights, size, scene, solver, scale_head,
                                 monkeypatch):
    """Without ``scene``: the whole slice from the images. With it, both
    packages' matchers are handed one MatcherOutput (JAX's coarse
    features, a rigid scene's correspondences): with random weights
    the matches are noise, and RANSAC on noise picks among near-equal
    degenerate hypotheses, whose f32 8-point solves differ between the
    two libraries' summation orders. On a scene the winning hypothesis
    is well-conditioned and everything after the matcher (EMM features,
    both RANSAC rounds, the MoE fusion) is compared on equal inputs;
    the matcher itself is held to JAX in test_torch_modules.py. The
    5-point case (FARConfig's solver) draws 51 samples a round (1024
    hypotheses) on a scene seen at f = 2000 px, where its 0.1 px noise
    is no borderline inlier, so each round's polish re-fits the same
    inliers in both packages (tests/test_torch_fivepoint.py). With
    ``scale_head`` the matcher also predicts a metric translation scale
    that every round multiplies into the solver's t: both packages'
    final t and the scale agree to 1e-3."""
    over = {"predict_translation_scale": scale_head}
    if solver == "5pt":
        over["solver"] = tconfig.SolverOptions(
            num_hypotheses=1024, refine_num_hypotheses=1024, minimal_solver="5pt")
    jcfg = small_config(jconfig, image_size=size, **{
        k: jconfig.SolverOptions(**dataclasses.asdict(v)) if k == "solver" else v
        for k, v in over.items()})
    tcfg = small_config(tconfig, image_size=size, **over)
    if weights == "synth":
        jmodel, variables, port, _, _ = build_pair(jcfg, tcfg)
    else:
        jmodel, variables, port = _init_weights_pair(jcfg, tcfg)
    rng = np.random.default_rng(11)
    B = 2
    im0, im1 = smooth_images(rng, B, *size, shift=(8, 16))
    H, W = size
    f = (2000.0 if solver == "5pt" else 500.0) if scene else 70.0
    K1 = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    K = np.tile(K1[None], (B, 1, 1))
    key = jax.random.PRNGKey(3)
    jb = JPairBatch(image0=jnp.asarray(im0), image1=jnp.asarray(im1),
                    K0=jnp.asarray(K), K1=jnp.asarray(K))
    if scene:
        jout = jax.jit(functools.partial(jmodel.apply, method=JFARLoFTR.match))(
            variables, jb)
        kp0, kp1, valid = _scene_matches(rng, B, K1, jcfg.match.max_matches,
                                         26, 4)
        jout = jout.replace(matches=jout.matches.replace(
            mkpts0_f=jnp.asarray(kp0), mkpts1_f=jnp.asarray(kp1),
            valid=jnp.asarray(valid)))
        # far_tpu/pipeline.py:far_forward calls FARLoFTR.match by name
        monkeypatch.setattr(jpipeline, "FARLoFTR", types.SimpleNamespace(
            match=lambda module, batch, train=False: jout,
            regress_features=JFARLoFTR.regress_features,
            regress_fuse=JFARLoFTR.regress_fuse))
        own_match = port.match  # its scale head's output is the port's own
        port.match = lambda batch: dataclasses.replace(
            _as_torch_matcher_output(jout),
            translation_scale=own_match(batch).translation_scale)
    ref = jbuild(jmodel)(variables, jb, key)

    # the JAX sampler's draws, split as far_tpu/pipeline.py:94,106 does
    so = jcfg.solver
    k0, k1 = jax.random.split(key)
    refine_keys = jax.random.split(k1, so.fine_pred_steps - 1)
    first, refine = make_solver_configs(tcfg)
    uniforms = [jax.random.uniform(k0, (B, *first.ransac_config(False).sampling()[:2]))]
    uniforms += [jax.random.uniform(k, (B, *refine.ransac_config(True).sampling()[:2]))
                 for k in refine_keys]
    tb = PairBatch(image0=torch.from_numpy(im0), image1=torch.from_numpy(im1),
                   K0=torch.from_numpy(K), K1=torch.from_numpy(K))
    with torch.inference_mode():
        out = far_forward(port, tb,
                          uniforms=[torch.from_numpy(np.array(u)) for u in uniforms],
                          prior_pcl=torch.from_numpy(np.array(default_prior_pcl())))

    np.testing.assert_array_equal(out.matches.valid.numpy(),
                                  np.asarray(ref.matches.valid))
    if scene:  # RANSAC really runs on both pairs and finds the scene
        assert bool(np.asarray(ref.success).all())
        assert (np.asarray(ref.num_inliers) >= 20).all()
    np.testing.assert_array_equal(out.success.numpy(), np.asarray(ref.success))
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    names = ("R", "t", "gating", "solver_rt")
    if scale_head:
        names += ("translation_scale",)
        assert abs(float(np.asarray(ref.translation_scale).mean())) > 1e-2
    else:
        assert out.translation_scale is None
    for name in names:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-3, err_msg=name)


def test_solver_essential_up_to_sign():
    """The last round's E from both packages' RANSAC on the same points
    and draws: equal up to sign."""
    from far_tpu.solvers.pose_estimation import SolverConfig as JSolverConfig
    from far_tpu.solvers.pose_estimation import estimate_pose as jestimate
    from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose

    rng = np.random.default_rng(2)
    B, N = 2, 48
    pts = rng.uniform([-2, -2, 3], [2, 2, 8], (B, N, 3))
    R = np.stack([np.eye(3)] * B)
    tvec = np.array([[0.3, 0.0, 0.05], [-0.2, 0.1, 0.0]])
    p1 = pts @ R.transpose(0, 2, 1) + tvec[:, None]
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    proj = lambda p: p[..., :2] / p[..., 2:3] * 100.0 + np.array([64, 48])
    kp0 = (proj(pts) + rng.normal(0, 0.3, (B, N, 2))).astype(np.float32)
    kp1 = (proj(p1) + rng.normal(0, 0.3, (B, N, 2))).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[1, -5:] = False
    Kb = np.tile(K[None], (B, 1, 1))
    prior = np.concatenate([R, tvec[..., None]], -1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (B, 64, 8))
    pcl = np.array(default_prior_pcl())
    for solver, prior_rt in (("prior_ransac_noprior", None),
                             ("prior_ransac", prior)):
        jcfg = JSolverConfig(solver=solver, num_hypotheses=64)
        ref = jestimate(key, jnp.asarray(kp0), jnp.asarray(kp1), jnp.asarray(Kb),
                        jnp.asarray(Kb), jnp.asarray(valid),
                        prior_rt=None if prior_rt is None else jnp.asarray(prior_rt),
                        cfg=jcfg)
        out = estimate_pose(
            torch.from_numpy(kp0), torch.from_numpy(kp1), torch.from_numpy(Kb),
            torch.from_numpy(Kb), torch.from_numpy(valid),
            prior_rt=None if prior_rt is None else torch.from_numpy(prior_rt),
            cfg=SolverConfig(solver=solver, num_hypotheses=64),
            prior_pcl=torch.from_numpy(pcl),
            uniforms=torch.from_numpy(np.array(u)))
        E, jE = out.E.numpy(), np.asarray(ref.E)
        d = np.minimum(np.abs(E - jE).max(axis=(1, 2)),
                       np.abs(E + jE).max(axis=(1, 2)))
        assert (d <= 1e-3).all(), (solver, d)
        np.testing.assert_array_equal(out.num_inliers.numpy(),
                                      np.asarray(ref.num_inliers))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-3)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-3)


@pytest.mark.parametrize("option,tol", [
    (dict(scoring="magsac"), 1e-3), (dict(error_fn="symmetric"), 1e-3),
    (dict(polish=False), 5e-3), (dict(linalg="exact"), 1e-3),
])
def test_ransac_options_match_jax(option, tol):
    """Each RansacConfig option on one scene (8-point, 256 hypotheses, the
    JAX sampler's uniforms handed to the port): num_inliers equal, R, t
    and E (up to sign) within ``tol``. linalg='exact' scores unprojected
    DLT hypotheses (eigh) and recovers the pose through the SVD
    decomposition. Without the polish the answer is a raw 8-point
    hypothesis, solved by 4 steps of f32 inverse iteration on a nearly
    singular 9x9 system: the two packages' agree to 2e-3 there (5e-3
    allowed), the polished least-squares fits to 1e-4."""
    from far_tpu.solvers.ransac import RansacConfig as JRansacConfig
    from far_tpu.solvers.ransac import prior_ransac as jprior_ransac
    from far_tpu_torch.solvers.ransac import RansacConfig, prior_ransac

    rng = np.random.default_rng(4)
    # f = 2000 px: the scene's 0.1 px noise makes no borderline inlier
    K = np.array([[2000.0, 0, 320], [0, 2000.0, 240], [0, 0, 1]], np.float32)
    kp0, kp1, valid = _scene_matches(rng, 4, K, 64, 48, 6)
    norm = lambda kp: ((kp - K[:2, 2]) / K[0, 0]).astype(np.float32)
    kp0n, kp1n = norm(kp0), norm(kp1)
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (4, 256, 8))
    ref = jprior_ransac(key, jnp.asarray(kp0n), jnp.asarray(kp1n), jnp.asarray(valid),
                        cfg=JRansacConfig(num_hypotheses=256, **option))
    out = prior_ransac(torch.from_numpy(kp0n), torch.from_numpy(kp1n),
                       torch.from_numpy(valid), cfg=RansacConfig(num_hypotheses=256, **option),
                       uniforms=torch.from_numpy(np.array(u)))
    assert (np.asarray(ref.num_inliers) >= 30).all()
    np.testing.assert_array_equal(out.num_inliers.numpy(), np.asarray(ref.num_inliers))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=tol)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0, atol=tol)
    E, jE = out.E.numpy(), np.asarray(ref.E)
    d = np.minimum(np.abs(E - jE).max(axis=(1, 2)), np.abs(E + jE).max(axis=(1, 2)))
    assert (d <= tol).all(), d


def test_ransac_config_copies_agree():
    """The port's RansacConfig has the JAX package's fields and defaults,
    and rejects an unknown option by name."""
    from far_tpu.solvers.ransac import RansacConfig as JRansacConfig
    from far_tpu_torch.solvers.ransac import RansacConfig

    assert [f.name for f in dataclasses.fields(RansacConfig)] == \
        [f.name for f in dataclasses.fields(JRansacConfig)]
    assert dataclasses.asdict(RansacConfig()) == dataclasses.asdict(JRansacConfig())
    assert RansacConfig(minimal_solver="5pt").sampling() == (102, 5, 20)
    assert RansacConfig(minimal_solver="5pt", num_hypotheses=1024).sampling()[0] == 51
    with pytest.raises(ValueError, match="scoring"):
        RansacConfig(scoring="lmeds")


def _imports_of(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "far_tpu")


def test_port_never_imports_jax_or_far_tpu():
    """No import statement of the port or of chip_smoke.py names JAX,
    Flax or far_tpu; importing every port module loads none of them."""
    files = sorted((REPO / "far_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(f.name, m) for f in files for m in _imports_of(f) if _forbidden(m)]
    assert not bad, bad
    code = (
        "import importlib, pkgutil, sys, far_tpu_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(far_tpu_torch.__path__,"
        " 'far_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'far_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_config_copies_agree():
    """The port's config copy has the JAX package's fields and defaults."""
    assert dataclasses.asdict(tconfig.FARConfig()) == \
        dataclasses.asdict(jconfig.FARConfig())


def test_entry_points_need_a_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = small_config(tconfig)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    model = init_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
