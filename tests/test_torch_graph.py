"""The compiled request (``far_tpu_torch.pipeline.build_inference_fn``)
and what its capture needs, on the CPU.

On a card ``build_inference_fn`` captures ``far_forward`` in a CUDA graph
once per ``request_signature`` and replays it (the port's
``jax.jit(far_forward)``); here it runs the eager request. These tests
hold what the graph relies on: the sampler's draws go through one helper
(``draw_uniforms``), so a replay and an eager request from one generator
state take the same draws; the polish's eigensolver and 3x3 SVD
(``ops/small_linalg``) as the kernels compute them (``eigh_jacobi_model``,
``svd3_model``) against ``jnp.linalg``; the fixed tables made once per
(device, dtype); the signature; and ``build_inference_fn`` against the
JAX package's jitted one. The card tests (graph replay against the eager
request, the kernels against ``torch.linalg``) are in
``tests/test_torch_hopper.py``; ``chip_smoke.py`` phase 4 runs the
compiled request at full size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline
from far_tpu.geometry.solvers import run_8point_essential as jrun_8point_essential
from far_tpu_torch.geometry import epipolar, solvers
from far_tpu_torch.geometry.solvers import normalize_points, run_8point_essential
from far_tpu_torch.models.constants import POSE_MEAN_6D, POSE_STD_6D, pose_stat
from far_tpu_torch.ops.small_linalg import (
    EIGH_SWEEPS,
    SVD3_SWEEPS,
    eigh_jacobi_model,
    svd3_model,
)
from far_tpu_torch.pipeline import (
    build_inference_fn,
    draw_uniforms,
    far_forward,
    request_signature,
)
from far_tpu_torch.solvers.pose_estimation import default_prior_pcl
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import init_weights
from far_tpu_torch.utils.tables import device_table
from test_torch_modules import small_config, smooth_images
from test_torch_pipeline import _scene_matches

torch.set_num_threads(2)
U32 = 2.0 ** -24  # float32's unit roundoff


def _camera(f, W=320, H=240):
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def _scene_model(solver):
    """A small-width port model whose matcher returns a rigid scene's
    correspondences (``_scene_matches``: 26 valid slots, 4 outliers, seen
    at f = 2000 px), and its batch."""
    over = {}
    if solver == "5pt":
        over["solver"] = tconfig.SolverOptions(
            num_hypotheses=1024, refine_num_hypotheses=1024, minimal_solver="5pt")
    cfg = small_config(tconfig, image_size=(64, 64), **over)
    from far_tpu_torch.models.loftr import FARLoFTR

    port = init_weights(FARLoFTR(cfg).eval(), seed=0)
    rng = np.random.default_rng(11)
    B = 2
    im0, im1 = smooth_images(rng, B, 64, 64, shift=(8, 16))
    K1 = _camera(2000.0, 64, 64)
    K = torch.from_numpy(np.tile(K1[None], (B, 1, 1)))
    batch = PairBatch(image0=torch.from_numpy(im0), image1=torch.from_numpy(im1), K0=K, K1=K)
    with torch.inference_mode():
        mo = port.match(batch)
    kp0, kp1, valid = _scene_matches(rng, B, K1, cfg.match.max_matches, 26, 4)
    matches = dataclasses.replace(mo.matches, mkpts0_f=torch.from_numpy(kp0),
                                  mkpts1_f=torch.from_numpy(kp1),
                                  valid=torch.from_numpy(valid))
    port.match = lambda b: dataclasses.replace(mo, matches=matches)
    return port, batch


def _fields(out, prefix=""):
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, f"{f.name}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


@pytest.mark.parametrize("solver", ["5pt", "8pt"])
def test_far_forward_draws_through_draw_uniforms(solver):
    """far_forward with a seeded CPU generator equals, bit for bit, the
    same call given draw_uniforms from a generator of the same seed (and
    so does build_inference_fn, which on a card draws through the same
    helper outside its graph); each round's draws have the shapes of
    ransac.py's sampler: (B, max(H // 20, 1), 5) for 5pt, (B, H, 8) for
    8pt, H the round's hypothesis budget."""
    port, batch = _scene_model(solver)
    cfg = port.config
    B = batch.image0.shape[0]
    draws = draw_uniforms(cfg, B, torch.Generator().manual_seed(7))
    budgets = (cfg.solver.num_hypotheses, cfg.solver.refine_num_hypotheses)
    want = [(B, max(h // 20, 1), 5) if solver == "5pt" else (B, h, 8) for h in budgets]
    assert [tuple(u.shape) for u in draws] == want
    assert all(u.dtype == torch.float32 for u in draws)
    with torch.inference_mode():
        ref = far_forward(port, batch, uniforms=draws)
        eager = far_forward(port, batch, generator=torch.Generator().manual_seed(7))
    compiled = build_inference_fn(port)(batch, generator=torch.Generator().manual_seed(7))
    assert bool(ref.success.all()) and bool((ref.num_inliers >= 20).all())
    for out in (eager, compiled):
        for (name, a), (_, b) in zip(_fields(out), _fields(ref)):
            assert torch.equal(a, b), name


def _normal_equations(p1, p2, w):
    """The polish's 9x9 X^T X as solvers.run_8point forms it."""
    p1n, _ = normalize_points(p1, w)
    p2n, _ = normalize_points(p2, w)
    x1, y1, x2, y2 = p1n[..., 0], p1n[..., 1], p2n[..., 0], p2n[..., 1]
    X = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    return (X * w[..., None]).transpose(-1, -2) @ X


def _polish_matrices(dtype):
    """X^T X of 16 scene pairs at f = 2000 px and 16 at 500 px (0.1 px
    noise, the inliers weighted 1), of 4 pairs with 7 correspondences
    (rank 7, a 2-dimensional null space) and of 4 with every point on a
    plane (noise-free: the 8-point system's null space has dimension 3).
    Returns (matrices, null-space dimension of each)."""
    rng = np.random.default_rng(4)
    mats, dims = [], []
    for f in (2000.0, 500.0):
        K = _camera(f)
        kp0, kp1, valid = _scene_matches(rng, 16, K, 64, 48, 0)
        norm = lambda kp: torch.from_numpy(((kp - K[:2, 2]) / f).astype(np.float32))
        mats.append(_normal_equations(norm(kp0), norm(kp1),
                                      torch.from_numpy(valid.astype(np.float32))))
        dims += [1] * 16
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (8, 40, 3))
    pts[4:, :, 2] = 6.0 + 0.3 * pts[4:, :, 0] - 0.2 * pts[4:, :, 1]  # planes
    t = rng.normal(0, 0.5, (8, 1, 3))
    p1 = pts + t
    x0 = torch.from_numpy((pts[..., :2] / pts[..., 2:]).astype(np.float32))
    x1 = torch.from_numpy((p1[..., :2] / p1[..., 2:]).astype(np.float32))
    w = torch.ones(8, 40)
    w[:4, 7:] = 0.0  # 7 correspondences
    mats.append(_normal_equations(x0, x1, w))
    dims += [2] * 4 + [3] * 4
    return torch.cat(mats).to(dtype), dims


def _up_to_sign(a, b):
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def test_jacobi_model_matches_jnp_eigh():
    """The kernel's Jacobi schedule (EIGH_SWEEPS sweeps) against
    jnp.linalg.eigh on the polish's matrices. In float64 (JAX under x64)
    the sweep count is what is held: the smallest eigenvector within 1e-5
    up to sign where it is unique, and inside jnp's null space (its
    component outside that space below 1e-5) where it is not (rank 7 and
    the planar scenes); eigenvalues within 1e-10 max|lambda|. In float32
    both solvers round: jnp's own smallest eigenvector is up to 1.5e-4
    from float64's on these scenes, so the model is held to jnp's within
    1e-5 + 64 u max|lambda| / gap (u = 2^-24, gap = lambda_2 - lambda_1 of
    the float64 spectrum), first-order perturbation's bound with room for
    both solvers' rounding."""
    M64, dims = _polish_matrices(torch.float64)
    with jax.enable_x64(True):
        jw, jV = (np.asarray(a) for a in jnp.linalg.eigh(jnp.asarray(M64.numpy())))
    w, V = (a.numpy() for a in eigh_jacobi_model(M64.clone(), EIGH_SWEEPS))
    scale = np.abs(jw).max(-1)
    assert (np.abs(w - jw).max(-1) <= 1e-10 * scale).all()
    for i, k in enumerate(dims):
        v = V[i, :, 0]
        if k == 1:
            assert _up_to_sign(v, jV[i, :, 0]) <= 1e-5, i
        else:
            null = jV[i, :, :k]
            assert np.abs(v - null @ (null.T @ v)).max() <= 1e-5, (i, k)

    unique = np.array(dims) == 1
    M32 = M64[unique].float()
    _, jV32 = (np.asarray(a) for a in jnp.linalg.eigh(jnp.asarray(M32.numpy())))
    _, V32 = eigh_jacobi_model(M32.clone(), EIGH_SWEEPS)
    gap = jw[unique, 1] - jw[unique, 0]
    tol = 1e-5 + 64 * U32 * scale[unique] / gap
    assert (_up_to_sign(V32[:, :, 0].numpy(), jV32[:, :, 0]) <= tol).all()


def _projections(U, S, Vh):
    S2 = np.concatenate([S[..., :2], np.zeros_like(S[..., 2:])], -1)
    rank2 = (U * S2[..., None, :]) @ Vh
    essential = (U * np.array([1.0, 1.0, 0.0], U.dtype)) @ Vh
    return rank2, essential


def test_svd3_model_matches_jnp_svd():
    """The kernel's 3x3 SVD (SVD3_SWEEPS sweeps on F^T F) against
    jnp.linalg.svd in float32 on the 8-point polish's F of the scenes
    (the DLT solution before its rank-2 projection) and on 64 Gaussian
    matrices: singular values within 1e-5 max S, and the products the
    solver forms, the rank-2 projection (U diag(s1, s2, 0)) Vh and the
    essential projection U diag(1, 1, 0) Vh, within 1e-5 max|ref|."""
    M, dims = _polish_matrices(torch.float32)
    f = torch.linalg.eigh(M[np.array(dims) == 1])[1][..., :, 0]
    F = torch.cat([f.reshape(-1, 3, 3),
                   torch.from_numpy(np.random.default_rng(5).standard_normal(
                       (64, 3, 3)).astype(np.float32))])
    U, S, Vh = (a.numpy() for a in svd3_model(F, SVD3_SWEEPS))
    jU, jS, jVh = (np.asarray(a) for a in jnp.linalg.svd(jnp.asarray(F.numpy())))
    assert (np.abs(S - jS).max(-1) <= 1e-5 * jS.max(-1)).all()
    assert (np.diff(S, axis=-1) <= 0).all()
    for ours, ref in zip(_projections(U, S, Vh), _projections(jU, jS, jVh)):
        err = np.abs(ours - ref).max(axis=(-2, -1))
        assert (err <= 1e-5 * np.abs(ref).max(axis=(-2, -1))).all(), err.max()


def near_rank1(n: int, ratio: float, seed: int) -> np.ndarray:
    """n float32 3x3 matrices U diag(1, ratio, 0) V^T, U and V Haar-random
    rotations: nearly rank 1 for a small ratio, rank 2 up to rounding."""
    rng = np.random.default_rng(seed)

    def rotations():
        q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
        return q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]

    U, V = rotations(), rotations()
    return ((U * np.array([1.0, ratio, 0.0])) @ V.transpose(0, 2, 1)).astype(np.float32)


@pytest.mark.parametrize("ratio", [1e-2, 1e-3])
def test_svd3_model_nearly_rank1(ratio):
    """The kernel's 3x3 SVD on 256 F with s2 / s1 = ratio, s3 = 0, against
    jnp.linalg.svd in float64 (JAX under x64) on the same float32 F:
    singular values within 1e-5 max S; the rank-2 projection within 1e-5
    max|ref|. The essential projection U diag(1, 1, 0) Vh hangs on u2, v2,
    which any float32 SVD gets to about u s1 / (s2 - s3) (first-order
    perturbation; jnp's own float32 answer is up to about twice that from
    float64's here), so it is held to 1e-5 + 8 u s1 / (s2 - s3) of
    max|ref|, u = 2^-24. Jacobi on F^T F misses both: its v2, v3 are good
    to u / ratio^2 only."""
    F = near_rank1(256, ratio, seed=int(-np.log10(ratio)))
    U, S, Vh = (a.numpy().astype(np.float64) for a in svd3_model(torch.from_numpy(F),
                                                                   SVD3_SWEEPS))
    with jax.enable_x64(True):
        jU, jS, jVh = (np.asarray(a) for a in jnp.linalg.svd(jnp.asarray(F.astype(np.float64))))
    assert (np.abs(S - jS).max(-1) <= 1e-5 * jS.max(-1)).all()
    assert (np.diff(S, axis=-1) <= 0).all()
    (rank2, essential), (ref2, refe) = _projections(U, S, Vh), _projections(jU, jS, jVh)
    err2 = np.abs(rank2 - ref2).max(axis=(-2, -1))
    assert (err2 <= 1e-5 * np.abs(ref2).max(axis=(-2, -1))).all(), err2.max()
    erre = np.abs(essential - refe).max(axis=(-2, -1))
    tol = (1e-5 + 8 * U32 * jS[:, 0] / (jS[:, 1] - jS[:, 2])) * np.abs(refe).max(axis=(-2, -1))
    assert (erre <= tol).all(), (erre / tol).max()


def test_run_8point_essential_through_the_models_matches_jax(monkeypatch):
    """solvers.run_8point_essential (impl='eigh', the polish) with the
    eigensolver and SVD computed as the kernels compute them, against the
    JAX package's on weighted scene correspondences: E within 1e-3 up to
    sign, the tolerance of the RANSAC option tests
    (tests/test_torch_pipeline.py::test_ransac_options_match_jax)."""
    monkeypatch.setattr(solvers, "eigh_small", lambda A: eigh_jacobi_model(A, EIGH_SWEEPS))
    monkeypatch.setattr(solvers, "svd3", lambda F: svd3_model(F, SVD3_SWEEPS))
    rng = np.random.default_rng(6)
    K = _camera(2000.0, 640, 480)
    kp0, kp1, valid = _scene_matches(rng, 8, K, 64, 48, 6)
    norm = lambda kp: ((kp - K[:2, 2]) / K[0, 0]).astype(np.float32)
    w = valid.astype(np.float32)
    E = run_8point_essential(torch.from_numpy(norm(kp0)), torch.from_numpy(norm(kp1)),
                             weights=torch.from_numpy(w), impl="eigh").numpy()
    jE = np.asarray(jrun_8point_essential(jnp.asarray(norm(kp0)), jnp.asarray(norm(kp1)),
                                          weights=jnp.asarray(w), impl="eigh"))
    d = _up_to_sign(E.reshape(-1, 9), jE.reshape(-1, 9))
    assert (d <= 1e-3).all(), d


def test_validate_far_runs_through_the_given_fn():
    """validate_far(fn=...) runs every batch through the callable it is
    given (a trainer keeps one compiled request across its validations,
    so later passes replay), and its table equals that of a pass that
    builds its own from the same generator state, exactly."""
    from far_tpu_torch.data.synthetic import SyntheticPairDataset
    from far_tpu_torch.tools.guard import load_guard
    from far_tpu_torch.train.validation import validate_far

    model, meta = load_guard(device="cpu")
    ds = SyntheticPairDataset(n=4, hw=model.config.image_size, seed=meta["eval_seed"],
                              n_scenes=4, max_angle_deg=12.0)
    inner = build_inference_fn(model)
    calls = []

    def fn(batch, **kw):
        calls.append(batch.image0.shape[0])
        return inner(batch, **kw)

    tables = [validate_far(model, ds, 2, generator=torch.Generator().manual_seed(3), fn=f)
              for f in (fn, fn, None)]
    assert calls == [2, 2, 2, 2]
    assert tables[0] == tables[1] == tables[2]


def test_tables_are_made_once_per_device_and_dtype():
    """The fixed tables the request reads hold today's values, and each is
    one tensor per (device, dtype) across calls: the pose statistics, the
    prior's probe cloud, the W of the SVD decomposition, the essential
    singular values. A table first made under inference_mode is a normal
    tensor, so a training step can save it for backward."""
    like = torch.zeros(2, dtype=torch.float32)
    with torch.inference_mode():
        mean = pose_stat("mean", like)
    assert not mean.is_inference()
    assert mean is pose_stat("mean", like)
    assert torch.equal(mean, torch.from_numpy(POSE_MEAN_6D))
    assert torch.equal(pose_stat("std", like), torch.from_numpy(POSE_STD_6D))
    std64 = pose_stat("std", like.double())
    assert std64.dtype == torch.float64 and std64 is not pose_stat("std", like)
    assert torch.equal(std64, torch.from_numpy(POSE_STD_6D).double())

    g = torch.Generator().manual_seed(0)
    want = torch.rand((300, 3), generator=g, dtype=torch.float32) * 6 - 3
    pcl = default_prior_pcl("cpu", torch.float32)
    assert torch.equal(pcl, want) and pcl is default_prior_pcl(None)
    assert torch.equal(default_prior_pcl("cpu", torch.float64), want.double())

    W = device_table(epipolar._w_table, device="cpu", dtype=torch.float32)
    assert torch.equal(W, torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]))
    assert W is device_table(epipolar._w_table, device="cpu", dtype=torch.float32)
    S = device_table(solvers._essential_sv, device="cpu", dtype=torch.float32)
    assert torch.equal(S, torch.tensor([1.0, 1.0, 0.0]))
    assert S is device_table(solvers._essential_sv, device="cpu", dtype=torch.float32)


def test_request_signature():
    """request_signature as a pure function: equal inputs give an equal
    key; another B, another dtype, uniforms given or not, another
    prior_pcl shape or another parameter storage give another; an in-place
    load_state_dict keeps the key."""
    from far_tpu_torch.models.loftr import FARLoFTR

    cfg = small_config(tconfig)
    model = init_weights(FARLoFTR(cfg).eval(), seed=0)

    def batch(B, dtype=torch.float32):
        img = torch.zeros(B, 64, 64, 1, dtype=dtype)
        K = torch.eye(3).expand(B, 3, 3)
        return PairBatch(image0=img, image1=img.clone(), K0=K, K1=K)

    key = request_signature(model, batch(2))
    assert request_signature(model, batch(2)) == key
    draws = draw_uniforms(cfg, 2)
    others = [request_signature(model, batch(3)),
              request_signature(model, batch(2, torch.float64)),
              request_signature(model, batch(2), uniforms=draws),
              request_signature(model, batch(2), prior_pcl=torch.zeros(300, 3)),
              request_signature(model, batch(2), prior_pcl=torch.zeros(100, 3))]
    assert len({key, *others}) == len(others) + 1
    model.load_state_dict(init_weights(FARLoFTR(cfg).eval(), seed=1).state_dict())
    assert request_signature(model, batch(2)) == key
    p = next(model.parameters())
    p.data = p.data.clone()
    assert request_signature(model, batch(2)) != key


def test_build_inference_fn_matches_jax(monkeypatch):
    """build_inference_fn on the CPU against the JAX package's jitted
    build_inference_fn with the same uniforms and probe cloud: the body of
    test_far_forward_matches_jax (the 8-point scene case) with the port's
    call going through build_inference_fn, at its tolerance (1e-3)."""
    monkeypatch.setattr(
        test_torch_pipeline, "far_forward",
        lambda port, tb, uniforms, prior_pcl: build_inference_fn(port)(
            tb, uniforms=uniforms, prior_pcl=prior_pcl))
    from far_tpu.utils import config as jconfig

    jcfg = small_config(jconfig, image_size=(128, 160))
    tcfg = small_config(tconfig, image_size=(128, 160))
    jmodel, variables, port = test_torch_pipeline._init_weights_pair(jcfg, tcfg)
    test_torch_pipeline.far_forward_against_jax(jmodel, variables, port, jcfg, tcfg,
                                                True, monkeypatch)
