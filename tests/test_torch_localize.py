"""far_tpu_torch.eval.localize against far_tpu.eval.localize, on the CPU.

Every name of the port's ``__all__`` runs on the inputs that
tests/test_localize.py builds (its ``make_scene`` and ``build_pairs``:
one query and k reference views with known absolute poses, noisy or
outlying relative predictions), each package's classes built from the
same arrays. Both are float64 numpy: results must agree bit for bit or
within 1e-12 relative. The pipelines' saved ``.npy``, pose text files
and precision/recall plots are compared as files.
"""

import numpy as np
import pytest

from far_tpu.eval import localize as jl
from far_tpu_torch.eval import localize as tl
from test_localize import _rot, build_pairs, make_scene

RTOL = 1e-12


def same(a, b, what=""):
    """Equal structure; floats within RTOL relative, the rest equal.
    Pose and pair objects compare by their attributes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, np.ndarray):
        assert type(a).__name__ == type(b).__name__, what
        same(vars(a), vars(b), what)
    elif a is None or isinstance(a, (str, bool)):
        assert a == b, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


def test_all_is_the_jax_packages():
    assert tl.__all__ == jl.__all__
    assert all(callable(getattr(tl, n)) for n in tl.__all__)


_rng = lambda seed: np.random.default_rng(seed)
HELPERS = {
    "vec_angle_error": lambda r: (r.normal(size=(32, 3)), r.normal(size=(32, 3))),
    "quat_angle_error": lambda r: (r.normal(size=(16, 4)), r.normal(size=(16, 4))),
    "quats_to_matrices": lambda r: (r.normal(size=(16, 4)),),
    "matrices_to_quats": lambda r: (np.stack([_rot(s) for s in range(16)]),),
    "average_quaternions": lambda r: (jl.matrices_to_quats(
        np.stack([_rot(s) for s in range(10)])),),
    "geometric_median": lambda r: (r.normal(size=(25, 3)),),
    "compose_projection_matrix": lambda r: (_rot(3), r.normal(size=3)),
    "triangulate_views": lambda r: (r.normal(size=(6, 4, 2)), r.normal(size=(6, 4, 3, 4))),
    "hat": lambda r: (r.normal(size=(5, 3)),),
    "project_onto_essential_space": lambda r: (r.normal(size=(4, 3, 3)),),
    "essential_matrix_from_pose": lambda r: (_rot(7), r.normal(size=3)),
    "decompose_essential_matrix": lambda r: (r.normal(size=(3, 3)),),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_match_jax(name):
    args = HELPERS[name](_rng(sorted(HELPERS).index(name)))
    same(getattr(tl, name)(*args), getattr(jl, name)(*args), name)


def test_geometric_median_on_a_sample_point():
    """The Vardi-Zhang branch: an iterate that lands on a sample point."""
    X = np.array([[0.0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    same(tl.geometric_median(X), jl.geometric_median(X))


def _pairs(pair_type, **scene):
    s = make_scene(pair_type=pair_type, **scene)
    return (s, build_pairs(s, pair_type, tl)["q0"]["test_pairs"],
            build_pairs(s, pair_type, jl)["q0"]["test_pairs"])


@pytest.mark.parametrize("pair_type", ["relapose", "ess"])
def test_pair_containers_match_jax(pair_type):
    _, ours, ref = _pairs(pair_type, seed=11, k=7, rot_noise_deg=3.0, t_noise_frac=0.05,
                          n_outliers=2)
    same(ours, ref, pair_type)
    if pair_type == "ess":
        for o, r in zip(ours, ref):
            o.set_rid(1), r.set_rid(1)
            o.set_opposite_trans_pred(), r.set_opposite_trans_pred()
            same(o.get_rela_q(), r.get_rela_q())
            assert o.is_invalid() == r.is_invalid()
        same(ours, ref, pair_type)


@pytest.mark.parametrize("pair_type", ["relapose", "ess"])
def test_find_inliers_and_estimate_model_match_jax(pair_type):
    scene, ours, ref = _pairs(pair_type, seed=11, k=7, rot_noise_deg=3.0,
                              t_noise_frac=0.05, n_outliers=2)
    q = jl.matrices_to_quats(scene["r_q"])
    for thres in (2.0, 10.0, 45.0):
        inl = []
        for mod, pairs in ((tl, ours), (jl, ref)):
            hypo = mod.AbsPose(q, scene["c_q"] + 0.05)
            inl.append(mod.find_inliers(hypo, pairs, thres, pair_type=pair_type,
                                        update_trans=True))
        same(inl[0], inl[1], f"inliers at {thres}")
        same(ours, ref, "pairs after update_trans")
        if len(inl[0]) >= 2:
            same(tl.estimate_model(ours, inl[0], pair_type),
                 jl.estimate_model(ref, inl[1], pair_type), f"model at {thres}")


@pytest.mark.parametrize("pair_type", ["relapose", "ess"])
def test_local_optimisation_matches_jax(pair_type):
    """Ten random half-subsets a call, from equal generators."""
    scene, ours, ref = _pairs(pair_type, seed=12, k=10, rot_noise_deg=2.0,
                              t_noise_frac=0.03, n_outliers=2)
    q = jl.matrices_to_quats(scene["r_q"])
    out = [mod.local_optimisation(pairs, mod.AbsPose(q, scene["c_q"] + 0.1), 1.414, 10.0, 10,
                                  pair_type, rng=np.random.default_rng(3))
           for mod, pairs in ((tl, ours), (jl, ref))]
    assert len(out[0][0]) >= 2
    same(out[0], out[1], pair_type)


def _pair_data(pair_type, mod, seeds, **scene):
    data = {}
    for i, s in enumerate(seeds):
        data[f"q{i}"] = build_pairs(make_scene(seed=s, pair_type=pair_type, **scene),
                                    pair_type, mod)["q0"]
    return data


@pytest.mark.parametrize("pair_type", ["relapose", "ess"])
def test_ransac_matches_jax(pair_type):
    """Four noisy queries with an outlier each (local optimisation on, its
    default generator), one with a single pair (approximated) and one with
    none (the failure sentinel): every return and loc_results entry."""
    out, locs = [], []
    for mod in (tl, jl):
        data = _pair_data(pair_type, mod, range(40, 44), k=6, rot_noise_deg=2.0,
                          t_noise_frac=0.03, n_outliers=1)
        data["single"] = build_pairs(make_scene(seed=6, k=1, pair_type=pair_type),
                                     pair_type, mod)["q0"]
        data["empty"] = {"test_abs_pose": mod.AbsPose(np.array([1.0, 0, 0, 0]), np.zeros(3)),
                         "test_pairs": []}
        loc = {}
        out.append(mod.ransac(data, 10.0, pair_type=pair_type, loc_results=loc))
        locs.append(loc)
    assert out[0][1] == ["single"]
    same(out[0], out[1], "returns")
    same(locs[0], locs[1], "loc_results")


def test_precision_recall_functions_match_jax():
    r = _rng(7)
    inliers = r.integers(0, 50, size=40).astype(float)
    tp = r.random(40) > 0.4
    terr, rerr, reprerr = r.random(40), 10 * r.random(40), 20 * r.random(40)
    same(tl.precision_recall(inliers, tp, 3), jl.precision_recall(inliers, tp, 3))
    same(tl.precision_recall_pose_error(inliers, terr, rerr, 2, (0.5, 5)),
         jl.precision_recall_pose_error(inliers, terr, rerr, 2, (0.5, 5)))
    same(tl.precision_recall_repr_error(inliers, reprerr, 1, 8.0),
         jl.precision_recall_repr_error(inliers, reprerr, 1, 8.0))


def test_cal_errors_match_jax():
    """The no-RANSAC metrics on three noisy queries and an empty one."""
    out = []
    for mod in (tl, jl):
        data = _pair_data("relapose", mod, (20, 21, 22), k=5, rot_noise_deg=1.0,
                          t_noise_frac=0.02)
        data["empty"] = {"test_abs_pose": mod.AbsPose(np.array([1.0, 0, 0, 0]), np.zeros(3)),
                         "test_pairs": []}
        loc = {}
        out.append((mod.cal_rela_pose_err({k: v for k, v in data.items() if v["test_pairs"]}),
                    mod.cal_abs_pose_err_metric(data, ((0.25, 2), (0.5, 5)), loc), loc,
                    mod.cal_abs_pose_err(data, (2, 5))))
    same(out[0], out[1])


def _result_dict(mod):
    return {f"scene{s}": {"pair_data": _pair_data("relapose", mod, (30 + 2 * s, 31 + 2 * s),
                                                  k=5, rot_noise_deg=1.0, t_noise_frac=0.02),
                          "no_pt_pairs": []} for s in range(2)}


@pytest.mark.parametrize("with_ransac", [True, False])
def test_pipelines_and_artifacts_match_jax(with_ransac, tmp_path):
    """Both pipelines, then ``save_results_visualisation`` and
    ``generate_precision_recall_plots`` on what each saved: the returns,
    the loaded .npy, the pose text files and the plots (file bytes)."""
    out, dirs = [], []
    for mod in (tl, jl):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        save = str(d / "loc.npy")
        if with_ransac:
            out.append(mod.eval_pipeline_with_ransac(
                _result_dict(mod), ransac_thres=[10.0, 5.0], ransac_iter=2, ransac_miu=1.414,
                pair_type="relapose", err_thres=[(0.25, 2), (0.5, 5)], save_res_path=save))
        else:
            out.append(mod.eval_pipeline_without_ransac(
                _result_dict(mod), err_thres=((0.25, 2), (0.5, 5)), save_res_path=save))
        mod.save_results_visualisation(save)
        mod.generate_precision_recall_plots(save, pose_threshold=(0.5, 5))
        dirs.append(d)
    same(out[0], out[1], "returns")
    same(np.load(dirs[0] / "loc.npy", allow_pickle=True).item(),
         np.load(dirs[1] / "loc.npy", allow_pickle=True).item(), "saved")
    names = sorted(p.name for p in dirs[1].iterdir())
    assert sorted(p.name for p in dirs[0].iterdir()) == names
    assert {"pose_scene0.txt", "pr_scene1.jpg", "pr_all.jpg"} <= set(names)
    for n in names:
        if n != "loc.npy":
            assert (dirs[0] / n).read_bytes() == (dirs[1] / n).read_bytes(), n
