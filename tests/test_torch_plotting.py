"""far_tpu_torch's figures and videos against far_tpu's, on the CPU.

``make_matching_figure`` draws the same RGBA buffer as the JAX package's
on the same arrays (bit-equal); ``save_video`` writes the same artifacts
(the mp4's decoded frames equal, and, where no codec opens, the same PNG
frames byte for byte); ``validate_far(fig_dir=...)`` with the network
guard's weights writes the file names JAX's writes. Without matplotlib
the port still imports, and asking for a figure raises ImportError
naming it.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far_tpu.train.validation as jvalidation
from far_tpu.data import SyntheticPairDataset as JSyntheticPairDataset
from far_tpu.eval import localize as jl
from far_tpu.eval import visualise as jvis
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.pipeline import build_inference_fn as jbuild_inference_fn
from far_tpu.utils import plotting as jplot
from far_tpu_torch.data.synthetic import SyntheticPairDataset
from far_tpu_torch.eval import localize as tl
from far_tpu_torch.eval import visualise as tvis
from far_tpu_torch.tools.guard import GUARD_NPZ, load_guard
from far_tpu_torch.train import validation as tvalidation
from far_tpu_torch.utils import plotting as tplot
from far_tpu_torch.utils.convert_weights import load_flax_npz
from test_localize import build_pairs, make_scene
from test_torch_guard import _jax_tiny_config

torch.set_num_threads(2)


def _rgba(fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    jplot.plt.close(fig)
    return out


@pytest.mark.parametrize("n,with_errs", [(40, True), (40, False), (0, True)])
def test_matching_figure_bit_equal(n, with_errs):
    """40 matches coloured by their epipolar errors, or plain green, and
    none: the rendered RGBA buffers are equal."""
    rng = np.random.default_rng(n + with_errs)
    im0, im1 = rng.random((2, 48, 64, 1)).astype(np.float32)
    k0 = (rng.random((n, 2)) * [64, 48]).astype(np.float32)
    k1 = (rng.random((n, 2)) * [64, 48]).astype(np.float32)
    errs = (rng.random(n) * 1e-3).astype(np.float32) if with_errs else None
    ours = _rgba(tplot.make_matching_figure(im0, im1, k0, k1, errs))
    ref = _rgba(jplot.make_matching_figure(im0, im1, k0, k1, errs))
    assert ours.shape == ref.shape and ours.shape[-1] == 4
    np.testing.assert_array_equal(ours, ref)
    assert tplot.dynamic_alpha(n) == jplot.dynamic_alpha(n)
    np.testing.assert_array_equal(tplot.error_colormap(k0[:, 0], 10.0, 0.5),
                                  jplot.error_colormap(k0[:, 0], 10.0, 0.5))


def _video_inputs(mod, tensors):
    scene = make_scene(seed=31, k=4)
    loc = {}
    mod.ransac(build_pairs(scene, "relapose", mod), 5.0, pair_type="relapose",
               loc_results=loc)
    rng = np.random.default_rng(0)
    images = [(rng.random((1, 64, 48, 3), np.float32), rng.random((1, 64, 48, 1), np.float32)),
              (rng.random((1, 64, 48, 3), np.float32), rng.random((1, 64, 48, 3), np.float32))]
    wrap = torch.from_numpy if tensors else (lambda a: a)
    batches = [{"scene_id": "sceneA", "pair_names": ("ref.jpg", q),
                "image0": wrap(a), "image1": wrap(b)}
               for q, (a, b) in zip(("q0", "missing"), images)]
    return {"sceneA": loc}, batches


def _frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    ok, f = cap.read()
    while ok:
        frames.append(f)
        ok, f = cap.read()
    cap.release()
    return frames


class _NoCodec:
    def __init__(self, *a, **k):
        pass

    def isOpened(self):
        return False

    def release(self):
        pass


@pytest.mark.parametrize("codec", [True, False])
def test_save_video_matches_jax(codec, tmp_path, monkeypatch):
    """One scene, a localised query and one with no result (inf errors, red
    banner): the artifact paths relative to each output dir and the
    frames equal (the port given tensors, JAX numpy arrays)."""
    import cv2

    if not codec:
        monkeypatch.setattr(cv2, "VideoWriter", _NoCodec)
    arts = []
    for mod, vis, tensors in ((tl, tvis, True), (jl, jvis, False)):
        res, batches = _video_inputs(mod, tensors)
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        np.save(d / "loc.npy", res)
        arts.append((d, vis.save_video(str(d / "loc.npy"), batches, str(d / "vids"))))
    (d0, a0), (d1, a1) = arts
    assert list(a0) == list(a1) == ["sceneA"]
    p0, p1 = a0["sceneA"], a1["sceneA"]
    assert p0[len(str(d0)):] == p1[len(str(d1)):] == \
        ("/vids/sceneA.mp4" if codec else "/vids/sceneA")
    if codec:
        f0, f1 = _frames(p0), _frames(p1)
        assert len(f0) == len(f1) == 2
        for x, y in zip(f0, f1):
            np.testing.assert_array_equal(x, y)
    else:
        names = sorted(p.name for p in (d1 / "vids" / "sceneA").iterdir())
        assert names == ["00000.png", "00001.png"]
        for n in names:
            assert (d0 / "vids" / "sceneA" / n).read_bytes() == \
                (d1 / "vids" / "sceneA" / n).read_bytes(), n


N = 8


def test_validate_far_figure_names_match_jax(tmp_path):
    """One batch of 8 guard pairs with ``fig_dir``, ``step=12`` and
    ``n_figs=3``: the same PNG names as JAX's validate_far, each a
    750x450 image (10x6 in at dpi 75); the port leaves no figure open."""
    import matplotlib.image as mpimg

    variables, _ = load_flax_npz(GUARD_NPZ)
    cfg = _jax_tiny_config()
    jds = JSyntheticPairDataset(n=N, hw=cfg.image_size, seed=4242, n_scenes=N,
                                max_angle_deg=12.0)
    jvalidation.validate_far(jbuild_inference_fn(JFARLoFTR(cfg)),
                             jax.tree.map(jnp.asarray, variables), jds, N,
                             jax.random.PRNGKey(7), cfg.match.max_matches,
                             fig_dir=str(tmp_path / "jax"), n_figs=3, step=12)
    jplot.plt.close("all")   # JAX's pass closes only the figures it saved
    model, _ = load_guard(device="cpu")
    ds = SyntheticPairDataset(n=N, hw=model.config.image_size, seed=4242, n_scenes=N,
                              max_angle_deg=12.0)
    table = tvalidation.validate_far(model, ds, N, generator=torch.Generator().manual_seed(0),
                                     fig_dir=str(tmp_path / "port"), n_figs=3, step=12)
    assert np.isfinite(table["rot median err"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"val_step0000012_pair{i}.png" for i in range(3)]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert mpimg.imread(tmp_path / "port" / names[0]).shape[:2] == (450, 750)
    assert not jplot.plt.get_fignums()


def test_figures_without_matplotlib(monkeypatch, tmp_path):
    """matplotlib made unimportable: the plotting module imports, a figure
    and ``validate_far(fig_dir=...)`` raise ImportError naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "far_tpu_torch.utils.plotting")
    plotting = importlib.import_module("far_tpu_torch.utils.plotting")
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.make_matching_figure(np.zeros((8, 8)), np.zeros((8, 8)), np.zeros((0, 2)),
                                      np.zeros((0, 2)))
    model, _ = load_guard(device="cpu")
    ds = SyntheticPairDataset(n=N, hw=model.config.image_size, seed=4242, n_scenes=N,
                              max_angle_deg=12.0)
    with pytest.raises(ImportError, match="matplotlib"):
        tvalidation.validate_far(model, ds, N, generator=torch.Generator().manual_seed(0),
                                 fig_dir=str(tmp_path))
