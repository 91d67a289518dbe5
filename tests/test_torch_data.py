"""far_tpu_torch's data layer against far_tpu's, on fixture files.

The readers (PIL decode, the native resize up and down), the native
library itself and its refused build, ``corrupt_correspondences``, every
dataset adapter on small files written to ``tmp_path`` in the on-disk
layouts of ``tests/test_data.py`` (Matterport json with pkl depth and an
unreadable pair, InteriorNet/StreetLearn npy metadata, map-free scenes
with ``overlaps.npz`` and estimated depth, cached correspondences with
the corruption ablations), the map-free submission writer and scorer,
and ``MetricLogger``'s JSONL: each against its JAX counterpart on the
same inputs, bit-equal (the same numpy code and the same C++ source),
unless a test says otherwise.
"""

import json
import pickle
import sys
import time
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from far_tpu.data import corruption as jcorruption
from far_tpu.data import datasets as jdatasets
from far_tpu.data import io as jio
from far_tpu.data import native as jnative
from far_tpu.eval import mapfree_benchmark as jbench
from far_tpu.eval import submission as jsubmission
from far_tpu.models import feature_matching as jfm
from far_tpu.utils import logging as jlogging
from far_tpu_torch.data import corruption as tcorruption
from far_tpu_torch.data import datasets as tdatasets
from far_tpu_torch.data import io as tio
from far_tpu_torch.data import native as tnative
from far_tpu_torch.data.synthetic import SyntheticPairDataset
from far_tpu_torch.eval import mapfree_benchmark as tbench
from far_tpu_torch.eval import submission as tsubmission
from far_tpu_torch.models import feature_matching as tfm
from far_tpu_torch.utils import logging as tlogging

torch.set_num_threads(2)


def assert_sample_equal(a, b, what=""):
    """Same keys; arrays bit-equal with the same dtype, the rest equal."""
    assert a.keys() == b.keys(), (what, sorted(a), sorted(b))
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == np.asarray(b[k]).dtype, (what, k)
            np.testing.assert_array_equal(v, b[k], err_msg=f"{what} {k}")
        else:
            assert v == b[k], (what, k, v, b[k])


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's readers resize natively only where its library
    loads (else they fall back to PIL); the comparison needs that path.
    Another test process may be writing that library as this one loads
    it, so the load is tried again for up to 30 s."""
    deadline = time.monotonic() + 30.0
    while not jnative.available():
        assert time.monotonic() < deadline, "far_tpu.data.native did not build"
        time.sleep(1.0)
    return jnative


# ---- readers and the native resize -------------------------------------------


def _write_images(root, rng):
    """8-bit L, RGB and RGBA PNGs, a 16-bit depth PNG and a JPEG."""
    H, W = 37, 53
    files = {}
    for mode, shape in (("L", (H, W)), ("RGB", (H, W, 3)), ("RGBA", (H, W, 4))):
        files[mode] = root / f"img_{mode}.png"
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(files[mode])
    files["jpeg"] = root / "img.jpg"
    Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(files["jpeg"], quality=90)
    files["depth"] = root / "depth.png"
    Image.fromarray(rng.integers(0, 65535, (H, W)).astype(np.uint16)).save(files["depth"])
    return files


def test_readers_match_jax(tmp_path, jax_native):
    """read_gray and read_color of every fixture, as decoded and resized
    down (32x24) and up (80x64) by the native library, and read_depth_png:
    bit-equal to far_tpu.data.io's."""
    files = _write_images(tmp_path, np.random.default_rng(0))
    for name in ("L", "RGB", "RGBA", "jpeg"):
        for resize in (None, (32, 24), (80, 64)):
            for fn in ("read_gray", "read_color"):
                ours = getattr(tio, fn)(files[name], resize)
                ref = getattr(jio, fn)(files[name], resize)
                assert ours.dtype == ref.dtype == np.float32
                np.testing.assert_array_equal(ours, ref, err_msg=f"{fn} {name} {resize}")
    depth = tio.read_depth_png(files["depth"])
    np.testing.assert_array_equal(depth, jio.read_depth_png(files["depth"]))
    assert depth.dtype == np.float32 and depth.max() > 1.0


@pytest.mark.parametrize("shape", [(40, 60), (40, 60, 1), (40, 60, 3), (3, 40, 60, 3)])
def test_native_resize_matches_jax(shape, jax_native):
    """The port's library (its own build, under far_tpu_torch/build) and
    the JAX package's give the same bytes, down, up and at the same size."""
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, np.uint8)
    for out_hw in ((20, 30), (57, 91), (40, 60), (13, 60)):
        ours = tnative.resize_bilinear_u8(img, *out_hw)
        np.testing.assert_array_equal(ours, jax_native.resize_bilinear_u8(img, *out_hw))
        expected = {2: out_hw, 3: out_hw + shape[2:], 4: shape[:1] + out_hw + shape[3:]}
        assert ours.shape == expected[len(shape)]
    assert tnative.lib_path().exists() and tnative.lib_path().parent.name == "build"
    with pytest.raises(TypeError, match="uint8"):
        tnative.resize_bilinear_u8(img.astype(np.float32), 8, 8)


def test_refused_native_build_raises(tmp_path, monkeypatch):
    """A compiler that refuses the source raises, naming the command and
    its stderr; the reader does not fall back to another resize."""
    png = tmp_path / "a.png"
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(png)
    monkeypatch.setattr(tnative, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", ("g++", "--no-such-flag", "-shared", "-fPIC"))
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match=r"(?s)native preprocess build failed: "
                                           r"g\+\+ --no-such-flag.*no-such-flag"):
        tio.read_gray(png, (4, 4))
    assert not list((tmp_path / "build").glob("*.so"))
    np.testing.assert_array_equal(tio.read_gray(png)[..., 0], 0.0)  # no resize: no build


def test_unloadable_native_library_raises_through_dataset(tmp_path, monkeypatch):
    """A built library that does not load raises a RuntimeError naming it,
    which Mp3dDataset's skip-unreadable retry (it skips OSError) lets
    through, rather than skipping every sample."""
    (tmp_path / "x" / "y").mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "x" / "y" / "a.png")
    jpath = tmp_path / "pairs.json"
    jpath.write_text(json.dumps({"data": [{
        "0": {"file_name": "x/y/a.png"}, "1": {"file_name": "x/y/a.png"},
        "rel_pose": {"position": [0.0, 0.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0]}}]}))
    monkeypatch.setattr(tnative, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    tnative.BUILD.mkdir()
    tnative.lib_path().write_bytes(b"not a shared object")
    dataset = tdatasets.Mp3dDataset(jpath, tmp_path, resize_wh=(4, 4))
    with pytest.raises(RuntimeError, match=r"libfar_preprocess_\w+\.so failed to load"):
        dataset[0]


# ---- corruption ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corrupt_correspondences_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    corr = rng.uniform(0, 64, (96, 2, 2))
    valid = rng.uniform(size=96) < 0.7
    kw = dict(outlier_pct=0.2, noise_pix=1.5, missing_pct=0.1, corr_dropout=0.15,
              image_hw=(48, 64))
    ours = tcorruption.corrupt_correspondences(corr, valid, np.random.default_rng(seed), **kw)
    ref = jcorruption.corrupt_correspondences(corr, valid, np.random.default_rng(seed), **kw)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours[1].sum() < valid.sum()


# ---- dataset adapters -----------------------------------------------------------


def test_mp3d_dataset_matches_jax(tmp_path, jax_native):
    """A json of 4 pairs over PNGs of another size (resized to 64x48),
    pkl depth, and a pair whose image is missing (skipped for the next)."""
    rng = np.random.default_rng(1)
    scene = tmp_path / "imgs" / "sceneA"
    (tmp_path / "depth" / "sceneA").mkdir(parents=True)
    scene.mkdir(parents=True)
    data = []
    for i in range(4):
        for side in "ab":
            Image.fromarray(rng.integers(0, 256, (60, 80), np.uint8)).save(scene / f"{i}{side}.png")
            with open(tmp_path / "depth" / "sceneA" / f"{i}{side}.pkl", "wb") as f:
                pickle.dump({"depth_sensor": rng.uniform(0.5, 5, (48, 64))}, f)
        q = rng.normal(size=4)
        data.append({"0": {"file_name": f"x/imgs/sceneA/{i}a.png"},
                     "1": {"file_name": f"x/imgs/sceneA/{'missing' if i == 2 else i}b.png"},
                     "rel_pose": {"position": list(rng.normal(size=3)),
                                  "rotation": list(q / np.linalg.norm(q))}})
    jpath = tmp_path / "pairs.json"
    jpath.write_text(json.dumps({"data": data}))
    for mode in ("train", "test"):
        args = (jpath, tmp_path, tmp_path / "depth")
        ours = tdatasets.Mp3dDataset(*args, mode=mode, resize_wh=(64, 48))
        ref = jdatasets.Mp3dDataset(*args, mode=mode, resize_wh=(64, 48))
        assert len(ours) == len(ref) == 4
        for i in range(4):
            assert_sample_equal(ours[i], ref[i], f"{mode} {i}")
        assert ours[2]["pair_id"] == 3 and ("depth0" in ours[0]) == (mode == "train")


def test_interiornet_dataset_matches_jax(tmp_path, jax_native):
    rng = np.random.default_rng(3)
    (tmp_path / "scene").mkdir()
    records = {}
    for i in range(3):
        for im in "ab":
            Image.fromarray(rng.integers(0, 256, (32, 40, 3), np.uint8)).save(
                tmp_path / "scene" / f"{i}{im}.png")
        x1, y1, x2, y2 = rng.uniform(-1, 1, 4)
        records[i] = {"img1": {"path": f"scene/{i}a.png", "x": x1, "y": y1},
                      "img2": {"path": f"scene/{i}b.png", "x": x2, "y": y2}}
    meta = tmp_path / "meta.npy"
    np.save(meta, records, allow_pickle=True)
    ours = tdatasets.InteriornetStreetlearnDataset(meta, tmp_path, resize_wh=(64, 48))
    ref = jdatasets.InteriornetStreetlearnDataset(meta, tmp_path, resize_wh=(64, 48))
    assert len(ours) == len(ref) == 3
    for i in range(3):
        assert_sample_equal(ours[i], ref[i], str(i))
    vp = records[1]
    np.testing.assert_array_equal(
        tio.relative_rotation_from_viewpoints((vp["img1"]["x"], vp["img1"]["y"]),
                                              (vp["img2"]["x"], vp["img2"]["y"])),
        jio.relative_rotation_from_viewpoints((vp["img1"]["x"], vp["img1"]["y"]),
                                              (vp["img2"]["x"], vp["img2"]["y"])))


def write_mapfree_scene(scene, n_query, wh=(64, 48), with_depth=False, seed=0):
    """A map-free scene directory: seq0/frame_00000.jpg (the map frame,
    identity pose) and ``n_query`` frames seq1/frame_*.jpg as JPEG, their
    intrinsics.txt and poses.txt, optionally '.dptkitti.png' depth in mm."""
    rng = np.random.default_rng(seed)
    W, H = wh
    frames = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(n_query)]
    (scene / "seq0").mkdir(parents=True)
    (scene / "seq1").mkdir(parents=True)
    intr, poses = ["# frame fx fy cx cy W H"], ["# frame qw qx qy qz tx ty tz"]
    for f in frames:
        Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(scene / f)
        fx, fy = rng.uniform(50, 70, 2)
        intr.append(f"{f} {fx} {fy} {W / 2} {H / 2} {W} {H}")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        if f.startswith("seq0"):
            q, t = np.array([1.0, 0, 0, 0]), np.zeros(3)
        poses.append(f"{f} " + " ".join(map(str, [*q, *t])))
        if with_depth:
            d = rng.uniform(500, 3000, (H, W)).astype(np.uint16)
            Image.fromarray(d).save(scene / f.replace(".jpg", ".dptkitti.png"))
    (scene / "intrinsics.txt").write_text("\n".join(intr))
    (scene / "poses.txt").write_text("\n".join(poses))


def test_mapfree_dataset_matches_jax(tmp_path, jax_native):
    """Val scenes (the map frame against every 5th query, estimated depth)
    through MapFreeDataset with its scene_lengths, and a training scene's
    overlap-filtered pairs from overlaps.npz with sample_factor 2."""
    root = tmp_path / "mapfree"
    write_mapfree_scene(root / "val" / "s00000", 11, with_depth=True, seed=0)
    write_mapfree_scene(root / "val" / "s00001", 6, with_depth=True, seed=1)
    kw = dict(split="val", resize_wh=(40, 30), reg_resize_wh=(24, 18),
              estimated_depth="dptkitti")
    ours, ref = tdatasets.MapFreeDataset(root, **kw), jdatasets.MapFreeDataset(root, **kw)
    assert ours.scene_lengths == ref.scene_lengths == [3, 2]
    assert len(ours) == len(ref) == 5
    for i in range(5):
        assert_sample_equal(ours[i], ref[i], str(i))

    scene = tmp_path / "train" / "s00002"
    write_mapfree_scene(scene, 4, seed=2)
    idxs = np.array([[0, 0, 1, 0], [0, 0, 1, 1], [1, 0, 1, 2], [0, 0, 1, 3],
                     [1, 1, 1, 3]], np.uint16)
    np.savez(scene / "overlaps.npz", idxs=idxs, overlaps=np.array([0.2, 0.5, 0.6, 0.8, 0.7]))
    kw = dict(resize_wh=(32, 24), reg_resize_wh=(16, 12), overlap_limits=(0.2, 0.8),
              sample_factor=2)
    ours, ref = tdatasets.MapFreeScene(scene, **kw), jdatasets.MapFreeScene(scene, **kw)
    assert ours.pairs == ref.pairs and len(ours.pairs) == 3
    for i in range(3):
        assert_sample_equal(ours[i], ref[i], f"train {i}")


def test_cached_correspondences_match_jax(tmp_path):
    """precompute_matches' store equal to JAX's for the same matcher, then
    CachedCorrespondenceDataset over it with every ablation on, with and
    without the images, and a pair missing from the store."""
    base = SyntheticPairDataset(n=5, hw=(48, 64))
    jbase = jdatasets.SyntheticPairDataset(n=5, hw=(48, 64))

    def oracle(sample):
        ys, xs = np.nonzero(sample["depth0"] > 0)
        pts0 = np.stack([xs, ys], -1)[:80].astype(np.float32)
        return pts0, pts0 + np.float32(1.5)

    ours_store = tfm.precompute_matches(base, range(4), oracle, tmp_path / "t.npz")
    ref_store = jfm.precompute_matches(jbase, range(4), oracle, tmp_path / "j.npz")
    assert ours_store.keys() == ref_store.keys() and len(ours_store) == 4
    for k in ref_store:
        np.testing.assert_array_equal(ours_store[k], ref_store[k])
        np.testing.assert_array_equal(np.load(tmp_path / "t.npz")[k], ours_store[k])
    ablate = dict(max_matches=96, outlier_pct=0.2, noise_pix=1.0, missing_pct=0.1,
                  corr_dropout=0.1, image_hw=(48, 64), seed=3)
    for keep in (False, True):
        ours = tdatasets.CachedCorrespondenceDataset(base, tmp_path / "t.npz", keep_images=keep,
                                                     **ablate)
        ref = jdatasets.CachedCorrespondenceDataset(jbase, tmp_path / "j.npz", keep_images=keep,
                                                    **ablate)
        for i in range(5):   # pair 4 is not in the store: no valid match
            assert_sample_equal(ours[i], ref[i], f"{keep} {i}")
        assert ours[4]["num_correspondences"] == 0 and ("image0" in ours[0]) == keep


# ---- the map-free submission and scorer -------------------------------------------


def _random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return np.stack([tbench.quat_to_matrix(x) for x in q])


def test_submission_zip_matches_jax(tmp_path):
    """add_pose_matrix (the port's float32 matrix_to_quaternion against
    JAX's) and add of a non-finite pose (dropped): the zips hold the same
    members with the same text."""
    rng = np.random.default_rng(5)
    Rs, ts = _random_rotations(rng, 12), rng.normal(size=(12, 3))
    ours, ref = tsubmission.SubmissionWriter(), jsubmission.SubmissionWriter()
    for w in (ours, ref):
        for i in range(12):
            w.add_pose_matrix(f"s{i % 3:05d}", f"seq1/frame_{i:05d}.jpg", Rs[i], ts[i],
                              confidence=float(i * 7))
        w.add("s00000", "seq1/frame_00099.jpg", np.array([np.nan, 0, 0, 1.0]), np.zeros(3))
        w.write(tmp_path / f"{'t' if w is ours else 'j'}" / "sub.zip")
    with zipfile.ZipFile(tmp_path / "t" / "sub.zip") as a, \
            zipfile.ZipFile(tmp_path / "j" / "sub.zip") as b:
        assert a.namelist() == b.namelist() == [f"pose_s{i:05d}.txt" for i in range(3)]
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
        assert len(a.read("pose_s00000.txt").decode().splitlines()) == 4


def test_evaluate_submission_matches_jax(tmp_path):
    """A scored submission (a frame missing, a NaN pose dropped) and the
    scorer's pieces, equal to JAX's."""
    root = tmp_path / "mapfree"
    for s in range(2):
        write_mapfree_scene(root / "val" / f"s{s:05d}", 10, wh=(32, 24), seed=s)
    rng = np.random.default_rng(9)
    writer = tsubmission.SubmissionWriter()
    for s in range(2):
        poses = tio.load_mapfree_poses(root / "val" / f"s{s:05d}" / "poses.txt")
        for j, (frame, (q, t)) in enumerate(poses.items()):
            if j == 6:   # seq1/frame_00005, one the scorer reads
                continue
            noisy_q = q + rng.normal(0, 0.02, 4)
            writer.add(f"s{s:05d}", frame, noisy_q, t + rng.normal(0, 0.2, 3),
                       confidence=float(rng.integers(0, 300)))
    writer.write(tmp_path / "sub.zip")
    ours = tbench.evaluate_submission(root / "val", tmp_path / "sub.zip")
    ref = jbench.evaluate_submission(root / "val", tmp_path / "sub.zip")
    assert ours == ref and ours["Estimates for % of frames"] < 1.0
    for sub in (1, 5):
        assert tbench.evaluate_submission(root / "val", tmp_path / "sub.zip", subsample=sub) == \
            jbench.evaluate_submission(root / "val", tmp_path / "sub.zip", subsample=sub)
    q1, q2 = rng.normal(size=4), rng.normal(size=4)
    for variant in ("sin", "cos"):
        assert tbench.quat_angle_error(q1, q2, variant) == jbench.quat_angle_error(q1, q2, variant)
    conf, tp = rng.uniform(size=20).round(1), rng.uniform(size=20) < 0.5
    for a, b in zip(tbench.precision_recall(conf, tp, 3), jbench.precision_recall(conf, tp, 3)):
        np.testing.assert_array_equal(a, b)
    tbench.main([str(tmp_path / "sub.zip"), "--dataset_path", str(root)])


# ---- logging -------------------------------------------------------------------


def test_metric_logger_lines_match_jax(tmp_path, monkeypatch, capsys):
    """The JSONL records (all but their wall-clock time) and the printed
    running means equal JAX's; off rank 0 nothing is written."""
    # JAX's logger would also open TensorBoard where that imports; keep it
    # to the JSONL the port writes
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rows = [(1, {"loss": np.float32(2.5), "n": 3}), (2, {"loss": torch.tensor(1.25)}),
            (4, {"loss": 0.5, "grad_norm": np.asarray(7.0)})]
    printed = {}
    for name, mod in (("t", tlogging), ("j", jlogging)):
        log = mod.MetricLogger(tmp_path / name, "train", print_every=2)
        for step, scalars in rows:
            log.log(step, scalars, prefix="x/" if step == 4 else "")
        log.close()
        printed[name] = capsys.readouterr().out
        mod.MetricLogger(tmp_path / f"{name}_r1", rank=1).log(1, {"loss": 1.0})
        assert not (tmp_path / f"{name}_r1").exists()
    lines = {n: [json.loads(s) for s in (tmp_path / n / "train_metrics.jsonl").read_text()
                 .splitlines()] for n in "tj"}
    for a, b in zip(lines["t"], lines["j"], strict=True):
        assert a.pop("time") > 0 and b.pop("time") > 0
        assert a == b
    assert printed["t"] == printed["j"] and "[step 4]" in printed["t"]
