"""Dataset adapters of the three benchmark families.

The port's copy of ``far_tpu/data/datasets.py``, after crockwell/far:

- mp3d_loftr/src/datasets/mp3d.py (``Mp3dDataset``: json pair list,
  grayscale 640x480, pkl depth, axis-flipped quaternion poses, a sample
  that cannot be read skipped for the next);
- mp3d_loftr/src/datasets/interiornet_streetlearn.py
  (``InteriornetStreetlearnDataset``: npy metadata, rotations from the
  viewpoints);
- mapfree_6dreg/lib/datasets/mapfree.py (``MapFreeScene`` and
  ``MapFreeDataset``: per-scene intrinsics and poses, overlap-filtered
  pairs, the matcher's and the regressor's resolutions, optional
  estimated depth);

and ``CachedCorrespondenceDataset``, cached matcher correspondences with
the corruption ablations. The synthetic pairs and the ground-truth and
solver-pose wrappers are in ``data/synthetic.py``. ``__getitem__``
returns plain numpy dicts; ``data/loader.py`` collates them into tensors.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from far_tpu_torch.data import io as dio
from far_tpu_torch.data.corruption import corrupt_correspondences
from far_tpu_torch.models.feature_matching import PrecomputedMatching


class Mp3dDataset:
    """Matterport3D pair dataset (json index)."""

    def __init__(
        self,
        json_path,
        data_dir,
        depth_dir=None,
        mode: str = "train",
        resize_wh: Tuple[int, int] = (640, 480),
        subsample_test: bool = True,
    ):
        with open(json_path, "r") as f:
            self.data = json.load(f)["data"]
        if mode == "test" and "train" in str(json_path) and subsample_test:
            self.data = self.data[::10]
        self.mode = mode
        self.data_dir = Path(data_dir)
        self.depth_dir = Path(depth_dir) if depth_dir else None
        self.resize_wh = resize_wh
        self.K = dio.get_mp3d_intrinsics().astype(np.float32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        # skip-unreadable-sample semantics (reference mp3d.py:88-106)
        for attempt in range(len(self.data)):
            sample = self.data[(idx + attempt) % len(self.data)]
            try:
                return self._load(sample, (idx + attempt) % len(self.data))
            except (OSError, KeyError, ValueError):
                continue
        raise RuntimeError("no readable sample in dataset")

    def _load(self, sample, idx) -> Dict:
        name0 = "/".join(sample["0"]["file_name"].split("/")[-3:])
        name1 = "/".join(sample["1"]["file_name"].split("/")[-3:])
        scene = Path(name0).parent.name
        img0 = dio.read_gray(self.data_dir / name0, self.resize_wh)
        img1 = dio.read_gray(self.data_dir / name1, self.resize_wh)
        T_0to1 = dio.get_mp3d_T_0to1(sample["rel_pose"]).astype(np.float32)
        out = {
            "image0": img0,
            "image1": img1,
            "K0": self.K,
            "K1": self.K,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "scene": scene,
            "pair_id": np.asarray(idx, np.int64),
            "pair_names": (name0, name1),
            "dataset_name": "mp3d",
        }
        if self.depth_dir is not None and self.mode in ("train", "val"):
            out["depth0"] = dio.read_mp3d_depth(self.depth_dir, scene, name0)
            out["depth1"] = dio.read_mp3d_depth(self.depth_dir, scene, name1)
        return out


class InteriornetStreetlearnDataset:
    """InteriorNet / StreetLearn extreme-rotation pairs.

    Metadata: an .npy of records with per-pair image paths and (x, y)
    viewpoints; GT is rotation-only (reference
    interiornet_streetlearn.py + data_readers/interiornet.py:22-45).
    """

    def __init__(self, metadata_npy, data_dir,
                 resize_wh: Tuple[int, int] = (640, 480)):
        raw = np.load(metadata_npy, allow_pickle=True)
        self.records = np.array(raw, ndmin=1)[0]
        self.keys = sorted(self.records.keys())
        self.data_dir = Path(data_dir)
        self.resize_wh = resize_wh
        self.K = dio.get_interiornet_streetlearn_intrinsics().astype(np.float32)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[self.keys[idx]]
        img0 = dio.read_color(self.data_dir / rec["img1"]["path"],
                              self.resize_wh)
        img1 = dio.read_color(self.data_dir / rec["img2"]["path"],
                              self.resize_wh)
        vp0 = (rec["img1"]["x"], rec["img1"]["y"])
        vp1 = (rec["img2"]["x"], rec["img2"]["y"])
        R = dio.relative_rotation_from_viewpoints(vp0, vp1).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        return {
            "image0": img0.mean(-1, keepdims=True),
            "image1": img1.mean(-1, keepdims=True),
            "image0_rgb": img0,
            "image1_rgb": img1,
            "K0": self.K,
            "K1": self.K,
            "T_0to1": T,
            "T_1to0": np.linalg.inv(T).astype(np.float32),
            "pair_id": np.asarray(idx, np.int64),
            "pair_names": (str(self.keys[idx]), str(self.keys[idx])),
            "dataset_name": "interiornet_streetlearn",
        }


class MapFreeScene:
    """One map-free scene (reference mapfree_6dreg/lib/datasets/
    mapfree.py:12-191 MapFreeScene).

    On-disk layout per scene dir: ``intrinsics.txt`` ('frame fx fy cx cy
    W H'), ``poses.txt`` ('frame qw qx qy qz tx ty tz', world-to-cam),
    frames at ``seq{i}/frame_{n:05d}.jpg``, optionally ``overlaps.npz``
    (arrays idxs (N, 4) = [seqA, imA, seqB, imB] and overlaps (N,)) and
    estimated-depth PNGs ``frame_{n:05d}.{suffix}.png`` in millimeters.
    """

    def __init__(self, scene_dir, resize_wh=(540, 720),
                 reg_resize_wh=(270, 360),
                 overlap_limits: Optional[Tuple[float, float]] = None,
                 estimated_depth: Optional[str] = None,
                 sample_factor: int = 1):
        self.scene_dir = Path(scene_dir)
        self.scene = self.scene_dir.name
        self.resize_wh = resize_wh
        self.reg_resize_wh = reg_resize_wh
        self.estimated_depth = estimated_depth
        self.sample_factor = sample_factor
        # intrinsics at both pipeline resolutions, rescaled from the
        # file's native (W, H) with the half-pixel correction
        # (reference read_intrinsics + correct_intrinsic_scale)
        self.K = dio.load_mapfree_intrinsics(
            self.scene_dir / "intrinsics.txt", resize_wh)
        self.K_reg = dio.load_mapfree_intrinsics(
            self.scene_dir / "intrinsics.txt", reg_resize_wh)
        self.poses = dio.load_mapfree_poses(self.scene_dir / "poses.txt")
        self.pairs = self._build_pairs(overlap_limits, sample_factor)

    def _build_pairs(self, overlap_limits,
                     sample_factor: int) -> List[Tuple[str, str]]:
        """Training scenes: overlap-filtered (seqA, imA, seqB, imB) rows
        from overlaps.npz (STRICT limits, reference mapfree.py:86-93).
        Test/val scenes (no overlaps file): the seq0/frame_00000 keyframe
        against every sample_factor-th query frame, in poses.txt order
        (reference mapfree.py:94-100)."""
        p = self.scene_dir / "overlaps.npz"
        if p.exists():
            z = np.load(p, allow_pickle=True)
            idxs, overlaps = z["idxs"], z["overlaps"]
            if overlap_limits is not None:
                lo, hi = overlap_limits
                idxs = idxs[(overlaps > lo) & (overlaps < hi)]
            return [(f"seq{a}/frame_{i:05d}.jpg",
                     f"seq{b}/frame_{j:05d}.jpg") for a, i, b, j in idxs]
        qry = [f for f in self.poses if "seq0" not in f]
        return [("seq0/frame_00000.jpg", q) for q in qry][::sample_factor]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict:
        f0, f1 = self.pairs[idx]
        img0 = dio.read_color(self.scene_dir / f0, self.resize_wh)
        img1 = dio.read_color(self.scene_dir / f1, self.resize_wh)
        img0_reg = dio.read_color(self.scene_dir / f0, self.reg_resize_wh)
        img1_reg = dio.read_color(self.scene_dir / f1, self.reg_resize_wh)
        q0, t0 = self.poses[f0]
        q1, t1 = self.poses[f1]
        T_0to1 = dio.mapfree_relative_pose(q0, t0, q1, t1).astype(np.float32)
        # camera centers in world coords c = -R(q)^T t (reference
        # mapfree.py:158-159 abs_c_* via rotate_vector(-t, qinverse(q)))
        R0 = dio._quat_to_matrix_np(q0)
        R1 = dio._quat_to_matrix_np(q1)
        out = {
            "image0": img0.mean(-1, keepdims=True),
            "image1": img1.mean(-1, keepdims=True),
            "image0_reg": img0_reg,
            "image1_reg": img1_reg,
            "K0": self.K[f0].astype(np.float32),
            "K1": self.K[f1].astype(np.float32),
            "K_color0": self.K_reg[f0].astype(np.float32),
            "K_color1": self.K_reg[f1].astype(np.float32),
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "abs_q_0": np.asarray(q0, np.float32),
            "abs_c_0": (-R0.T @ np.asarray(t0)).astype(np.float32),
            "abs_q_1": np.asarray(q1, np.float32),
            "abs_c_1": (-R1.T @ np.asarray(t1)).astype(np.float32),
            "scene": self.scene,
            "pair_id": np.asarray(idx * self.sample_factor, np.int64),
            "pair_names": (f0, f1),
            "dataset_name": "mapfree",
        }
        if self.estimated_depth is not None:
            d0 = self.scene_dir / f0.replace(
                ".jpg", f".{self.estimated_depth}.png")
            d1 = self.scene_dir / f1.replace(
                ".jpg", f".{self.estimated_depth}.png")
            if d0.exists():
                out["depth0"] = dio.read_depth_png(d0)
            if d1.exists():
                out["depth1"] = dio.read_depth_png(d1)
        return out


class MapFreeDataset:
    """Concatenation of MapFreeScene datasets (reference mapfree.py:194+).

    ``sample_factor`` defaults to the reference's per-split factors
    (train 1, val/test 5, mapfree.py:205) unless given explicitly."""

    def __init__(self, root, split: str = "val",
                 scenes: Optional[Sequence[str]] = None, **scene_kwargs):
        root = Path(root) / split
        scene_kwargs.setdefault(
            "sample_factor", {"train": 1, "val": 5, "test": 5}.get(split, 1))
        dirs = ([root / s for s in scenes] if scenes is not None
                else sorted(d for d in root.iterdir() if d.is_dir()))
        self.scenes = [MapFreeScene(d, **scene_kwargs) for d in dirs]
        self._offsets = np.cumsum([0] + [len(s) for s in self.scenes])

    def __len__(self):
        return int(self._offsets[-1])

    @property
    def scene_lengths(self) -> List[int]:
        return [len(s) for s in self.scenes]

    def __getitem__(self, idx: int) -> Dict:
        s = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.scenes[s][idx - int(self._offsets[s])]


class CachedCorrespondenceDataset:
    """Correspondence-only training set with corruption ablations.

    Equivalent of crockwell/far: mp3d_loftr/src/datasets/mp3d.py
    Mp3dLightDataset (:269-298): wraps a base pair dataset, replaces the
    images with cached matcher correspondences (an .npz shard produced by
    far_tpu_torch.cli.precompute), and applies the outlier/noise/missing/
    dropout fault-injection ablations. Feeds the SimpleTransformer
    baseline and the solver-robustness studies.
    """

    def __init__(self, base_dataset, corr_npz, max_matches: int = 1024,
                 outlier_pct: float = 0.0, noise_pix: float = 0.0,
                 missing_pct: float = 0.0, corr_dropout: float = 0.0,
                 image_hw: Tuple[int, int] = (480, 640), seed: int = 0,
                 keep_images: bool = False):
        self.base = base_dataset
        self.matcher = PrecomputedMatching(corr_npz, max_matches)
        self.ablate = dict(outlier_pct=outlier_pct, noise_pix=noise_pix,
                           missing_pct=missing_pct,
                           corr_dropout=corr_dropout)
        self.image_hw = image_hw
        self.seed = seed
        self.keep_images = keep_images  # 6DReg training consumes images too

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict:
        s = dict(self.base[idx])
        n0, n1 = s["pair_names"]
        p0, p1, valid = self.matcher.match(n0, n1)
        corr = np.stack([p0, p1], axis=1)  # (K, 2, 2)
        rng = np.random.default_rng(self.seed * 100003 + idx)
        corr, valid = corrupt_correspondences(
            corr, valid, rng, image_hw=self.image_hw, **self.ablate)
        s["correspondences"] = corr.astype(np.float32)
        s["corr_valid"] = valid
        s["num_correspondences"] = np.asarray(valid.sum(), np.float32)
        if not self.keep_images:
            s.pop("image0", None)
            s.pop("image1", None)
        return s
