"""Data layer of the port: dataset adapters, readers, samplers, loaders.

Host-side numpy samples, collated into ``PairBatch``es of tensors; the
names of ``far_tpu/data/__init__.py``.
"""

from far_tpu_torch.data.io import (
    read_gray,
    read_color,
    get_mp3d_intrinsics,
    get_mp3d_T_0to1,
    get_interiornet_streetlearn_intrinsics,
    rotation_from_viewpoint,
)
from far_tpu_torch.data.datasets import (
    Mp3dDataset,
    InteriornetStreetlearnDataset,
    MapFreeScene,
    MapFreeDataset,
    CachedCorrespondenceDataset,
)
from far_tpu_torch.data.synthetic import (
    SyntheticPairDataset,
    GTCorrespondenceDataset,
    SolverPoseDataset,
)
from far_tpu_torch.data.sampler import scene_balance_indices, random_indices
from far_tpu_torch.data.corruption import corrupt_correspondences
from far_tpu_torch.data.loader import Loader, collate_pairs
