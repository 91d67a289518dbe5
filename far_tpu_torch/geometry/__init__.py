"""Batched torch geometry: rotations, epipolar algebra, solvers, transforms
and depth warping (the names ``far_tpu/geometry/__init__.py`` exports)."""

from far_tpu_torch.geometry.rotations import (
    rotation_6d_to_matrix,
    matrix_to_rotation_6d,
    ortho6d_to_matrix_rc,
    quaternion_to_matrix,
    matrix_to_quaternion,
    geodesic_distance,
    rotation_angle,
    so3_project,
)
from far_tpu_torch.geometry.epipolar import (
    cross_product_matrix,
    essential_from_Rt,
    essential_from_pose34,
    fundamental_from_essential,
    essential_from_fundamental,
    sampson_epipolar_distance,
    symmetrical_epipolar_distance,
    decompose_essential_matrix,
    motion_from_essential,
)
from far_tpu_torch.geometry.solvers import (
    normalize_points,
    run_8point,
    run_8point_essential,
    triangulate_points,
    cheirality_counts,
    recover_pose_from_essential,
    procrustes,
)
from far_tpu_torch.geometry.transforms import (
    transform_points,
    to_homogeneous,
    from_homogeneous,
    compose_pose34,
    invert_pose34,
    normalize_kpts_by_K,
)
from far_tpu_torch.geometry.warp import warp_kpts
