"""The fused 5-point kernel's wrapper (``far_tpu_torch/ops/fivepoint.py``)
on the CPU.

The kernel (``csrc/fivepoint.cu``) runs only on a card: its card tests,
against the plain version on the same card, are in
``tests/test_torch_hopper.py``. Here: CPU inputs go to the plain version
(``geometry/fivepoint.run_5point_essential``) unchanged and launch
nothing; the wrapper refuses mixed devices and shapes the kernel does not
take before any launch; the kernel is built with the others; its fixed
tables are the plain version's arrays in the layout the source reads; and
``prior_ransac`` on the CPU gives what it gave with the plain call, bit
for bit, in both rounds' configurations.
"""

import re

import numpy as np
import pytest
import torch

from far_tpu_torch.geometry import fivepoint as plain
from far_tpu_torch.ops import _build, launch_counts
from far_tpu_torch.ops.fivepoint import fivepoint_essential, kernel_tables
from far_tpu_torch.pipeline import make_solver_configs
from far_tpu_torch.solvers import ransac
from far_tpu_torch.solvers.types import PriorParams
from far_tpu_torch.utils.config import FARConfig

torch.set_num_threads(2)


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _scene(seed, B, N, outliers=0):
    """B pairs of N K-normalised correspondences of a rigid scene (the
    last ``outliers`` of each replaced by uniform points), float32."""
    rng = np.random.default_rng(seed)
    kp1, kp2 = [], []
    for _ in range(B):
        R, t = _rotation(rng), rng.normal(size=3)
        P = rng.uniform(-1, 1, (N, 3))
        P[:, 2] = rng.uniform(2, 6, N)
        P2 = P @ R.T + t / np.linalg.norm(t)
        x1, x2 = P[:, :2] / P[:, 2:], P2[:, :2] / P2[:, 2:]
        if outliers:
            x2[-outliers:] = rng.uniform(-0.5, 0.5, (outliers, 2))
        kp1.append(x1)
        kp2.append(x2)
    return (torch.tensor(np.stack(kp1), dtype=torch.float32),
            torch.tensor(np.stack(kp2), dtype=torch.float32))


@pytest.mark.parametrize("shape,rotations", [((3, 4), 2), ((6,), 1), ((2, 2, 3), 3)])
def test_cpu_inputs_give_the_plain_version(shape, rotations):
    """CPU inputs through the wrapper give run_5point_essential's E and
    valid exactly (the same call), and no launch counter moves."""
    kp1, kp2 = _scene(1, 1, 5 * int(np.prod(shape)))
    p1, p2 = kp1.reshape(*shape, 5, 2), kp2.reshape(*shape, 5, 2)
    before = launch_counts()
    E, valid = fivepoint_essential(p1, p2, n_basis_rotations=rotations, real_tol=4e-2,
                                   det_tol=3e-2)
    assert launch_counts() == before
    E0, valid0 = plain.run_5point_essential(p1, p2, real_tol=4e-2,
                                            n_basis_rotations=rotations, det_tol=3e-2)
    assert E.shape == (*shape, 10 * rotations, 3, 3) and valid.shape == (*shape, 10 * rotations)
    assert torch.equal(E, E0) and torch.equal(valid, valid0)


@pytest.mark.parametrize("p1_shape,p2_shape", [((4, 4, 2), (4, 4, 2)), ((4, 5, 3), (4, 5, 3)),
                                               ((4, 5, 2), (3, 5, 2)), ((3, 2, 5), (3, 2, 5))])
def test_refuses_shapes_before_any_launch(p1_shape, p2_shape):
    """Shapes other than two equal (..., 5, 2) raise, on any device, and
    nothing launches."""
    before = launch_counts()
    with pytest.raises(ValueError, match="fivepoint_essential takes"):
        fivepoint_essential(torch.zeros(p1_shape), torch.zeros(p2_shape))
    assert launch_counts() == before


def test_refuses_mixed_devices_before_any_launch():
    """One input on the CPU and one elsewhere raises (the meta device
    stands in for a card here)."""
    before = launch_counts()
    with pytest.raises(ValueError, match="on the CPU or on one CUDA device"):
        fivepoint_essential(torch.zeros(4, 5, 2), torch.zeros(4, 5, 2, device="meta"))
    assert launch_counts() == before


def test_kernel_is_built_with_the_others():
    """``fivepoint`` is one of _build.KERNELS (so build_all compiles it with
    nvcc as the others), its source exists and exports the entry points the
    wrapper binds, and its launch counter is one of launch_counts()."""
    assert "fivepoint" in _build.KERNELS
    src = (_build.CSRC / "fivepoint.cu").read_text()
    assert 'extern "C" int far_fivepoint(' in src
    assert any(fn is fivepoint_essential and name == "launches" for fn, name in launch_counts())


def test_kernel_tables_are_the_plain_arrays_in_the_sources_layout():
    """kernel_tables(R) holds the plain version's tables (as float32, as
    ``_table`` casts them), at the offsets ``csrc/fivepoint.cu`` reads them
    from (its T_* constants)."""
    src = (_build.CSRC / "fivepoint.cu").read_text()
    sizes = {"NM": 10, "NZ": 11, "NR": 10}
    offsets = {}
    for name, expr in re.findall(r"constexpr int (T_\w+) = ([^;]+);", src):
        offsets[name] = eval(expr, {}, {**sizes, **offsets})
    for R in (1, 2, 3):
        tab = kernel_tables(R)
        assert tab.dtype == np.float32 and tab.shape == (offsets["T_ROT"] + 16 * R,)
        want = {"T_XY": plain._XY_NODES, "T_VINV": plain._VINV_T, "T_Z": plain._Z_NODES,
                "T_WINV": plain._WINV_Z, "T_MIX": plain._det_mix(10),
                "T_DK": plain._dk_start(10).view(np.float32),
                "T_ROT": plain._basis_rotations(R)}
        for name, arr in want.items():
            flat = torch.as_tensor(np.asarray(arr), dtype=torch.float32).numpy().ravel()
            np.testing.assert_array_equal(tab[offsets[name]:offsets[name] + flat.size], flat,
                                          err_msg=name)


@pytest.mark.parametrize("round_", [0, 1])
def test_prior_ransac_on_cpu_unchanged(round_, monkeypatch):
    """prior_ransac on the CPU with the wrapper equals prior_ransac with the
    plain call it replaced, every output bit for bit, in FARConfig()'s
    first-round (no prior) and refinement-round (prior) configurations,
    from one seeded generator."""
    first, refine = make_solver_configs(FARConfig())
    cfg = (first, refine)[round_].ransac_config(use_prior=round_ == 1)
    assert cfg.minimal_solver == "5pt"
    kp1, kp2 = _scene(7, 2, 96, outliers=16)
    valid = torch.ones(2, 96, dtype=torch.bool)
    valid[1, -5:] = False
    prior = None
    if round_ == 1:
        rt = torch.eye(4)[:3].expand(2, 3, 4).clone()
        rt[:, :, 3] = torch.tensor([0.3, -0.1, 0.9])
        prior = PriorParams(rt=rt, pcl=torch.rand(64, 3, generator=torch.Generator()
                                                  .manual_seed(0)) * 6 - 3)

    def run():
        return ransac.prior_ransac(kp1, kp2, valid, prior, cfg,
                                   generator=torch.Generator().manual_seed(3))

    got = run()
    monkeypatch.setattr(ransac, "fivepoint_essential",
                        lambda p1, p2, n_basis_rotations, det_tol:
                        plain.run_5point_essential(p1, p2,
                                                   n_basis_rotations=n_basis_rotations,
                                                   det_tol=det_tol))
    ref = run()
    for name in ("E", "R", "t", "inliers", "num_inliers", "num_tight", "num_ultra_tight",
                 "success"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert bool(ref.success.all()) and float(ref.num_inliers.min()) >= 60
