"""far_tpu_torch against the golden FAR taps (tests/golden/farloftr_seed0.npz).

The fixture was recorded from the original torch FAR at 480x640 with
weights synthesized from its ``sd_spec``. The port loads the same
synthesized state dict (``matcher.`` prefix stripped) with
``strict=True`` and replays the fixture stage by stage as
``far_tpu.utils.parity._replay_farloftr`` does: the recorded coarse
``i_ids/j_ids`` feed the fine stage, the recorded solver summary feeds
the regressor. Each tap gates as tests/test_golden_parity.py gates it:
max(1e-3, the tap's own atol, 1e-3 * max|tap|), since taps are stored
as float16.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from far_tpu.utils.parity import FARLOFTR_TAPS, load_fixture, synth_state_dict
from far_tpu_torch.models.fine import fine_coords_to_kpts
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.matching import ids_to_coords
from far_tpu_torch.types import SolverSummary
from far_tpu_torch.utils.config import (
    AttentionStackConfig,
    FARConfig,
    RegressConfig,
)

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "golden" / "farloftr_seed0.npz"
ATOL = 1e-3
RTOL_MAX = 1e-3


def _replay(port: FARLoFTR, inputs) -> dict:
    cfg = port.config
    img = lambda k: torch.from_numpy(
        np.asarray(inputs[k], np.float32)).permute(0, 2, 3, 1).contiguous()
    image0, image1 = img("image0"), img("image1")
    B = image0.shape[0]
    i_ids = torch.from_numpy(inputs["i_ids"]).long().reshape(B, -1)
    j_ids = torch.from_numpy(inputs["j_ids"]).long().reshape(B, -1)
    scalar = lambda k: torch.from_numpy(
        np.asarray(inputs[k], np.float32).reshape(B))
    summary = SolverSummary(
        rt=torch.from_numpy(np.asarray(inputs["solver_rt"], np.float32)
                            .reshape(B, 3, 4)),
        num_before=scalar("num_before"), num_after=scalar("num_after"),
        num_tight=scalar("num_tight"), num_ultra_tight=scalar("num_ultra"),
        success=torch.ones(B, dtype=torch.bool))
    with torch.inference_mode():
        feat_c, feat_f0, feat_f1, t0, t1 = port.coarse_features(image0, image1)
        expec_f = port.fine_stage(feat_f0, feat_f1, t0, t1, i_ids, j_ids)
        mkpts1_c = ids_to_coords(j_ids, cfg.coarse_hw[1],
                                 float(cfg.backbone.resolution[0]))
        mkpts1_f = fine_coords_to_kpts(expec_f, mkpts1_c, cfg.fine.window_size,
                                       float(cfg.backbone.resolution[1]))
        pred_rt, gate = port.regress_fuse(port.regress_features(t0, t1), summary)
    # taps in the reference's layouts: NCHW maps, flat match rows
    return {"feats_c": feat_c, "feat_f0": feat_f0.permute(0, 3, 1, 2),
            "feat_c0": t0, "feat_c1": t1, "expec_f": expec_f.reshape(-1, 3),
            "mkpts1_f": mkpts1_f.reshape(-1, 2), "pred_rt": pred_rt,
            "gate": gate}


def test_farloftr_golden_taps():
    if not GOLDEN.exists():
        pytest.skip("golden fixture farloftr_seed0.npz not recorded")
    meta, inputs, _, taps = load_fixture(GOLDEN)
    cfg = FARConfig(
        image_size=(480, 640),
        coarse=AttentionStackConfig(layer_names=("self", "cross") * 3),
        regress=RegressConfig(num_loftr_layers=1, use_pos_embedding=True),
        dtype="float32",
    )
    sd = synth_state_dict(meta["sd_spec"], seed=meta["sd_seed"])
    port = FARLoFTR(cfg).eval()
    port.load_state_dict({k[len("matcher."):]: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, strict=True)
    ours = _replay(port, inputs)

    tap_atol = {tap.name: tap.atol or 0.0 for tap in FARLOFTR_TAPS}
    checked = {}
    for name, tap in taps.items():
        ref = np.asarray(tap, np.float32)
        got = ours[name].float().numpy()
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        err = float(np.abs(got - ref).max())
        tol = max(ATOL, tap_atol[name], RTOL_MAX * float(np.abs(ref).max()))
        checked[name] = (err, tol)
    assert set(checked) == {"feats_c", "feat_f0", "feat_c0", "feat_c1",
                            "expec_f", "mkpts1_f", "pred_rt", "gate"}
    bad = {k: v for k, v in checked.items() if not v[0] <= v[1]}
    assert not bad, bad
