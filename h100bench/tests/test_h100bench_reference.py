"""The plain reference against the program's CPU path, and the control
(the reference through fp8) against the limits, for a tiny FAR cell."""

import json
import random

import pytest
import torch

from h100bench.reference.far import identity
from helpers import CELLS, DATA, run_tiny, session

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(cell, capsys):
    """The program's plain CPU path (float32, K2's features rounded to
    bf16 as the program always rounds them) judged by the reference: the
    run is correct, every stage but the match confidence agrees to float32
    rounding, the confidence to the bf16 rounding of the features."""
    rc, res = run_tiny(capsys, cell)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["match_gap"] == 0.0 and c["inlier_recount"] == 0.0 and c["solver_gap"] == 0.0
    assert c["gate_err"] < 1e-5 and c["rt_err"] < 1e-4
    assert res["read"]["fine_px"] < 1e-4
    assert c["mconf_err"] < 0.5
    assert res["attempted"] >= 2 and set(res["metrics"]) == {"pairs_per_s", "latency_p95_ms",
                                                            "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_as_program_reads_zero(cell):
    """Every gap reads 0; ``fine_shift`` is no gap but the reference's own
    refinement, which moves the matches."""
    nums = session(cell, 5).control(random.Random(1), quant=identity)
    assert nums.pop("fine_shift") > 0.0
    assert all(v == 0.0 for v in nums.values()), nums


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, seed):
    """The reference through fp8 in the program's place is not correct."""
    limits = json.loads((DATA / f"{cell}.json").read_text())["limits"]
    nums = session(cell, seed).control(random.Random(seed))
    assert any(nums[k] > limits[k] for k in limits), nums
