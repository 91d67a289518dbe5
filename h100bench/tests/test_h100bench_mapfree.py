"""The map-free cell at a tiny size on the CPU: the entry end to end, the
plain references against the program, the control against the limits,
runs with the program broken underneath, the readers of the map-free
marks and counters, and the operation count.

The tiny cell (``data/mapfree_tiny.json``, ``data/mapfree_tiny.b1.json``)
is the map-free request at small widths in float32: a 192x192 matcher
(32-wide coarse stack, 128 matches: enough, at about half of them inliers,
that another round's draws find another count) and the 6DReg regressor
with encoder blocks (1, 1, 1), 8 output channels, one transformer layer of
4 heads and hidden 32 at 36x28."""

import dataclasses
import json
import random
import sys

import pytest
import torch

import far_tpu_torch.models.loftr as loftr
import far_tpu_torch.pipeline as pipeline
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.geometry.rotations import matrix_to_rotation_6d, rotation_6d_to_matrix
from h100bench import flops_mapfree, spans_mapfree
from h100bench.reference import judge_mapfree as jm
from h100bench.reference.far import identity
from h100bench.trace import View, load_module
from helpers import DATA

torch.set_num_threads(2)
HB = DATA.parents[1]
CELL = "mapfree_tiny.b1"
TINY_BENCH = {
    "configs": [{"name": "mapfree_tiny", "file": "h100bench/tests/data/mapfree_tiny.json"}],
    "workloads": [{"name": CELL, "config": "mapfree_tiny", "traffic": "b1", "chips": 1}],
    "end_to_end": [{"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}
BENCH = json.loads((HB.parent / "BENCHMARK.json").read_text())


def run_tiny(capsys, seed=2 ** 31 + 77, seconds=1.0):
    """One CPU run of the tiny map-free cell -> (exit code, result line as
    a dict, with the numbers read but not compared under ``read``)."""
    from h100bench import run

    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds)],
                  bench=TINY_BENCH, device="cpu", workloads=DATA)
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    res["read"] = {ln.split()[1]: float(ln.split()[3]) for ln in cap.err.splitlines()
                   if ln.startswith("read ")}
    return rc, res


def session(seed):
    """The tiny cell's entry session without the program (the control's)."""
    from types import SimpleNamespace

    traffic = json.loads((DATA / f"{CELL}.json").read_text())
    entry = load_module(HB / "entries" / f"{traffic['entry']}.py")
    ctx = SimpleNamespace(config=json.loads((DATA / "mapfree_tiny.json").read_text()),
                          workload=traffic, seed=seed, device=torch.device("cpu"))
    return entry.Session(ctx, program=False)


# ---- the references and the control -----------------------------------------------------

def test_reference_agrees_with_the_program_on_the_cpu(capsys):
    """The program's plain CPU path (float32; K2's features rounded to bf16
    as the program always rounds them) judged by the references: the run
    is correct, every stage but the match confidence agrees to float32
    rounding (the regressor's numbers, read over the bf16 reference's own
    gap, to a hundredth of it), the confidence to the bf16 rounding of the
    features."""
    rc, res = run_tiny(capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["match_gap"] == 0.0 and c["inlier_recount"] == 0.0 and c["solver_gap"] == 0.0
    assert c["reg_err"] < 1e-2 and c["gate_err"] < 1e-2 and c["r6_err"] < 1e-2
    assert c["rt_err"] < 1e-4 and c["t_max"] < 1e-4
    assert res["read"]["fine_px"] < 1e-4 and res["read"]["r_max"] < 1e-4
    assert c["mconf_err"] < 0.5
    assert res["attempted"] >= 2 and set(res["metrics"]) == {"latency_p95_ms", "setup_s"}


def test_reference_as_program_reads_zero():
    """The references in the program's place read 0 on every gap;
    ``fine_shift`` is no gap but the reference's own refinement."""
    nums = session(5).control(random.Random(1), quant=identity)
    assert nums.pop("fine_shift") > 0.0
    assert all(v == 0.0 for v in nums.values()), nums


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_fails_the_limits(seed):
    """The references through fp8 in the program's place are not correct."""
    limits = json.loads((DATA / f"{CELL}.json").read_text())["limits"]
    nums = session(seed).control(random.Random(seed))
    assert any(nums[k] > limits[k] for k in limits), nums


def test_the_seed_makes_the_inputs_and_weights():
    """The same seed (a large one) gives the same pool, draws and weights,
    both models from one draw; another seed gives others; the matcher's
    pair is the regressor's scenes in grayscale."""
    a, b, c = (session(s) for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    for x, y, z in zip(a.pool + a.uniforms, b.pool + b.uniforms, c.pool + c.uniforms):
        assert torch.equal(x, y)
    assert not torch.equal(a.uniforms[0], c.uniforms[0]) and not torch.equal(a.pool[3], c.pool[3])
    assert [p.shape[-1] for p in a.pool] == [1, 1, 3, 3, 3]
    assert [tuple(u.shape[1:]) for u in a.uniforms] == [(1, 2048, 8)] * 2
    wa, wb, wc = (s._references().state_dict() for s in (a, b, c))
    assert {k.split(".")[0] for k in wa} == {"matcher", "regressor"}
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert any(not torch.equal(wa[k], wc[k]) for k in wa if k.startswith("regressor.")
               and wa[k].dtype.is_floating_point)


# ---- a program broken underneath ------------------------------------------------------

def break_request(monkeypatch, wrap):
    """Wrap the compiled map-free request."""
    build = pipeline.build_mapfree_fn
    monkeypatch.setattr(pipeline, "build_mapfree_fn",
                        lambda *a, **k: wrap(build(*a, **k)))


def moved_features(monkeypatch):
    """The regressor's features (the transformer's tokens) moved."""
    real = MapfreeRegression.tokens
    monkeypatch.setattr(MapfreeRegression, "tokens", lambda self, x: real(self, x) + 0.05)


def moved_gate(monkeypatch):
    def wrap(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            return dataclasses.replace(out, gating=out.gating + 0.01)
        return call
    break_request(monkeypatch, wrap)


def swapped_uniforms(monkeypatch):
    """Round 0 solves with round 1's draws and round 1 with round 0's."""
    def wrap(fn):
        def call(*a, uniforms, **kw):
            return fn(*a, uniforms=list(reversed(uniforms)), **kw)
        return call
    break_request(monkeypatch, wrap)


def moved_match(monkeypatch):
    """The coarse match answers the next cell of image 1."""
    real = loftr.coarse_match

    def shifted(*a, **k):
        i_ids, j_ids, *rest = real(*a, **k)
        return (i_ids, (j_ids + 1) % a[1].shape[1], *rest)
    monkeypatch.setattr(loftr, "coarse_match", shifted)


def rotation_with_t_gate(monkeypatch):
    """The rotation half of the blend weighs the 6D rows with t's gate."""
    real = MapfreeRegression.blend

    def blend(self, features, pred_9d, solver_rt, counts):
        _, t, blended, gate = real(self, features, pred_9d, solver_rt, counts)
        sp_r = matrix_to_rotation_6d(solver_rt[..., :3, :3].float())
        r6 = gate[..., :1] * pred_9d[..., 3:] + (1 - gate[..., :1]) * sp_r
        return rotation_6d_to_matrix(r6), t, blended, gate
    monkeypatch.setattr(MapfreeRegression, "blend", blend)


def frame_as_columns(monkeypatch):
    """The 6D-to-matrix step stacks Gram-Schmidt's frame as columns."""
    def wrap(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            return dataclasses.replace(out, R=out.R.transpose(-1, -2))
        return call
    break_request(monkeypatch, wrap)


@pytest.mark.parametrize("fault", [moved_features, moved_gate, swapped_uniforms, moved_match])
def test_broken_program_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, res = run_tiny(capsys)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [rotation_with_t_gate, frame_as_columns])
def test_broken_rotation_is_not_correct(fault, monkeypatch, capsys):
    """A fault in the rotation alone fails ``r6_err``: the gate, t and the
    regressed pose are the sound program's."""
    fault(monkeypatch)
    rc, res = run_tiny(capsys)
    assert rc == 0 and res["correct"] is False
    c = res["checks"]
    assert c["r6_err"]["value"] > c["r6_err"]["limit"], c
    assert c["gate_err"]["value"] < 1e-2 and c["reg_err"]["value"] < 1e-2, c
    assert c["t_max"]["value"] < 1e-4, c


def test_rows_gap_is_the_rows_gap():
    """``r6_err`` is the program's R seen as a gap of the blended rows: 0
    for the reference's own R, about a planted gap of the rows over their
    widest entry, and no wider where nearly parallel rows make R's entries
    move much more than the rows did."""
    g = torch.Generator().manual_seed(3)
    a1 = torch.randn(64, 3, generator=g, dtype=torch.float64)
    near = a1 + 1e-3 * torch.randn(64, 3, generator=g, dtype=torch.float64)
    for r6 in (torch.randn(64, 6, generator=g, dtype=torch.float64), torch.cat([a1, near], -1)):
        R, scale = rotation_6d_to_matrix(r6), r6.abs().amax(-1)
        assert jm.rows_gap(R, r6, scale) == 0.0
        delta = 1e-7 * torch.randn(64, 6, generator=g, dtype=torch.float64)
        moved = rotation_6d_to_matrix(r6 + delta)
        width = (delta.abs().amax(-1) / scale).amax().item()
        assert 0.2 * width < jm.rows_gap(moved, r6, scale) < 4 * width
    assert (moved - R).abs().amax().item() > 30 * width  # R's entries moved far more


def test_the_configuration_states_the_solver_it_runs():
    """The configuration's solver rounds are the program's and the judge's."""
    rounds = [dataclasses.asdict(c) for c in pipeline.mapfree_solver_configs()]
    assert rounds == [dataclasses.asdict(c) for c in jm.solver_configs()]
    for path in (HB / "configs" / "mapfree_6dreg.json", DATA / "mapfree_tiny.json"):
        doc = json.loads(path.read_text())
        assert doc["solver"]["rounds"] == rounds and "solver" not in doc["model"]


# ---- the cell in the benchmark -----------------------------------------------------------

def test_the_cell_is_declared():
    """One configuration, one cell on one chip, its per-layer metrics each
    read in it and filed, and ``latency_p95_ms`` reported in it."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == "mapfree_6dreg.reloc_b1")
    assert cell["chips"] == 1 and cell["config"] == "mapfree_6dreg"
    p95 = next(m for m in BENCH["end_to_end"] if m["name"] == "latency_p95_ms")
    assert "mapfree_6dreg.reloc_b1" in p95["workloads"]
    mine = [m for m in BENCH["per_layer"] if m["name"].endswith(".mapfree")]
    assert len(mine) == 11
    for m in mine:
        assert m["workloads"] == ["mapfree_6dreg.reloc_b1"]
        assert (HB / "metrics" / f"{m['name']}.py").exists()
    traffic = json.loads((HB / "workloads" / "mapfree_6dreg.reloc_b1.json").read_text())
    assert traffic["entry"] == "mapfree_request" and traffic["batch"] == 1
    assert {"match_gap", "solver_gap", "reg_err", "gate_err"} & set(traffic["limits"])


# ---- the readers of the map-free marks and counters --------------------------------------

MARK = "anon::stage_mark_kernel"
ROUNDS = 2


def request(t0, marks=True):
    """One request's device ops from t0: a copy in, 13 marks around the
    stages' kernels, a clone out. Stage k's kernel lies at 10 k + 3, 2 us
    long, after mark k at 10 k; the two rounds' solver stages hold a
    second kernel, 4 us, overlapping the first by 1."""
    ops = [("Memcpy HtoD (Pinned -> Device)", -8, 5)]
    n = len(spans_mapfree.MARKS) + len(spans_mapfree.ROUND) * ROUNDS
    for k in range(n):
        if marks:
            ops.append((MARK, 10 * k, 1))
        if k < n - 1:
            ops.append(("native::elementwise_kernel", 10 * k + 3, 2))
    for k in (spans_mapfree.index("solve.0"), spans_mapfree.index("solve.1")):
        ops.append(("native::reduce_kernel", 10 * (k - 1) + 4, 4))
    ops.append(("Memcpy DtoD (Device -> Device)", 10 * n + 5, 1))
    return [(nm, t0 + s, d) for nm, s, d in sorted(ops, key=lambda o: o[1])]


def view(marks=True, drop=None):
    reqs = [request(0, marks), request(1000, marks)]
    if drop is not None:
        reqs[1] = [o for o in reqs[1] if not (o[0] == MARK and o[1] == 1000 + drop)]
    return View(reqs, [], [(-10, 200), (990, 1200)],
                {"rounds": ROUNDS, "B": 1})


def read(name, v):
    return load_module(HB / "metrics" / f"{name}.py").read(v)


# (metric, value) on the view above, in ms: a stage holds 2 us, a solve
# stage 2 + 4 with an overlap of 1
EXPECTED = {
    "matcher_span_ms.mapfree": 4 * 2 / 1e3,
    "solver_span_ms.mapfree": 2 * 5 / 1e3,
    "encoder_span_ms.mapfree": 2 * 2 / 1e3,
    "volume_span_ms.mapfree": 2 * 2 / 1e3,
    "transformer_span_ms.mapfree": 2 * 2 / 1e3,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_known_marks_give_known_values(name):
    assert read(name, view()) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_the_marks_are_the_request_stages():
    """The readers' order of marks is the program's (``mapfree_stages``),
    and the stages' busy time adds up to the marked part's."""
    names = (spans_mapfree.MARKS[0],) + pipeline.mapfree_stages(ROUNDS)
    assert [spans_mapfree.index(n) for n in names] == list(range(len(names)))
    v = view()
    stages = sum(spans_mapfree.busy_ms(v, [(i, i + 1)]) for i in range(len(names) - 1))
    assert stages == pytest.approx(spans_mapfree.busy_ms(v, [(0, len(names) - 1)]), rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_marks_no_value(name):
    assert read(name, view(marks=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED) + ["capture_s.mapfree",
                                                     "solver_nodes.mapfree"])
def test_a_program_without_the_mark_module(name, monkeypatch):
    """The parent's case: the mark module and the counters do not import."""
    monkeypatch.setitem(sys.modules, "far_tpu_torch.ops.stage_mark", None)
    import far_tpu_torch.utils.prof as prof

    monkeypatch.delattr(prof, "counters")
    assert read(name, view()) is None


@pytest.mark.parametrize("drop", [0, 120])
def test_a_wrong_mark_count_raises(drop):
    with pytest.raises(ValueError, match="device marks"):
        read("solver_span_ms.mapfree", view(drop=drop))


def test_counters(monkeypatch):
    """The capture's seconds and the solve stages' nodes, under the map-free
    prefix only: FAR's counters are not read."""
    import far_tpu_torch.utils.prof as prof

    values = {"mapfree.capture.warmup_s": 2.5, "mapfree.capture.record_s": 0.75,
              "mapfree.capture.nodes.solve.0": 300, "mapfree.capture.nodes.solve.1": 420,
              "mapfree.capture.nodes.encode.0": 900, "far.capture.warmup_s": 9.0,
              "far.capture.record_s": 9.0, "far.capture.nodes.round.0": 1000}
    monkeypatch.setattr(prof, "counters", lambda: dict(values))
    v = view()
    assert read("capture_s.mapfree", v) == 3.25
    assert read("solver_nodes.mapfree", v) == 720
    monkeypatch.setattr(prof, "counters", lambda: {"far.capture.warmup_s": 1.0,
                                                   "far.capture.record_s": 1.0})
    assert read("capture_s.mapfree", v) is None and read("solver_nodes.mapfree", v) is None


# ---- the operation count --------------------------------------------------------------

@pytest.mark.parametrize("hw,blocks,out,layers", [((36, 28), (1, 1, 1), 8, 1),
                                                  ((64, 48), (2, 1, 2), 16, 2)])
def test_regressor_flops_count_the_model(hw, blocks, out, layers):
    """``flops_mapfree.regressor_flops`` equals what torch's flop counter
    counts in the program's regressor (convolutions and products, the MoE
    included) on the same shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = SixDRegConfig(image_hw=hw, encoder_blocks=blocks, encoder_out_layers=out,
                        transformer_layers=layers, transformer_heads=4, hidden=32,
                        dtype="float32")
    model = MapfreeRegression(cfg).eval()
    im = torch.rand(2, *hw, 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(im, im, torch.eye(3, 4).expand(2, 3, 4), torch.ones(2, 3))
    sh = dict(B=2, reg_hw=hw, reg_out=out, reg_blocks=blocks, reg_layers=layers,
              reg_hidden=32)
    assert flops_mapfree.regressor_flops(sh) == fc.get_total_flops()
