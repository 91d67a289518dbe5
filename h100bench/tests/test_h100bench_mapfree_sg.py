"""The map-free SuperGlue cell at a tiny size on the CPU: the entry end to
end, the plain references against the program, the control against the
limits, runs with the program broken underneath, the readers of the
cell's marks and counters, and the operation count.

The tiny cell (``data/mapfree_sg_tiny.json``, ``data/mapfree_sg_tiny.b1.json``)
is the map-free request with SuperPoint + SuperGlue at small widths in
float32: a 128x160 pair, SuperPoint 16/16/32/32 wide with 64-wide
descriptors and 256 keypoints a side, SuperGlue 64 wide with 2 (self,
cross) rounds of 4 heads and 20 Sinkhorn iterations, and the 6DReg
regressor of ``mapfree_tiny.json``."""

import dataclasses
import json
import random
import sys
from types import SimpleNamespace

import pytest
import torch

import far_tpu_torch.models.superglue_matcher as superglue_matcher
import far_tpu_torch.models.superpoint as superpoint
import far_tpu_torch.pipeline as pipeline
from far_tpu_torch.models.sixdreg import MapfreeRegression
from far_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from far_tpu_torch.models.superglue_matcher import SuperGlueMatcher
from far_tpu_torch.models.superpoint import SuperPointConfig
from h100bench import flops_mapfree_sg, spans_mapfree_sg
from h100bench.reference.far import identity
from h100bench.trace import View, load_module
from helpers import DATA

torch.set_num_threads(2)
HB = DATA.parents[1]
CELL = "mapfree_sg_tiny.b1"
NEW = "mapfree_6dreg_superglue.reloc_b1"
TINY_BENCH = {
    "configs": [{"name": "mapfree_sg_tiny", "file": "h100bench/tests/data/mapfree_sg_tiny.json"}],
    "workloads": [{"name": CELL, "config": "mapfree_sg_tiny", "traffic": "b1", "chips": 1}],
    "end_to_end": [{"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}
BENCH = json.loads((HB.parent / "BENCHMARK.json").read_text())


def run_tiny(capsys, seed=2 ** 31 + 77, seconds=1.0):
    """One CPU run of the tiny cell -> (exit code, result line as a dict,
    with the numbers read but not compared under ``read``)."""
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
    traffic = json.loads((DATA / f"{CELL}.json").read_text())
    entry = load_module(HB / "entries" / f"{traffic['entry']}.py")
    ctx = SimpleNamespace(config=json.loads((DATA / "mapfree_sg_tiny.json").read_text()),
                          workload=traffic, seed=seed, device=torch.device("cpu"))
    return entry.Session(ctx, program=False)


# ---- the references and the control -----------------------------------------------------

def test_reference_agrees_with_the_program_on_the_cpu(capsys):
    """The program's plain CPU path (float32) judged by the references: the
    run is correct, its keypoints the reference's, every other number at
    float32 rounding (the regressor's, read over the bf16 reference's own
    gap, to a hundredth of it)."""
    rc, res = run_tiny(capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["kpt_gap"] == 0.0 and c["inlier_recount"] == 0.0
    assert c["desc_err"] < 1e-5 and c["assign_err"] < 1e-4
    assert c["select_gap"] < 1e-3 and c["corr_gap"] == 0.0
    assert c["reg_err"] < 1e-2 and c["r6_err"] < 1e-2 and c["t_max"] < 1e-4
    assert res["read"]["solver_gap"] == 0.0 and res["read"]["rt_err"] < 1e-4
    assert res["read"]["desc_err_bf16"] > 100 * c["desc_err"]
    assert res["attempted"] >= 2 and set(res["metrics"]) == {"latency_p95_ms", "setup_s"}


def test_reference_as_program_reads_zero():
    """The references in the program's place read 0 on every gap."""
    nums = session(5).control(random.Random(1), quant=identity)
    for k in ("desc_err_bf16", "assign_err_bf16"):  # the bf16 reference's own gaps
        assert nums.pop(k) > 0.0
    assert all(v == 0.0 for v in nums.values()), nums


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_fails_the_limits(seed):
    """The references through fp8 in the program's place are not correct."""
    limits = json.loads((DATA / f"{CELL}.json").read_text())["limits"]
    nums = session(seed).control(random.Random(seed))
    assert any(nums[k] > limits[k] for k in limits), nums


def test_the_seed_makes_the_inputs_and_weights():
    """The same seed (a large one) gives the same pool, draws and weights,
    the three models from one draw; another seed gives others; the
    matcher's pair is the regressor's scenes in grayscale."""
    a, b, c = (session(s) for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    for x, y in zip(a.pool + a.uniforms, b.pool + b.uniforms):
        assert torch.equal(x, y)
    assert not torch.equal(a.uniforms[0], c.uniforms[0]) and not torch.equal(a.pool[0], c.pool[0])
    assert [p.shape[-1] for p in a.pool] == [1, 1, 3, 3, 3]
    wa, wb, wc = (s._references().state_dict() for s in (a, b, c))
    assert {k.split(".")[0] for k in wa} == {"matcher", "regressor"}
    assert {k.split(".")[1] for k in wa if k.startswith("matcher.")} == {"superpoint",
                                                                          "superglue"}
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert any(not torch.equal(wa[k], wc[k]) for k in wa if wa[k].dtype.is_floating_point)


def test_the_program_takes_the_references_weights():
    """The program's matcher loads the references' state strictly, its two
    final projections both SuperGlue's one."""
    s = session(2 ** 33 + 3)
    entry = load_module(HB / "entries" / "mapfree_sg_request.py")
    state = entry.matcher_state(entry.weights(s.ctx.config, s.ctx.seed, "cpu"))
    m = SuperGlueMatcher(s.sp_cfg, s.sg_cfg)
    m.load_state_dict(state)
    assert torch.equal(m.superglue.final_proj.weight, m.superglue.final_proj2.weight)


# ---- a program broken underneath ------------------------------------------------------

def gnn_round_dropped(monkeypatch):
    """SuperGlue runs one (self, cross) round fewer."""
    real = SuperGlue.scores

    def scores(self, *a, **k):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        try:
            return real(self, *a, **k)
        finally:
            self.cfg = cfg
    monkeypatch.setattr(SuperGlue, "scores", scores)


def sinkhorn_cut_short(monkeypatch):
    """Sinkhorn stops after its first iteration (at these widths it settles
    within 5, so one of 20 dropped moves nothing)."""
    real = SuperGlue.transport

    def transport(self, *a, **k):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, sinkhorn_iterations=1)
        try:
            return real(self, *a, **k)
        finally:
            self.cfg = cfg
    monkeypatch.setattr(SuperGlue, "transport", transport)


def descriptors_at_an_eighth(monkeypatch):
    """Descriptors sampled at x / 8, the JAX package's coordinates."""
    def sample(fmap, kpts, s=8):
        return torch.nn.functional.normalize(superpoint._bilinear_sample(fmap, kpts / s), dim=-1)
    monkeypatch.setattr(superpoint, "sample_descriptors", sample)


def selection_not_mutual(monkeypatch):
    """Each row's argmax is kept over the threshold, whether or not its
    column's argmax is the row."""
    def select(P, valid0, threshold):
        conf, j = P.max(dim=2)
        ok = (conf > threshold) & valid0
        return torch.where(ok, j, -1).int(), torch.where(ok, conf, 0.0)
    monkeypatch.setattr(superglue_matcher, "select_matches", select)


def half_the_matches_dropped(monkeypatch):
    """The odd rows' mutual matches are not kept."""
    real = superglue_matcher.select_matches

    def select(P, valid0, threshold):
        m0, conf = real(P, valid0, threshold)
        odd = torch.arange(m0.shape[1], device=m0.device) % 2 == 1
        return torch.where(odd, -1, m0), torch.where(odd, 0.0, conf)
    monkeypatch.setattr(superglue_matcher, "select_matches", select)


def gather_off_by_one(monkeypatch):
    """The solver's second points are the keypoints one slot after the
    matched ones."""
    real = SuperGlueMatcher.match

    def match(self, batch):
        out = real(self, batch)
        m = out.matches
        nxt = (m.matches0 + 1) % m.kpts1.shape[1]
        pts1 = torch.gather(m.kpts1, 1, nxt[..., None].expand(-1, -1, 2))
        return dataclasses.replace(out, matches=dataclasses.replace(
            m, mkpts1_f=pts1 * m.valid[..., None]))
    monkeypatch.setattr(SuperGlueMatcher, "match", match)


def moved_features(monkeypatch):
    """The regressor's features (the transformer's tokens) moved."""
    real = MapfreeRegression.tokens
    monkeypatch.setattr(MapfreeRegression, "tokens", lambda self, x: real(self, x) + 0.05)


def swapped_uniforms(monkeypatch):
    """Round 0 solves with round 1's draws and round 1 with round 0's."""
    build = pipeline.build_mapfree_fn

    def wrap(fn):
        def call(*a, uniforms, **kw):
            return fn(*a, uniforms=list(reversed(uniforms)), **kw)
        return call
    monkeypatch.setattr(pipeline, "build_mapfree_fn", lambda *a, **k: wrap(build(*a, **k)))


@pytest.mark.parametrize("fault", [gnn_round_dropped, sinkhorn_cut_short,
                                   descriptors_at_an_eighth, selection_not_mutual,
                                   half_the_matches_dropped, gather_off_by_one,
                                   moved_features])
def test_broken_program_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, res = run_tiny(capsys)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_swapped_draws_read_in_the_solver(monkeypatch, capsys):
    """The rounds' draws swapped move the inliers the solver reports away
    from the reference's rounds on the same correspondences."""
    swapped_uniforms(monkeypatch)
    rc, res = run_tiny(capsys)
    assert rc == 0 and res["read"]["solver_gap"] > 0.0


def test_the_configuration_states_the_solver_it_runs():
    """The configuration's solver rounds are the program's and the judge's,
    and its regressor is the LoFTR map-free cell's."""
    rounds = [dataclasses.asdict(c) for c in pipeline.mapfree_solver_configs()]
    doc = json.loads((HB / "configs" / "mapfree_6dreg_superglue.json").read_text())
    other = json.loads((HB / "configs" / "mapfree_6dreg.json").read_text())
    assert doc["solver"]["rounds"] == rounds and doc["regressor"] == other["regressor"]
    assert set(doc["reduced"]) == set(doc["published"]) == {"match_threshold"}
    assert doc["superglue"]["match_threshold"] < doc["published"]["match_threshold"]
    for key, cls in (("superpoint", SuperPointConfig), ("superglue", SuperGlueConfig)):
        fields = {f.name for f in dataclasses.fields(cls)}
        assert set(doc[key]) - {"weights"} <= fields, key


# ---- the cell in the benchmark -----------------------------------------------------------

METRICS = ("detector_span_ms", "gnn_span_ms", "sinkhorn_span_ms", "sinkhorn_nodes",
           "solver_span_ms", "mfu", "idle_share", "capture_s", "encoder_span_ms",
           "volume_span_ms", "transformer_span_ms", "solver_nodes")


def test_the_cell_is_declared():
    """One configuration of its own source, one cell on one chip, its twelve
    per-layer metrics each read in it and filed, ``latency_p95_ms``
    reported in it."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == NEW)
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert cell["chips"] == 1 and cfg["reduced"] == ["match_threshold"]
    assert sum(c["source"] == cfg["source"] for c in BENCH["configs"]) == 1
    p95 = next(m for m in BENCH["end_to_end"] if m["name"] == "latency_p95_ms")
    assert NEW in p95["workloads"]
    mine = [m for m in BENCH["per_layer"] if m["name"].endswith(".mapfree_sg")]
    assert sorted(m["name"] for m in mine) == sorted(f"{n}.mapfree_sg" for n in METRICS)
    for m in mine:
        assert m["workloads"] == [NEW]
        assert m["moves"] == ("setup_s" if m["name"].startswith("capture_s") else
                              "latency_p95_ms")
        assert (HB / "metrics" / f"{m['name']}.py").exists()
    traffic = json.loads((HB / "workloads" / f"{NEW}.json").read_text())
    assert traffic["entry"] == "mapfree_sg_request" and traffic["batch"] == 1
    assert set(traffic["limits"]) == {"kpt_gap", "desc_err", "assign_err", "select_gap",
                                      "corr_gap", "inlier_recount", "reg_err", "r6_err",
                                      "t_max"}
    assert traffic["limits"]["corr_gap"] == 0.0


# ---- the readers of the cell's marks and counters ----------------------------------------

MARK = "anon::stage_mark_kernel"
ROUNDS = 2


def request(t0, marks=True):
    """One request's device ops from t0: a copy in, 12 marks around the
    stages' kernels, a clone out. Stage k's kernel lies at 10 k + 3, 2 us
    long, after mark k at 10 k; the two rounds' solver stages and the
    Sinkhorn stage hold a second kernel, 4 us, overlapping the first by 1."""
    ops = [("Memcpy HtoD (Pinned -> Device)", -8, 5)]
    n = len(spans_mapfree_sg.MARKS) + len(spans_mapfree_sg.ROUND) * ROUNDS
    for k in range(n):
        if marks:
            ops.append((MARK, 10 * k, 1))
        if k < n - 1:
            ops.append(("native::elementwise_kernel", 10 * k + 3, 2))
    for name in ("sinkhorn", "solve.0", "solve.1"):
        k = spans_mapfree_sg.index(name)
        ops.append(("native::reduce_kernel", 10 * (k - 1) + 4, 4))
    ops.append(("Memcpy DtoD (Device -> Device)", 10 * n + 5, 1))
    return [(nm, t0 + s, d) for nm, s, d in sorted(ops, key=lambda o: o[1])]


def view(marks=True, drop=None, short=(1,)):
    """Two requests; the mark at ``drop`` us into each request in ``short``
    taken out."""
    reqs = [request(0, marks), request(1000, marks)]
    if drop is not None:
        for k in short:
            reqs[k] = [o for o in reqs[k] if not (o[0] == MARK and o[1] == 1000 * k + drop)]
    return View(reqs, [], [(-10, 200), (990, 1200)], {"rounds": ROUNDS, "B": 1})


def read(name, v):
    return load_module(HB / "metrics" / f"{name}.py").read(v)


# (metric, value) on the view above, in ms: a stage holds 2 us, a Sinkhorn
# or solve stage 2 + 4 with an overlap of 1
EXPECTED = {
    "detector_span_ms.mapfree_sg": 2 / 1e3,
    "gnn_span_ms.mapfree_sg": 2 / 1e3,
    "sinkhorn_span_ms.mapfree_sg": 5 / 1e3,
    "solver_span_ms.mapfree_sg": 2 * 5 / 1e3,
    "encoder_span_ms.mapfree_sg": 2 * 2 / 1e3,
    "volume_span_ms.mapfree_sg": 2 * 2 / 1e3,
    "transformer_span_ms.mapfree_sg": 2 * 2 / 1e3,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_known_marks_give_known_values(name):
    assert read(name, view()) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_the_marks_are_the_request_stages():
    """The readers' order of marks is the program's (``mapfree_stages`` of
    the SuperGlue matcher), and the stages' busy time adds up to the
    marked part's."""
    names = (spans_mapfree_sg.MARKS[0],) + pipeline.mapfree_stages(
        ROUNDS, SuperGlueMatcher.MATCH_STAGES)
    assert [spans_mapfree_sg.index(n) for n in names] == list(range(len(names)))
    v = view()
    stages = sum(spans_mapfree_sg.busy_ms(v, [(i, i + 1)]) for i in range(len(names) - 1))
    assert stages == pytest.approx(spans_mapfree_sg.busy_ms(v, [(0, len(names) - 1)]),
                                   rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_marks_no_value(name):
    assert read(name, view(marks=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED) + ["capture_s.mapfree_sg",
                                                     "sinkhorn_nodes.mapfree_sg",
                                                     "solver_nodes.mapfree_sg"])
def test_a_program_without_the_mark_module(name, monkeypatch):
    """The parent's case: the mark module and the counters do not import."""
    monkeypatch.setitem(sys.modules, "far_tpu_torch.ops.stage_mark", None)
    import far_tpu_torch.utils.prof as prof

    monkeypatch.delattr(prof, "counters")
    assert read(name, view()) is None


@pytest.mark.parametrize("drop", [0, 110])
def test_a_wrong_mark_count_raises(drop):
    """No request holds the program's marks: the layout is not the
    readers'."""
    with pytest.raises(ValueError, match="device marks"):
        read("gnn_span_ms.mapfree_sg", view(drop=drop, short=(0, 1)))


@pytest.mark.parametrize("drop", [0, 30, 110])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_request_short_of_a_mark_is_left_out(name, drop):
    """A request the trace holds short of one mark (timed outside its host
    span, or lost) is left out; the spans read over the others."""
    assert read(name, view(drop=drop)) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_counters(monkeypatch):
    """The capture's seconds, the Sinkhorn stage's nodes and the solver
    rounds', under the cell's prefix only: the LoFTR map-free request's
    counters are not read."""
    import far_tpu_torch.utils.prof as prof

    values = {"mapfree_sg.capture.warmup_s": 2.5, "mapfree_sg.capture.record_s": 0.75,
              "mapfree_sg.capture.nodes.sinkhorn": 130, "mapfree_sg.capture.nodes.gnn": 900,
              "mapfree_sg.capture.nodes.solve.0": 300, "mapfree.capture.warmup_s": 9.0,
              "mapfree.capture.record_s": 9.0, "mapfree.capture.nodes.solve.0": 1000}
    monkeypatch.setattr(prof, "counters", lambda: dict(values))
    v = view()
    assert read("capture_s.mapfree_sg", v) == 3.25
    assert read("sinkhorn_nodes.mapfree_sg", v) == 130
    assert read("solver_nodes.mapfree_sg", v) == 300
    monkeypatch.setattr(prof, "counters", lambda: {"mapfree.capture.warmup_s": 1.0,
                                                   "mapfree.capture.record_s": 1.0})
    assert read("capture_s.mapfree_sg", v) is None
    assert read("sinkhorn_nodes.mapfree_sg", v) is None
    assert read("solver_nodes.mapfree_sg", v) is None


# ---- the operation count --------------------------------------------------------------

@pytest.mark.parametrize("hw,channels,D,K,layers", [((64, 48), (8, 8, 16, 16), 32, 40, 1),
                                                    ((96, 128), (16, 8, 32, 24), 64, 64, 2)])
def test_matcher_flops_count_the_model(hw, channels, D, K, layers):
    """``flops_mapfree_sg``'s SuperPoint and SuperGlue counts equal what
    torch's flop counter counts in the program's matcher (convolutions,
    linear layers and products) on the same shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    m = SuperGlueMatcher(SuperPointConfig(channels=channels, desc_dim=D, max_keypoints=K),
                         SuperGlueConfig(desc_dim=D, num_layers=layers)).eval()
    im = torch.rand(2, *hw, 1)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        k, s, v, d = m.superpoint(im)
    assert flops_mapfree_sg.superpoint_flops(2, hw, channels + (D,)) == fc.get_total_flops()
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        m.superglue.scores(k[:1], s[:1], v[:1], d[:1], k[1:], s[1:], v[1:], d[1:], hw)
    assert flops_mapfree_sg.superglue_flops(1, K, D, layers) == fc.get_total_flops()
