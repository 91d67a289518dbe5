"""The map-free request with SuperPoint + SuperGlue as its matcher
(``far_tpu_torch.models.superglue_matcher.SuperGlueMatcher`` under
``pipeline.mapfree_forward`` and ``build_mapfree_fn``) and the plain
reference the benchmark judges it by, on the CPU.

At small widths (a 128x160 pair, SuperPoint 16/16/32/32 wide with 64-wide
descriptors and 256 keypoints a side, SuperGlue 64 wide with 2 rounds of
4 heads; the 6DReg regressor of ``test_torch_mapfree_compiled.py``) one
random state dict (``h100bench/reference/weights.make_state_dict``)
loads into the port's modules and into the benchmark's plain float32
references (``h100bench/reference/superglue.py``, ``sixdreg.py``). The
matcher is held to the reference stage by stage, the request's stages,
marks and counters' prefix are the matcher's, on the CPU a call is the
eager request, and the judge reads the request as correct and a request
with one GNN round dropped, or Sinkhorn cut short, as not. The card
test is ``test_compiled_mapfree_superglue_on_card`` in
``test_torch_mapfree_compiled.py``.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from far_tpu_torch import pipeline
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.superglue import SuperGlueConfig
from far_tpu_torch.models.superglue_matcher import SuperGlueMatcher
from far_tpu_torch.models.superpoint import SuperPointConfig
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils import prof as tprof
from h100bench.reference import judge_mapfree_sg as jsg
from h100bench.reference import sixdreg as rs
from h100bench.reference import superglue as rsg
from h100bench.reference.synthetic import make_pairs
from h100bench.reference.weights import make_state_dict

torch.set_num_threads(2)
SHAPES = rsg.Shapes(image_hw=(128, 160), channels=(16, 16, 32, 32), desc_dim=64,
                    max_keypoints=256, num_layers=2, num_heads=4, match_threshold=1e-4)
SP = SuperPointConfig(channels=SHAPES.channels, desc_dim=64, nms_radius=3, max_keypoints=256)
SG = SuperGlueConfig(desc_dim=64, num_layers=2, num_heads=4, sinkhorn_iterations=20,
                     match_threshold=1e-4)
REG = dict(image_hw=(36, 28), encoder_blocks=(1, 1, 1), encoder_out_layers=8,
           transformer_layers=1, transformer_heads=4, hidden=32, dtype="float32")
STAGES = ("detect", "gnn", "sinkhorn", "solve.0", "encode.0", "volume.0", "round.0", "solve.1",
          "encode.1", "volume.1", "round.1")


def _shapes(make):
    with torch.device("meta"):
        return {k: v.shape for k, v in make().state_dict().items()}


def _matcher(sd, sg=SG):
    """The port's matcher on the reference's weights: its two final
    projections both the reference's one."""
    m = SuperGlueMatcher(SP, sg).eval()
    sd = dict(sd, **{k.replace("final_proj.", "final_proj2."): v for k, v in sd.items()
                     if k.startswith("superglue.final_proj.")})
    assert not m.load_state_dict(sd, strict=False).missing_keys
    return m


@pytest.fixture(scope="module")
def models():
    """(the port's matcher, regressor), (the references), a batch of two
    scenes at both sizes."""
    reg_cfg = SixDRegConfig(**REG)
    mref = rsg.SuperPointSuperGlueReference(SHAPES).eval()
    rref = rs.SixDRegReference(rs.shapes_from_config(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(reg_cfg).items()})).eval()
    sd = make_state_dict({**{"m." + k: v for k, v in _shapes(lambda: mref).items()},
                          **{"r." + k: v for k, v in _shapes(lambda: rref).items()}},
                         2 ** 33 + 21, "cpu")
    part = lambda p: {k[2:]: v for k, v in sd.items() if k.startswith(p)}
    mref.load_state_dict(part("m."))
    rref.load_state_dict(part("r."))
    reg = MapfreeRegression(reg_cfg).eval()
    reg.load_state_dict(part("r."))
    img0, img1, K, r0, r1, _ = make_pairs(2, SHAPES.image_hw, torch.Generator().manual_seed(5),
                                          "cpu", channels=3, extra_hw=reg_cfg.image_hw)
    gray = lambda im: im.mean(-1, keepdim=True)
    batch = PairBatch(image0=gray(img0), image1=gray(img1), K0=K, K1=K)
    return (_matcher(part("m.")), reg), (mref, rref), batch, r0, r1, part("m.")


def _close(out, ref, rel=1e-5):
    out, ref = out.detach().float(), ref.detach().float()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), (err, float(ref.abs().max()))


def test_matcher_matches_the_reference(models):
    """SuperPoint's keypoints, scores and validity equal to the
    reference's (magicleap's NMS, border and threshold, the stable top-K),
    its descriptors (magicleap's sampling) within float32 rounding;
    SuperGlue's scores and Sinkhorn assignment within float32 rounding,
    the mutual matches and their assignment the reference's."""
    (matcher, _), (mref, _), batch, _, _, _ = models
    with torch.inference_mode():
        m = matcher.match(batch).matches
        sides = [mref.superpoint.detect(im) for im in (batch.image0, batch.image1)]
        (k0, s0, v0, d0), (k1, s1, v1, d1) = sides
        sg = mref.superglue
        scores = sg.scores(k0, s0, v0, d0, k1, s1, v1, d1)
        P = sg.assignment(scores, v0, v1)
        m0, mconf = sg.select(P, v0)
        ours = matcher.superglue.scores(m.kpts0, m.scores0, m.kvalid0, m.desc0, m.kpts1,
                                        m.scores1, m.kvalid1, m.desc1, SHAPES.image_hw)
        P_ours = matcher.superglue.transport(ours, m.kvalid0, m.kvalid1)
    for a, b in ((m.kpts0, k0), (m.kpts1, k1), (m.scores0, s0), (m.scores1, s1),
                 (m.kvalid0, v0), (m.kvalid1, v1), (m.matches0, m0), (m.valid, m0 >= 0)):
        assert torch.equal(a, b)
    _close(m.desc0, d0)
    _close(m.desc1, d1)
    _close(ours, scores)
    _close(P_ours, P)
    _close(m.mconf, mconf)
    assert bool(v0.all()) and int(m.valid.sum()) >= 8  # the solver has work
    pts1 = k1.gather(1, m0.clamp(min=0)[..., None].expand(-1, -1, 2))
    assert torch.equal(m.mkpts1_f, pts1 * (m0 >= 0)[..., None])


def test_sinkhorn_counts_the_valid_slots(models):
    """With slots padded, the transport is magicleap's on the valid slots
    alone: each pair's valid block equal to the unpadded transport, the
    padded rows and columns at 0."""
    (matcher, _), _, _, _, _, _ = models
    g = torch.Generator().manual_seed(3)
    scores = 4 * torch.randn(2, 12, 10, generator=g)
    v0 = torch.arange(12)[None] < torch.tensor([[12], [7]])
    v1 = torch.arange(10)[None] < torch.tensor([[6], [10]])
    scores = scores.masked_fill(~(v0[:, :, None] & v1[:, None, :]), -1e9)
    P = matcher.superglue.transport(scores, v0, v1)
    for b in range(2):
        m, n = int(v0[b].sum()), int(v1[b].sum())
        alone = matcher.superglue.transport(scores[b:b + 1, :m, :n], v0[b:b + 1, :m],
                                            v1[b:b + 1, :n])
        _close(P[b, :m, :n], alone[0])
        assert not P[b, m:].any() and not P[b, :, n:].any()


def test_request_stages_are_the_matchers(models):
    """Under a sink the request marks its start, SuperPoint + SuperGlue's
    three stages, then four a round; ``build_mapfree_fn``'s stages and counters'
    prefix come from the matcher; LoFTR's request keeps its own."""
    (matcher, reg), _, batch, r0, r1, _ = models
    stages = pipeline.mapfree_stages(2, matcher.MATCH_STAGES)
    assert stages == STAGES
    assert pipeline.mapfree_stages(2)[:4] == ("backbone", "coarse", "match", "fine")
    slots = torch.zeros(len(stages) + 1, dtype=torch.int64)
    with torch.inference_mode(), tprof.marking(tprof.MarkSink(slots)) as sink:
        pipeline.mapfree_forward(matcher, reg, batch, r0, r1,
                                 generator=torch.Generator().manual_seed(0))
    assert sink.names == [tprof.REQUEST_MARK, *stages]
    assert bool((slots > 0).all()) and bool((slots.diff() >= 0).all())
    fn = pipeline.build_mapfree_fn(matcher, reg)
    assert fn.prefix == "mapfree_sg" and fn.stages() == STAGES


def test_compiled_on_the_cpu_is_eager(models):
    """On the CPU ``build_mapfree_fn`` over SuperGlue runs the eager
    request: it captures nothing and answers as ``mapfree_forward``."""
    (matcher, reg), _, batch, r0, r1, _ = models
    fn = pipeline.build_mapfree_fn(matcher, reg)
    out = fn(batch, r0, r1, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        ref = pipeline.mapfree_forward(matcher, reg, batch, r0, r1,
                                       generator=torch.Generator().manual_seed(3))
    assert fn.graphs == {}
    for f in ("R", "t", "gating", "regressed_9d", "solver_rt", "num_inliers"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for f in dataclasses.fields(ref.matches):
        assert torch.equal(getattr(out.matches, f.name), getattr(ref.matches, f.name)), f.name


def _judged(models, matcher, edit=None):
    """The judge's numbers of ``matcher``'s request, its output changed by
    ``edit`` first."""
    (_, reg), (mref, rref), batch, r0, r1, _ = models
    u = pipeline.draw_mapfree_uniforms(2, torch.Generator().manual_seed(9))
    with torch.inference_mode():
        out = pipeline.mapfree_forward(matcher, reg, batch, r0, r1, uniforms=u)
    fields = lambda o: {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}
    view = SimpleNamespace(**fields(out), **fields(out.matches))
    if edit is not None:
        edit(view)
    return jsg.judge(mref, rref, batch.image0, batch.image1, batch.K0, batch.K1, r0, r1, view, u)


def test_judge_reads_the_request_as_correct(models):
    """The judge reads the port's float32 request as it reads a sound
    program: the matcher's numbers and the solver's at float32 rounding."""
    nums = _judged(models, models[0][0])
    assert nums["kpt_gap"] == 0.0 and nums["inlier_recount"] == 0.0
    assert nums["desc_err"] < 1e-5 and nums["assign_err"] < 1e-4
    assert nums["select_gap"] < 1e-3 and nums["corr_gap"] == 0.0
    assert nums["solver_gap"] == 0.0 and nums["t_max"] < 1e-4


@pytest.mark.parametrize("cut", [dict(num_layers=1), dict(sinkhorn_iterations=1)],
                         ids=["one_gnn_round_dropped", "sinkhorn_stopped_after_one_iteration"])
def test_judge_reads_a_broken_matcher(cut, models):
    """One (self, cross) round dropped, or Sinkhorn stopped after its
    first iteration, moves the assignment at the selected matches by far
    more than float32 rounding (the tiny cell's limit, 0.1). At these
    widths the scores are small and Sinkhorn settles within 5 iterations,
    so dropping one of the 20 moves nothing here."""
    matcher = _matcher(models[5], dataclasses.replace(SG, **cut))
    assert _judged(models, matcher)["assign_err"] > 0.1


def _next_column(view):
    """Each match moved to the next column, its second point with it."""
    m0 = torch.where(view.valid, (view.matches0 + 1) % view.kpts1.shape[1], -1)
    pts1 = view.kpts1.gather(1, m0.clamp(min=0)[..., None].expand(-1, -1, 2))
    view.matches0, view.mkpts1_f = m0, pts1 * view.valid[..., None]


def _dropped(view):
    """Every other match not made."""
    keep = view.valid & (torch.arange(view.valid.shape[1]) % 2 == 0)
    view.matches0 = torch.where(keep, view.matches0, -1)
    view.valid = keep
    view.mkpts0_f, view.mkpts1_f = (x * keep[..., None] for x in (view.mkpts0_f, view.mkpts1_f))


def _gather_off_by_one(view):
    """The second points taken one keypoint after the matched one."""
    nxt = (view.matches0 + 1) % view.kpts1.shape[1]
    pts1 = view.kpts1.gather(1, nxt[..., None].expand(-1, -1, 2))
    view.mkpts1_f = pts1 * view.valid[..., None]


def _mask_not_matches(view):
    """One unmatched slot handed to the solver as valid."""
    i = int((~view.valid[0]).nonzero()[0])
    view.valid = view.valid.clone()
    view.valid[0, i] = True


@pytest.mark.parametrize("edit,number,over", [
    (_next_column, "select_gap", 0.005), (_dropped, "select_gap", 0.005),
    (_gather_off_by_one, "corr_gap", 0.0), (_mask_not_matches, "corr_gap", 0.0)],
    ids=["matches_moved_a_column", "every_other_match_dropped", "gather_off_by_one",
         "a_slot_valid_without_its_match"])
def test_judge_reads_a_broken_selection(edit, number, over, models):
    """The selection or the correspondences the solver is given, broken
    after a sound matcher, read over the tiny cell's limit of the number
    that judges them, the other at its sound reading."""
    nums = _judged(models, models[0][0], edit)
    other = "corr_gap" if number == "select_gap" else "select_gap"
    assert nums[number] > over and nums[other] < 1e-3, nums
