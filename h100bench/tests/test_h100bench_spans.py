"""The readers of the program's own marks and counters (h100bench/spans.py
and the metric files that use it), on views built by hand: known device
marks and counters give known values; a view without marks
(the program before them) gives None, as does a program without the mark
module; a request with a wrong number of marks raises."""

import sys

import pytest

from helpers import DATA
from h100bench import spans
from h100bench.trace import View, load_module

HB = DATA.parents[1]
MARK = "anon::stage_mark_kernel"
ROUNDS = 2
# (metric, value) on the view below; us -> ms where the unit is ms
EXPECTED = {
    "backbone_span_ms.offline": (13 + 12) / 2 / 1e3,
    "coarse_span_ms.offline": 12 / 1e3,
    "match_span_ms.offline": 2 / 1e3,
    "fine_span_ms.offline": 5 / 1e3,
    "emm_span_ms.offline": 4 / 1e3,
    "rounds_span_ms.offline": 20 / 1e3,
    "rounds_span_ms.reloc": 20 / 1e3,
}


def request(t0, backbone, marks=True):
    """One request's device ops from t0: copies in, 8 marks around the
    stages' kernels, a clone out."""
    ops = [("Memcpy HtoD (Pinned -> Device)", 0, 5)]
    stages = [backbone, [("tc::row_pass_kernel", 28, 12)], [("tc::pass_kernel", 43, 2)],
              [("tc::fine_tc_kernel", 48, 5)], [("tc::main_kernel", 56, 4)],
              [("native::elementwise_kernel", 63, 7), ("native::reduce_kernel", 72, 3)],
              [("native::elementwise_kernel", 78, 10)]]
    at = [10, 26, 41, 46, 54, 61, 76, 89]
    for i, s in enumerate(at):
        if marks:
            ops.append((MARK, s, 1))
        if i < len(stages):
            ops += stages[i]
    ops.append(("Memcpy DtoD (Device -> Device)", 95, 1))
    return [(n, t0 + s, d) for n, s, d in sorted(ops, key=lambda o: o[1])]


def view(marks=True, drop=None):
    reqs = [request(0, [("sm90_xmma_fprop", 12, 8), ("nhwcAddPaddingKernel", 15, 10)], marks),
            request(1000, [("sm90_xmma_fprop", 12, 12)], marks)]
    if drop is not None:
        reqs[1] = [o for o in reqs[1] if not (o[0] == MARK and o[1] == 1000 + drop)]
    h = [("cudaGraphLaunch", 6.6, 91), ("cudaGraphLaunch", 1006.6, 1092)]
    return View(reqs, h, [(-5, 200), (995, 1200)], {"rounds": ROUNDS})


def read(name, v):
    return load_module(HB / "metrics" / f"{name}.py").read(v)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_known_marks_give_known_values(name):
    assert read(name, view()) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_stage_spans_cover_the_marked_part():
    """The stages' busy time adds up to the busy time from the first mark
    to the last, marks left out."""
    v = view()
    stages = sum(spans.span_ms(v, i, i + 1) for i in range(len(spans.MARKS) + ROUNDS - 1))
    assert stages == pytest.approx(spans.span_ms(v, 0, -1), rel=1e-12)
    assert spans.index("round.1") == 7


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_marks_no_value(name):
    assert read(name, view(marks=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_program_without_the_mark_module(name, monkeypatch):
    """The parent's case: the mark module and the counters do not import."""
    monkeypatch.setitem(sys.modules, "far_tpu_torch.ops.stage_mark", None)
    import far_tpu_torch.utils.prof as prof

    monkeypatch.delattr(prof, "counters")
    assert read(name, view()) is None
    assert spans.capture_s() is None and spans.round_nodes() is None


@pytest.mark.parametrize("drop", [10, 76])
def test_a_wrong_mark_count_raises(drop):
    with pytest.raises(ValueError, match="device marks"):
        read("rounds_span_ms.reloc", view(drop=drop))


def test_counters(monkeypatch):
    import far_tpu_torch.utils.prof as prof

    values = {"far.capture.warmup_s": 2.5, "far.capture.record_s": 0.75,
              "far.capture.nodes.backbone": 400,
              "far.capture.nodes.round.0": 3400,
              "far.capture.nodes.round.1": 3420}
    monkeypatch.setattr(prof, "counters", lambda: dict(values))
    v = view()
    assert read("capture_s.offline", v) == read("capture_s.reloc", v) == 3.25
    assert read("rounds_nodes.reloc", v) == 6820
    monkeypatch.setattr(prof, "counters", lambda: {})
    assert read("capture_s.reloc", v) is None and read("rounds_nodes.reloc", v) is None
