"""far_tpu_torch.utils.prof against far_tpu.utils.prof, on the CPU.

Both profilers see the same regions under the same clock (each module's
``time.perf_counter`` replaced by one fake clock), so their counts,
times and ``summary()`` must be equal as strings. ``build_profiler``
takes the JAX package's flag values. The trace profiler writes a Chrome
trace of a guard request on the CPU that names the region.

The compiled request's own marks (the JAX package has none): the guard's
``far_forward`` marks ``request_stages`` in order under a sink and
launches no mark without one; a sink takes only its own block's marks;
``stage_ms`` needs a request on the card; and a capture whose CUDA pieces
are faked writes its counters and ``stage_ms`` from the marks' nodes and
slots, and fails where its marks are not the request's stages. The card
tests (marks in a real graph and trace) are in ``tests/test_torch_hopper.py``.
"""

import contextlib
import dataclasses
import itertools
import json
from types import SimpleNamespace

import pytest
import torch

import far_tpu_torch.ops.stage_mark as stage_mark_mod
import far_tpu_torch.pipeline as pipeline
from far_tpu.utils import prof as jprof
from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
from far_tpu_torch.pipeline import (
    REQUEST_MARK,
    build_inference_fn,
    draw_uniforms,
    far_forward,
    request_stages,
)
from far_tpu_torch.tools.guard import load_guard
from far_tpu_torch.utils import prof as tprof

torch.set_num_threads(2)

REGIONS = ["backbone", "coarse", "backbone", "solver", "backbone", "solver"]


def _run(module, monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(module.time, "perf_counter", lambda: 0.02 * next(ticks))
    p = module.InferenceProfiler()
    for name in REGIONS:
        with p.profile(name):
            pass
    monkeypatch.undo()
    return p


def test_inference_profiler_matches_jax(monkeypatch):
    ours, ref = _run(tprof, monkeypatch), _run(jprof, monkeypatch)
    assert dict(ours.counts) == dict(ref.counts) == {"backbone": 3, "coarse": 1, "solver": 2}
    assert dict(ours.times) == pytest.approx(dict(ref.times), rel=0, abs=1e-15)
    assert ours.summary() == ref.summary()
    assert ours.summary().splitlines()[1].split() == ["backbone", "0.060", "3", "20.00"]


@pytest.mark.parametrize("flag", ["inference", "xla", None, "pytorch"])
def test_build_profiler_flags(flag):
    ours, ref = tprof.build_profiler(flag), jprof.build_profiler(flag)
    kinds = {tprof.InferenceProfiler: jprof.InferenceProfiler,
             tprof.TraceProfiler: jprof.XLATraceProfiler,
             tprof.PassThroughProfiler: jprof.PassThroughProfiler}
    assert kinds[type(ours)] is type(ref)
    if flag not in ("inference",):
        assert ours.summary() == ref.summary() == "(profiling disabled)"
        with ours.profile("x"):
            pass


def test_trace_holds_the_region(tmp_path):
    """One guard request on the CPU (8 synthetic 64x64 pairs) inside
    ``trace()`` and a region: the Chrome trace is written to ``logdir``
    and names the region; the region counted once."""
    model, _ = load_guard(device="cpu")
    ds = SyntheticPairDataset(n=8, hw=model.config.image_size, seed=4242, n_scenes=8,
                              max_angle_deg=12.0)
    batch, _ = collate([ds[i] for i in range(8)], torch.device("cpu"))
    fn = build_inference_fn(model)
    tp, ip = tprof.TraceProfiler(str(tmp_path / "trace")), tprof.InferenceProfiler()
    with tp.trace():
        with ip.profile("far_forward"):
            out = fn(batch, generator=torch.Generator().manual_seed(0))
    assert out.R.shape == (8, 3, 3)
    assert ip.counts == {"far_forward": 1}
    assert tp.path == str(tmp_path / "trace" / "trace.json")
    events = json.loads(open(tp.path).read())["traceEvents"]
    assert [e for e in events if e.get("name") == "far_forward"]


def _guard(n, steps=2):
    """The guard model with ``fine_pred_steps`` = ``steps``, and n pairs."""
    model, _ = load_guard(device="cpu")
    cfg = model.config
    model.config = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, fine_pred_steps=steps))
    ds = SyntheticPairDataset(n=n, hw=cfg.image_size, seed=4242, n_scenes=n,
                              max_angle_deg=12.0)
    batch, _ = collate([ds[i] for i in range(n)], torch.device("cpu"))
    return model, batch


@pytest.mark.parametrize("steps", [1, 2])
def test_far_forward_marks_its_stages_in_order(steps):
    """Under a sink with slots, far_forward marks the request's start and
    the end of each of request_stages, in order, one slot each (the plain
    mark writes the host's clock, so the slots do not decrease)."""
    model, batch = _guard(2, steps)
    stages = request_stages(model.config)
    assert stages == ("backbone", "coarse", "match", "fine", "emm") + tuple(
        f"round.{i}" for i in range(steps))
    slots = torch.zeros(len(stages) + 1, dtype=torch.int64)
    with torch.inference_mode(), tprof.marking(tprof.MarkSink(slots)) as sink:
        far_forward(model, batch, torch.Generator().manual_seed(0))
    assert sink.names == [REQUEST_MARK, *stages]
    assert sink.nodes == [-1] * len(sink.names)
    assert bool((slots > 0).all()) and bool((slots.diff() >= 0).all())


def test_no_sink_no_mark(monkeypatch):
    """With no sink, neither ``mark`` nor a whole far_forward launches a
    mark; under a sink the request launches one a mark, in slot order."""
    launched = []
    monkeypatch.setattr(stage_mark_mod, "stage_mark",
                        lambda slots, k: launched.append(k) or -1)
    model, batch = _guard(2)
    tprof.mark("backbone")
    with torch.inference_mode():
        far_forward(model, batch, torch.Generator().manual_seed(0))
        assert launched == []
        with tprof.marking(tprof.MarkSink(torch.zeros(8, dtype=torch.int64))):
            far_forward(model, batch, torch.Generator().manual_seed(0))
    assert launched == list(range(8))


def test_marking_restores_the_outer_sink():
    """A sink holds the marks of its own block only: an inner ``marking``
    takes the marks inside it, the outer sink takes them again after it,
    also when the inner block raises, and none is active after both."""
    outer, inner = (tprof.MarkSink(torch.zeros(4, dtype=torch.int64)) for _ in range(2))
    with tprof.marking(outer):
        tprof.mark(tprof.REQUEST_MARK)
        with pytest.raises(RuntimeError), tprof.marking(inner):
            tprof.mark(tprof.BACKBONE)
            raise RuntimeError("a failed capture")
        tprof.mark(tprof.COARSE)
    tprof.mark(tprof.MATCH)
    assert outer.names == [tprof.REQUEST_MARK, tprof.COARSE]
    assert inner.names == [tprof.BACKBONE]


def test_stage_ms_needs_a_request_on_the_card():
    """On the CPU a compiled request is the eager far_forward: it captures
    nothing, so there are no marks' slots for ``stage_ms`` to read."""
    model, batch = _guard(2)
    fn = build_inference_fn(model)
    fn(batch, generator=torch.Generator().manual_seed(0))
    assert fn.graphs == {}
    with pytest.raises(RuntimeError, match="no request has run on the card"):
        fn.stage_ms()


def _fake_cuda(monkeypatch, fake_mark):
    """torch.cuda's streams, graph and memory queries and the mark kernel
    faked, so that ``CompiledRequest._capture`` runs on the CPU; returns
    the list that holds an entry while the fake graph captures."""
    capturing = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        capturing.append(True)
        yield
        capturing.clear()

    stream = SimpleNamespace(wait_stream=lambda other: None)
    for name, fake in (("Stream", lambda device: stream), ("graph_pool_handle", lambda: None),
                       ("current_stream", lambda device: stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("synchronize", lambda device=None: None), ("empty_cache", lambda: None),
                       ("memory_reserved", lambda device=None: 0), ("CUDAGraph", object),
                       ("graph", graph)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None, raising=False)
    monkeypatch.setattr(stage_mark_mod, "stage_mark", fake_mark)
    return capturing


def test_capture_counters_with_faked_cuda(monkeypatch):
    """CompiledRequest._capture on the CPU with torch.cuda's streams,
    graph, memory queries and the mark kernel faked: the counters grow by
    the warm-up's and the capture's seconds (a fake clock) and by each
    stage's operation nodes (from the nodes before each mark, the marks
    left out); the marks' slots give stage_ms."""
    model, batch = _guard(2)
    stages = request_stages(model.config)
    before_mark = iter([0, 40, 90, 95, 130, 150, 700, 1300])  # operation nodes

    def fake_mark(slots, k):
        slots[k] = 500_000 * k * (k + 1)  # stage i takes i ms
        return next(before_mark) if capturing else -1

    capturing = _fake_cuda(monkeypatch, fake_mark)
    clock = iter([10.0, 11.5, 20.0, 20.25])
    monkeypatch.setattr(pipeline, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    fn = build_inference_fn(model)
    uniforms = draw_uniforms(model.config, 2, torch.Generator().manual_seed(0))
    before = tprof.counters()
    with torch.inference_mode():
        fn._capture("signature", batch, None, uniforms, None)
    after = tprof.counters()
    grew = {k: after[k] - before.get(k, 0) for k in after if k.startswith("far.capture.")}
    assert grew == pytest.approx({
        "far.capture.warmup_s": 1.5, "far.capture.record_s": 0.25,
        **{f"far.capture.nodes.{s}": n for s, n in zip(
            stages, [39, 49, 4, 34, 19, 549, 599])}}, rel=0, abs=1e-12)
    assert fn.stage_ms() == {s: float(i) for i, s in enumerate(stages, 1)}
    assert list(fn.graphs) == ["signature"]


def test_capture_refuses_marks_that_are_not_the_stages(monkeypatch):
    """A capture whose marks differ from request_stages (here a stage list
    that names the EMM stage otherwise) raises, keeps no graph and adds to
    no counter."""
    model, batch = _guard(2)
    stages = tuple("regress" if s == tprof.EMM else s for s in request_stages(model.config))
    monkeypatch.setattr(pipeline, "request_stages", lambda cfg: stages)
    _fake_cuda(monkeypatch, lambda slots, k: -1)
    fn = build_inference_fn(model)
    uniforms = draw_uniforms(model.config, 2, torch.Generator().manual_seed(0))
    before = tprof.counters()
    with torch.inference_mode(), pytest.raises(RuntimeError, match="not the request's stages"):
        fn._capture("signature", batch, None, uniforms, None)
    assert fn.graphs == {} and tprof.counters() == before
