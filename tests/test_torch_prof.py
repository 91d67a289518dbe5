"""far_tpu_torch.utils.prof against far_tpu.utils.prof, on the CPU.

Both profilers see the same regions under the same clock (each module's
``time.perf_counter`` replaced by one fake clock), so their counts,
times and ``summary()`` must be equal as strings. ``build_profiler``
takes the JAX package's flag values. The trace profiler writes a Chrome
trace of a guard request on the CPU that names the region.
"""

import itertools
import json

import pytest
import torch

from far_tpu.utils import prof as jprof
from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
from far_tpu_torch.pipeline import build_inference_fn
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
