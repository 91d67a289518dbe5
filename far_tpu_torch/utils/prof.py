"""Tracing and profiling helpers.

Counterpart of ``far_tpu/utils/prof.py``: ``InferenceProfiler`` sums the
host time of named regions, each a ``torch.profiler.record_function``
range that ends in ``torch.cuda.synchronize()`` (the JAX package's
``jax.effects_barrier()``), so a region's time includes the device work
it enqueued; ``TraceProfiler`` writes a ``torch.profiler`` Chrome trace
(host and CUDA activity) where the JAX package writes an XLA trace;
``build_profiler`` takes the JAX package's flag values.

Inside the compiled request (``pipeline.CompiledRequest``, one CUDA graph
a request) the port marks its own stages, where the JAX package leaves
that to XLA's profiler:

- ``mark(stage)``: while a ``MarkSink`` is active (``marking``), a device
  mark (``ops/stage_mark``: a one-thread kernel that writes the card's
  clock to the stage's slot) on the current stream. The compiled request
  activates a sink for its warm-up and its capture, so the graph holds a
  mark at the request's start (``REQUEST_MARK``) and at the end of each
  stage (``BACKBONE`` … ``EMM``, then ``round_mark(i)`` a solver round;
  ``pipeline.request_stages`` puts them in order). With no sink (eager
  calls, the CPU, training) it returns at once.
- ``counters()``: numbers the capture writes (its seconds, each stage's
  operation nodes); a replay writes none.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class InferenceProfiler:
    """Accumulates wall time per named region, synchronising the card.

    Usage:
        prof = InferenceProfiler()
        with prof.profile("LoFTR"):
            out = fn(...)
        print(prof.summary())
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def profile(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if self.sync and torch.cuda.is_initialized():
                # everything the region enqueued has finished
                torch.cuda.synchronize()
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = ["region                         total_s   calls   mean_ms"]
        for k in sorted(self.times, key=self.times.get, reverse=True):
            t, c = self.times[k], self.counts[k]
            rows.append(f"{k:<30} {t:8.3f} {c:7d} {t / c * 1e3:9.2f}")
        return "\n".join(rows)


class PassThroughProfiler:
    @contextlib.contextmanager
    def profile(self, name: str):
        yield

    def summary(self) -> str:
        return "(profiling disabled)"


def build_profiler(name: Optional[str] = None):
    """The JAX package's flag values: ``"inference"``, ``"xla"`` (here the
    ``torch.profiler`` trace) and anything else (pass-through)."""
    if name == "inference":
        return InferenceProfiler()
    if name == "xla":
        return TraceProfiler()
    return PassThroughProfiler()


class TraceProfiler(PassThroughProfiler):
    """Writes a Chrome trace (``chrome://tracing``, Perfetto) of what runs
    inside ``trace()`` to ``logdir/trace.json``: host operations and, where
    a card is present, its kernels and copies."""

    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir or os.path.join(tempfile.gettempdir(), "far_tpu_torch_trace")
        self.path = os.path.join(self.logdir, "trace.json")

    @contextlib.contextmanager
    def trace(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(self.path)


# the compiled request's marks: its start, then the end of each stage
REQUEST_MARK = "request"
BACKBONE, COARSE, MATCH, FINE, EMM = "backbone", "coarse", "match", "fine", "emm"


def round_mark(i: int) -> str:
    """The mark that ends solver round ``i`` with its MoE fusion."""
    return f"round.{i}"


class MarkSink:
    """Where ``mark`` goes while the sink is active: a device mark each
    (``ops/stage_mark``) that writes its clock to its slot of ``slots``
    (int64, one slot a mark), the marks' names in order (``names``) and the
    operation nodes (kernels, copies, memsets) the capturing graph held
    before each (``nodes``: -1 outside a capture)."""

    def __init__(self, slots: torch.Tensor):
        self.slots = slots
        self.names: List[str] = []
        self.nodes: List[int] = []

    def mark(self, stage: str) -> None:
        from far_tpu_torch.ops.stage_mark import stage_mark

        self.nodes.append(stage_mark(self.slots, len(self.names)))
        self.names.append(stage)


_SINK: Optional[MarkSink] = None


@contextlib.contextmanager
def marking(sink: MarkSink):
    """``sink`` receives the marks made inside the block."""
    global _SINK
    prev, _SINK = _SINK, sink
    try:
        yield sink
    finally:
        _SINK = prev


def mark(stage: str) -> None:
    """The end of ``stage`` (or the request's start): a device mark where a
    sink is active, nothing otherwise."""
    if _SINK is not None:
        _SINK.mark(stage)


_COUNTERS: Dict[str, float] = {}


def add_counter(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name`` (made at 0)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def counters() -> Dict[str, float]:
    """A snapshot of every counter: {name: number}."""
    return dict(_COUNTERS)
