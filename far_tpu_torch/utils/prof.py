"""Tracing and profiling helpers.

Counterpart of ``far_tpu/utils/prof.py``: ``InferenceProfiler`` sums the
host time of named regions, each a ``torch.profiler.record_function``
range that ends in ``torch.cuda.synchronize()`` (the JAX package's
``jax.effects_barrier()``), so a region's time includes the device work
it enqueued; ``TraceProfiler`` writes a ``torch.profiler`` Chrome trace
(host and CUDA activity) where the JAX package writes an XLA trace;
``build_profiler`` takes the JAX package's flag values.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

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
