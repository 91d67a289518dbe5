"""The program's own marks and counters, as the per-layer readers take them.

The compiled request (``far_tpu_torch.pipeline.CompiledRequest``) holds,
inside its CUDA graph, a device mark (a one-thread kernel,
``far_tpu_torch.ops.stage_mark.SYMBOL``) at the request's start and at the
end of each stage: ``MARKS``, then one a solver round. So a traced request
holds 6 + rounds marks, in that order, and the stage a mark ends lies
between it and the mark before. Its capture writes counters
(``far_tpu_torch.utils.prof.counters``). Busy time here is the union of
the device operations' intervals with the marks left out. Where the
program has no marks (a checkout before them: the mark module does not
import, or no trace event carries the mark's name) or no counters, every
function returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from h100bench.trace import union_us

# the device marks before the rounds': the request's start, then the end
# of the backbone, the coarse transformer, the coarse match, the fine
# stage and the EMM features
MARKS = ("request", "backbone", "coarse", "match", "fine", "emm")

Span = Tuple[float, float]  # (start us, end us)


def mark_symbol() -> Optional[str]:
    """The device mark's name in the trace; None where the program has no
    mark module."""
    try:
        from far_tpu_torch.ops.stage_mark import SYMBOL
    except ImportError:
        return None
    return SYMBOL


def marks(view) -> Optional[List[List[Span]]]:
    """Each traced request's device marks in order; None where no request
    holds one. Raises where a request holds another number than 6 +
    rounds."""
    sym = mark_symbol()
    if sym is None:
        return None
    per = [[(s, s + d) for n, s, d in r if n == sym] for r in view.requests]
    if not any(per):
        return None
    want = len(MARKS) + view.shapes["rounds"]
    counts = [len(p) for p in per]
    if any(c != want for c in counts):
        raise ValueError(f"device marks a traced request {counts}, not {want}")
    return per


def index(name: str) -> int:
    """A mark's place: one of ``MARKS`` or ``round.<i>``."""
    return MARKS.index(name) if name in MARKS else len(MARKS) + int(name.split(".")[1])


def busy_us(ops, a: float, b: float, sym: str) -> float:
    """Busy us of ``ops`` within [a, b), marks left out."""
    return union_us([(max(s, a), min(s + d, b)) for n, s, d in ops
                     if n != sym and s < b and s + d > a])


def span_ms(view, first: int, last: int) -> Optional[float]:
    """Mean busy ms a request from the end of mark ``first`` to the start
    of mark ``last`` (negative counts from the end), marks left out."""
    per = marks(view)
    if per is None:
        return None
    sym = mark_symbol()
    total = sum(busy_us(ops, m[first][1], m[last][0], sym)
                for ops, m in zip(view.requests, per))
    return total / len(per) / 1e3


def counter_values() -> Optional[Dict[str, float]]:
    """The program's counters; None where it keeps none."""
    try:
        from far_tpu_torch.utils.prof import counters
    except ImportError:
        return None
    return counters() or None


def capture_s() -> Optional[float]:
    """Seconds of the compiled request's warm-up and capture, summed over
    its signatures."""
    c = counter_values()
    if c is None or "far.capture.warmup_s" not in c:
        return None
    return c["far.capture.warmup_s"] + c["far.capture.record_s"]


def round_nodes() -> Optional[float]:
    """The operation nodes (kernels, copies, memsets) of the captured
    solver rounds, their MoE fusion included, marks left out, summed over
    signatures."""
    c = counter_values()
    if c is None:
        return None
    found = [v for k, v in c.items() if k.startswith("far.capture.nodes.round.")]
    return sum(found) if found else None
