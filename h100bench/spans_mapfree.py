"""The map-free request's own marks and counters, as its per-layer readers
take them.

The compiled map-free request (``far_tpu_torch.pipeline.build_mapfree_fn``)
holds, inside its CUDA graph, a device mark at the request's start, at
the end of each of the matcher's stages (``MARKS``) and at four points a
solver round (``ROUND``: after ``estimate_pose``, after the ResUNet on both
images, after the correlation volume and the head, after the transformer,
the pose MLP and the MoE). So a traced request holds 5 + 4 x rounds
marks, in that order, and the stage a mark ends lies between it and the
mark before. Its capture writes counters under ``mapfree.capture.*``.
Busy time is ``spans.busy_us``'s: the union of the device operations'
intervals, marks left out. Where the program has no marks (no mark
module, or no trace event carries the mark's name) or no counters, every
function returns None.
"""

from __future__ import annotations

from typing import List, Optional

from h100bench.spans import Span, busy_us, counter_values, mark_symbol

# the device marks before the rounds': the request's start, then the end
# of the backbone, the coarse transformer, the coarse match and the fine
# stage
MARKS = ("request", "backbone", "coarse", "match", "fine")
# the marks of a round, in order
ROUND = ("solve", "encode", "volume", "round")
PREFIX = "mapfree.capture."


def marks(view) -> Optional[List[List[Span]]]:
    """Each traced request's device marks in order; None where no request
    holds one. Raises where a request holds another number than 5 + 4 x
    rounds."""
    sym = mark_symbol()
    if sym is None:
        return None
    per = [[(s, s + d) for n, s, d in r if n == sym] for r in view.requests]
    if not any(per):
        return None
    want = len(MARKS) + len(ROUND) * view.shapes["rounds"]
    counts = [len(p) for p in per]
    if any(c != want for c in counts):
        raise ValueError(f"device marks a traced request {counts}, not {want}")
    return per


def index(name: str) -> int:
    """A mark's place: one of ``MARKS`` or ``<kind>.<i>``, kind in ``ROUND``."""
    if name in MARKS:
        return MARKS.index(name)
    kind, i = name.split(".")
    return len(MARKS) + len(ROUND) * int(i) + ROUND.index(kind)


def busy_ms(view, pairs) -> Optional[float]:
    """Mean busy ms a request over the spans from the end of mark ``a`` to
    the start of mark ``b``, for each (a, b) in ``pairs``, marks left out."""
    per = marks(view)
    if per is None:
        return None
    sym = mark_symbol()
    total = sum(busy_us(ops, m[a][1], m[b][0], sym)
                for ops, m in zip(view.requests, per) for a, b in pairs)
    return total / len(per) / 1e3


def matcher_ms(view) -> Optional[float]:
    """The matcher: from the request's start to the end of the fine stage."""
    return busy_ms(view, [(index("request"), index("fine"))])


def stage_ms(view, kind: str) -> Optional[float]:
    """One of ``ROUND``'s stages, summed over rounds: from the mark before
    ``<kind>.<i>`` to it."""
    ends = [index(f"{kind}.{i}") for i in range(view.shapes["rounds"])]
    return busy_ms(view, [(e - 1, e) for e in ends])


def capture_s() -> Optional[float]:
    """Seconds of the compiled map-free request's warm-up and capture,
    summed over its signatures."""
    c = counter_values()
    if c is None or PREFIX + "warmup_s" not in c:
        return None
    return c[PREFIX + "warmup_s"] + c[PREFIX + "record_s"]


def solver_nodes() -> Optional[float]:
    """The operation nodes (kernels, copies, memsets) of the captured
    ``estimate_pose`` stages, marks left out, summed over rounds and
    signatures."""
    c = counter_values()
    if c is None:
        return None
    found = [v for k, v in c.items() if k.startswith(PREFIX + "nodes.solve.")]
    return sum(found) if found else None
