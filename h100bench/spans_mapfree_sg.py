"""The marks and counters of the map-free request whose matcher is
SuperPoint + SuperGlue, as its per-layer readers take them.

The compiled request (``far_tpu_torch.pipeline.build_mapfree_fn`` over a
``SuperGlueMatcher``) holds, inside its CUDA graph, a device mark at the
request's start, at the end of each of the matcher's stages (``MARKS``:
both images' SuperPoint; the keypoint encoder, the GNN and the score
matrix; Sinkhorn and the selection) and at four points a solver round
(``ROUND``, as ``spans_mapfree.py``). So a traced request holds 4 + 4 x
rounds marks, in that order, and the stage a mark ends lies between it
and the mark before; the spans are read over the requests that hold
them all. Its capture writes counters under
``mapfree_sg.capture.*``. Busy time is ``spans.busy_us``'s: the union of
the device operations' intervals, marks left out. Where the program has
no marks (no mark module, or no trace event carries the mark's name) or
no counters, every function returns None.
"""

from __future__ import annotations

from typing import List, Optional

from h100bench.spans import Span, busy_us, counter_values, mark_symbol

# the device marks before the rounds': the request's start, then the end
# of the detections, the GNN and the transport
MARKS = ("request", "detect", "gnn", "sinkhorn")
# the marks of a round, in order
ROUND = ("solve", "encode", "volume", "round")
PREFIX = "mapfree_sg.capture."


def marks(view) -> Optional[List[Optional[List[Span]]]]:
    """Each traced request's device marks in order, None for a request
    the trace holds short of its marks (a mark timed outside the
    request's host span is in no request); None where no request holds
    one. Raises where no request holds 4 + 4 x rounds."""
    sym = mark_symbol()
    if sym is None:
        return None
    per = [[(s, s + d) for n, s, d in r if n == sym] for r in view.requests]
    if not any(per):
        return None
    want = len(MARKS) + len(ROUND) * view.shapes["rounds"]
    counts = [len(p) for p in per]
    if want not in counts:
        raise ValueError(f"device marks a traced request {counts}, not {want}")
    return [p if len(p) == want else None for p in per]


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
    whole = [(ops, m) for ops, m in zip(view.requests, per) if m is not None]
    total = sum(busy_us(ops, m[a][1], m[b][0], sym) for ops, m in whole for a, b in pairs)
    return total / len(whole) / 1e3


def matcher_stage_ms(view, name: str) -> Optional[float]:
    """One of the matcher's stages: from the mark before ``name`` to it."""
    return busy_ms(view, [(index(name) - 1, index(name))])


def stage_ms(view, kind: str) -> Optional[float]:
    """One of ``ROUND``'s stages, summed over rounds: from the mark before
    ``<kind>.<i>`` to it."""
    ends = [index(f"{kind}.{i}") for i in range(view.shapes["rounds"])]
    return busy_ms(view, [(e - 1, e) for e in ends])


def _counters() -> Optional[dict]:
    c = counter_values()
    return None if c is None or PREFIX + "warmup_s" not in c else c


def capture_s() -> Optional[float]:
    """Seconds of the request's warm-up and capture, summed over its
    signatures."""
    c = _counters()
    return None if c is None else c[PREFIX + "warmup_s"] + c[PREFIX + "record_s"]


def nodes(stage: str) -> Optional[float]:
    """The operation nodes (kernels, copies, memsets) the capture recorded
    in the stages named ``stage`` or ``stage.<i>``, marks left out, summed
    over rounds and signatures."""
    c = _counters()
    if c is None:
        return None
    key = PREFIX + "nodes." + stage
    found = [v for k, v in c.items() if k == key or k.startswith(key + ".")]
    return sum(found) if found else None
