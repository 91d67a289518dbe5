"""Seconds of the compiled map-free SuperGlue request's eager warm-up (to
its synchronize) and capture, from the program's counters
``mapfree_sg.capture.warmup_s`` and ``mapfree_sg.capture.record_s``
(h100bench/spans_mapfree_sg.py)."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.capture_s()
