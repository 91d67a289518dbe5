"""Seconds of the compiled map-free request's eager warm-up (to its
synchronize) and capture, from the program's counters
``mapfree.capture.warmup_s`` and ``mapfree.capture.record_s``
(h100bench/spans_mapfree.py)."""

from h100bench import spans_mapfree


def read(view):
    return spans_mapfree.capture_s()
