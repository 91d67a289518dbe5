"""Seconds of the compiled request's eager warm-up (to its synchronize)
and capture, from the program's counters ``far.capture.warmup_s`` and
``far.capture.record_s`` (h100bench/spans.py)."""

from h100bench import spans


def read(view):
    return spans.capture_s()
