"""Kernels launched a request after its last K4 launch (a count; copies
and memsets left out)."""

from h100bench.trace import COPIES


def read(view):
    parts = view.after_last("K4")
    if parts is None:
        return None
    return sum(sum(not n.startswith(COPIES) for n, _, _ in p) for p in parts) / len(parts)
