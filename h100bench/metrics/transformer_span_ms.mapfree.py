"""Device busy ms a map-free request in the stages the program's
``round.<i>`` marks end, summed over rounds (h100bench/spans_mapfree.py):
the transformer, the pose MLP and the MoE blend."""

from h100bench import spans_mapfree


def read(view):
    return spans_mapfree.stage_ms(view, "round")
