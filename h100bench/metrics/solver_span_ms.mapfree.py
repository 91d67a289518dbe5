"""Device busy ms a map-free request in the stages the program's
``solve.<i>`` marks end, summed over rounds (h100bench/spans_mapfree.py):
each round's ``estimate_pose`` (8-point hypotheses, MAGSAC or prior
scoring, polish, cheirality)."""

from h100bench import spans_mapfree


def read(view):
    return spans_mapfree.stage_ms(view, "solve")
