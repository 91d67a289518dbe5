"""Device busy ms a map-free SuperGlue request in the stages the
program's ``solve.<i>`` marks end, summed over rounds
(h100bench/spans_mapfree_sg.py): each round's ``estimate_pose`` over
2,048 masked correspondences."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.stage_ms(view, "solve")
