"""Device busy ms a map-free SuperGlue request in the stages the
program's ``round.<i>`` marks end, summed over rounds
(h100bench/spans_mapfree_sg.py): the transformer and the pose MLP in
round 0, and the MoE blend in every round."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.stage_ms(view, "round")
