"""Device busy ms a map-free SuperGlue request in the stages the
program's ``volume.<i>`` marks end, summed over rounds
(h100bench/spans_mapfree_sg.py): the correlation volume, its warp and
the DeepResBlock head, in round 0 only."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.stage_ms(view, "volume")
