"""Device busy ms a map-free SuperGlue request in the stages the
program's ``encode.<i>`` marks end, summed over rounds
(h100bench/spans_mapfree_sg.py): the ResUNet over both regressor images,
in round 0 only (the later rounds' stages are empty)."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.stage_ms(view, "encode")
