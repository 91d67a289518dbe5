"""Device busy ms a map-free SuperGlue request from the program's ``gnn``
mark to its ``sinkhorn`` mark (h100bench/spans_mapfree_sg.py): the
log-domain Sinkhorn over the 2,049 x 2,049 coupling and the mutual
selection."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.matcher_stage_ms(view, "sinkhorn")
