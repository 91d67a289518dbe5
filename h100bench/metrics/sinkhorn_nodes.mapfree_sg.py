"""Operation nodes (kernels, copies, memsets) the capture recorded in the
map-free SuperGlue request's ``sinkhorn`` stage, marks left out: the
program's counter ``mapfree_sg.capture.nodes.sinkhorn``
(h100bench/spans_mapfree_sg.py)."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.nodes("sinkhorn")
