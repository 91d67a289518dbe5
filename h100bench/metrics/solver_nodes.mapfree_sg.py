"""Operation nodes (kernels, copies, memsets) the capture recorded in the
map-free SuperGlue request's ``estimate_pose`` stages, marks left out:
the sum of the program's counters ``mapfree_sg.capture.nodes.solve.*``
(h100bench/spans_mapfree_sg.py). A traced replay shows each as one
device operation."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.nodes("solve")
