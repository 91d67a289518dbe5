"""Operation nodes (kernels, copies, memsets) the capture recorded in the
map-free request's ``estimate_pose`` stages, marks left out: the sum of
the program's counters ``mapfree.capture.nodes.solve.*``
(h100bench/spans_mapfree.py). A traced replay shows each as one device
operation."""

from h100bench import spans_mapfree


def read(view):
    return spans_mapfree.solver_nodes()
