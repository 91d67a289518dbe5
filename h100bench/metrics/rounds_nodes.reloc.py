"""Operation nodes (kernels, copies, memsets) the capture recorded in the
solver rounds, their MoE fusion included, marks left out: the sum of the
program's counters ``far.capture.nodes.round.*`` (h100bench/spans.py).
A traced replay shows each as one device operation."""

from h100bench import spans


def read(view):
    return spans.round_nodes()
