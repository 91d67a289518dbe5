"""A map-free SuperGlue request's operations counted from shapes
(flops_mapfree_sg.request_flops) over its mean host time in the traced
part and the card's bf16 peak, in %."""

from h100bench.flops_mapfree_sg import request_flops
from h100bench.trace import PEAK_BF16


def read(view):
    return 100.0 * request_flops(view.shapes) / (view.request_s() * PEAK_BF16)
