"""K1's share of its roofline: its least time at the card's peaks
(kernels/K1.py) over its device time a request, in %."""


def read(view):
    return view.roofline("K1")
