"""K1's share of its roofline in the map-free request, at its 6,120
coarse tokens: its least time at the card's peaks (kernels/K1.py) over
its device time a request, in %."""


def read(view):
    return view.roofline("K1")
