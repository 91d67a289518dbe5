"""95th percentile (nearest rank) of every request's host time in the
window, from the copy of its images to the card until its R, t and gate
are read back."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
