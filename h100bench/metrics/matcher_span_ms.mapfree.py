"""Device busy ms a map-free request from the program's ``request`` mark
to its ``fine`` mark (h100bench/spans_mapfree.py): the backbone at the
matcher's size, the coarse transformer (K1), the coarse match (K2) and
the fine stage (K3)."""

from h100bench import spans_mapfree


def read(view):
    return spans_mapfree.matcher_ms(view)
