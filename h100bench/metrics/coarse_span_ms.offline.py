"""Device busy ms a request between the program's ``backbone`` and
``coarse`` marks (h100bench/spans.py): the position encoding, K1 x16 and
the glue around them."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("backbone"), spans.index("coarse"))
