"""Device busy ms a request between the program's ``coarse`` and ``match``
marks (h100bench/spans.py): K2, the top-k selection of matches and their
coordinates."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("coarse"), spans.index("match"))
