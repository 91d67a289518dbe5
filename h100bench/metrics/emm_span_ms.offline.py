"""Device busy ms a request between the program's ``fine`` and ``emm``
marks (h100bench/spans.py): the EMM features, K4 x2 and their
projections."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("fine"), spans.index("emm"))
