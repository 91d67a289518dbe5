"""Device busy ms a request between the program's start mark and its
``backbone`` mark (h100bench/spans.py): the backbone, marks left out."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("request"), spans.index("backbone"))
