"""Device busy ms a request between the program's ``match`` and ``fine``
marks (h100bench/spans.py): the window gather, K3, the soft-argmax and the
refined keypoints."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("match"), spans.index("fine"))
