"""Device busy ms a request between the program's ``emm`` mark and its
last (h100bench/spans.py): every solver round with its MoE fusion."""

from h100bench import spans


def read(view):
    return spans.span_ms(view, spans.index("emm"), -1)
