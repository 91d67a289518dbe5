"""Device busy ms a map-free SuperGlue request from the program's
``detect`` mark to its ``gnn`` mark (h100bench/spans_mapfree_sg.py): the
keypoint encoder, the 18 attentional layers over 2,048 keypoints a side,
the final projections and the score matrix."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.matcher_stage_ms(view, "gnn")
