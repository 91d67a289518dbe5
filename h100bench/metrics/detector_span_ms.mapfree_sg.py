"""Device busy ms a map-free SuperGlue request from the program's
``request`` mark to its ``detect`` mark (h100bench/spans_mapfree_sg.py):
SuperPoint on both 720x544 images, its NMS, top-K and descriptor
sampling."""

from h100bench import spans_mapfree_sg


def read(view):
    return spans_mapfree_sg.matcher_stage_ms(view, "detect")
