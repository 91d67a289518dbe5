"""K3, the fine LoFTR stack over 5x5 windows (``csrc/fine_layer.cu``): a
self and a cross layer on both images' windows of every match, in one call.

Work a request: n = B K windows of WW tokens at width Cf, 4 layer
applications (two layers, two images), each 20 WW Cf^2 + 4 WW Cf d
operations a window; the windows read and written once, two layers'
weights read once.
"""

SYMBOLS = ("tc::fine_tc_kernel", "tf32::fine_tf32_kernel", "tf32::prep_weights_kernel",
           "anon::fine_kernel")


def call(n, WW, C, nhead, e):
    d = C // nhead
    return 4 * n * (20 * WW * C * C + 4 * WW * C * d), 4 * n * WW * C * e + 2 * 10 * C * C * e


def work(sh):
    return call(sh["B"] * sh["K"], sh["WW"], sh["Cf"], sh["Hf"], sh["e"])
