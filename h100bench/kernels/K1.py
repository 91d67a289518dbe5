"""K1, the coarse LoFTR layer (``csrc/loftr_layer.cu``): linear attention,
merge, LayerNorms and the two-layer MLP of one layer application.

Work a request: every coarse layer runs once on each image's tokens, so
2 x layers applications over B x L rows. An application reads x and the
source (B L C each) and the six weights (10 C^2) and writes B L C;
operations: the q, k, v and merge projections (8 L C^2) and the MLP
(12 L C^2), the key-value summary and the message (4 L C d), the
normaliser (2 L C), a pair.
"""

SYMBOLS = ("tc::row_pass_kernel", "tc::kv_pass_kernel", "tc::kv_reduce_tc_kernel",
           "tf32::split_weights_kernel", "tf32::gemm_tf32_kernel", "anon::kv_partial_kernel",
           "anon::kv_reduce_kernel", "anon::msg_kernel", "anon::ln_kernel", "anon::gemm_kernel")


def application(B, L, C, nhead, e):
    """(operations, bytes) of one layer application."""
    d = C // nhead
    flops = B * (20 * L * C * C + 4 * L * C * d + 2 * L * C)
    nbytes = 3 * B * L * C * e + 10 * C * C * e + 4 * C * 4
    return flops, nbytes


def work(sh):
    f, b = application(sh["B"], sh["L"], sh["C"], sh["nhead"], sh["e"])
    n = 2 * sh["n_coarse_layers"]
    return n * f, n * b
