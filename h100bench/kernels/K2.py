"""K2, the dual-softmax row and column reductions (``csrc/matching_kernel.cu``):
from the two images' coarse tokens, each row's best confidence and its
column, and each column's best, without the (L, S) matrix.

Work a request, one call: the similarity product (2 B L S C operations);
the tokens read once in bf16, the row values, indices and column maxima
written (4 + 8 + 4 bytes a row).
"""

SYMBOLS = ("tc::combine_conf_kernel", "tc::pass_kernel", "tc::combine_stats_kernel",
           "anon::row_combine_kernel", "anon::conf_tile_kernel", "anon::col_combine_kernel")


def call(B, L, S, C):
    return 2 * B * L * S * C, 2 * B * L * C * 2 + B * L * (4 + 8 + 4)


def work(sh):
    return call(sh["B"], sh["L"], sh["L"], sh["C"])
