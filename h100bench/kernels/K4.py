"""K4, the dual-softmax bilinear attention of the EMM regressor
(``csrc/bilinear_attention.cu``): v^T (softmax_rows(S) * softmax_cols(S)) v
with S = q k^T scaled, a (Dv, Dv) result for each pair and head.

Work a request: two calls (each image's queries over the other's keys),
each B H (2 L^2 D + 2 L^2 Dv + 2 L Dv^2) operations; q, k and v read once,
the float32 result written once.
"""

SYMBOLS = ("tc::main_kernel", "tc::row_stats_kernel", "tc::sum_partials_tc_kernel",
           "tf32::main_tf32_kernel", "tf32::row_stats_tf32_kernel",
           "anon::bilinear_tile_kernel", "anon::sum_partials_kernel")


def call(B, H, L, D, Dv, e):
    flops = B * H * (2 * L * L * D + 2 * L * L * Dv + 2 * L * Dv * Dv)
    return flops, B * H * L * (2 * D + Dv) * e + B * H * Dv * Dv * 4


def work(sh):
    f, b = call(sh["B"], sh["H_emm"], sh["L"], sh["D_emm"], sh["D_emm"] + 6, sh["e"])
    return 2 * f, 2 * b
