"""Operations of a whole map-free request, from shapes.

What ``mfu.mapfree`` divides by the time, each counted once as
multiply-adds x 2: the matcher's backbone at its size
(``flops.backbone_flops``), the kernels' work (``kernels/K1`` .. ``K3``)
and the fine windows' merge projection; then, in each solver round, the
regressor whole, as the request runs it: the ResUNet over both images,
the correlation volume and the warp of f1 and of the grid, the head, the
transformer, the pose MLP and the MoE. The solver's work is left out, as
``flops.py`` leaves it out.
"""

from __future__ import annotations

from h100bench.flops import backbone_flops
from h100bench.trace import kernel_tables

FF = 2048     # the transformer's MLP width
HEAD = (64, 128, 256)


def _half(n: int) -> int:
    return -(-n // 2)


def resunet_flops(hw, blocks, out: int) -> float:
    """One image through the ResUNet: the stem at half the side, the
    bottleneck stages at a quarter, an eighth and a sixteenth (stride in
    each stage's first 3x3), the decoder back to a quarter."""
    H, W = _half(hw[0]), _half(hw[1])

    def conv(k, cin, cout, h, w):
        return 2 * k * k * cin * cout * h * w

    f = conv(7, 3, 64, H, W)
    h, w = _half(H), _half(W)
    sizes, cin = [], 64
    for planes, stride, n in zip((64, 128, 256), (1, 2, 2), blocks):
        for i in range(n):
            oh, ow = (_half(h), _half(w)) if stride == 2 and i == 0 else (h, w)
            f += conv(1, cin, planes, h, w) + conv(3, planes, planes, oh, ow) \
                + conv(1, planes, 4 * planes, oh, ow)
            if cin != 4 * planes or oh != h:
                f += conv(1, cin, 4 * planes, oh, ow)
            cin, h, w = 4 * planes, oh, ow
        sizes.append((h, w))
    h4, w4 = 2 * sizes[2][0], 2 * sizes[2][1]   # upconv4, at twice the last stage
    f += conv(3, 1024, 512, h4, w4) + conv(3, 1024, 512, h4, w4)
    h3, w3 = 2 * h4, 2 * w4
    f += conv(3, 512, 256, h3, w3) + conv(3, 512, 256, h3, w3) + conv(1, 256, out, h3, w3)
    return float(f)


def regressor_flops(sh: dict) -> float:
    """One pass of the regressor over B pairs, the MoE included."""
    B, hw, D = sh["B"], sh["reg_hw"], sh["reg_out"]
    f = 2 * B * resunet_flops(hw, sh["reg_blocks"], D)
    h, w = 4 * -(-_half(_half(hw[0])) // 4), 4 * -(-_half(_half(hw[1])) // 4)
    N = h * w
    f += 2 * B * N * N * (D + D + 2)               # f0 f1^T, the warp of f1 and of the grid
    cin = 2 * D + 3
    for planes in HEAD:                             # the head's stride-2 blocks
        h, w = _half(h), _half(w)
        f += 2 * B * h * w * (9 * cin * planes + 9 * planes * planes + cin * planes)
        cin = planes
    L, C = h * w, HEAD[-1]
    f += sh["reg_layers"] * 2 * B * (4 * L * C * C + 2 * L * L * C + 2 * L * C * FF)
    feat, hid = C * L, sh["reg_hidden"]
    f += 2 * B * (feat * hid + hid * hid + hid * 9)                  # pose MLP
    f += 2 * B * ((feat + 21) * hid + hid * hid + hid * 2)          # MoE
    return float(f)


def request_flops(sh: dict) -> float:
    """One map-free request of B pairs: the matcher once, the regressor in
    every round."""
    B, C, K, WW, Cf = sh["B"], sh["C"], sh["K"], sh["WW"], sh["Cf"]
    f = backbone_flops(2 * B, sh["image_hw"], sh["initial_dim"], sh["block_dims"])
    tables = kernel_tables()
    f += sum(tables[k].work(sh)[0] for k in ("K1", "K2", "K3"))
    f += 2 * B * K * 2 * (C * Cf + 2 * Cf * Cf + WW * Cf * Cf)     # fine merge
    return float(f + sh["rounds"] * regressor_flops(sh))
