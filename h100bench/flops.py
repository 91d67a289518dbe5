"""Operations of a whole FAR request, from shapes.

What ``mfu.*`` divides by the time: the backbone's convolutions, the
kernels' work (``kernels/K1`` .. ``K4``), the fine windows' merge
projection, the EMM's projections and MLP, and the regressor's MLPs, each
counted once as multiply-adds x 2. The solver's work (a few GFLOP on the
CUDA cores) is left out.
"""

from __future__ import annotations

from h100bench.trace import kernel_tables


def backbone_flops(n_images: int, hw, initial_dim: int, dims) -> float:
    """ResNet-FPN 8/2 over n images of hw pixels."""
    H, W = hw
    d0, d1, d2 = dims
    px = [H * W // 4 ** s for s in range(4)]  # pixels at 1, 1/2, 1/4, 1/8 of the side

    def conv(k, cin, cout, at):
        return 2 * k * k * cin * cout * px[at]

    f = conv(7, 1, initial_dim, 1)
    f += conv(3, initial_dim, d0, 1) + conv(3, d0, d0, 1) + 2 * conv(3, d0, d0, 1)
    f += conv(3, d0, d1, 2) + conv(3, d1, d1, 2) + conv(1, d0, d1, 2) + 2 * conv(3, d1, d1, 2)
    f += conv(3, d1, d2, 3) + conv(3, d2, d2, 3) + conv(1, d1, d2, 3) + 2 * conv(3, d2, d2, 3)
    f += conv(1, d2, d2, 3)
    f += conv(1, d1, d2, 2) + conv(3, d2, d2, 2) + conv(3, d2, d1, 2)
    f += conv(1, d0, d1, 1) + conv(3, d1, d1, 1) + conv(3, d1, d0, 1)
    return n_images * f


def request_flops(sh: dict) -> float:
    """One FAR inference request of B pairs."""
    B, L, C, K, WW, Cf = sh["B"], sh["L"], sh["C"], sh["K"], sh["WW"], sh["Cf"]
    H, D = sh["H_emm"], sh["D_emm"]
    Dv, hid = D + 6, sh["hidden"]
    f = backbone_flops(2 * B, sh["image_hw"], sh["initial_dim"], sh["block_dims"])
    tables = kernel_tables()
    f += sum(tables[k].work(sh)[0] for k in ("K1", "K2", "K3", "K4"))
    f += 2 * B * K * 2 * (C * Cf + 2 * Cf * Cf + WW * Cf * Cf)     # fine merge
    f += 2 * 2 * B * L * C * 3 * C                                  # EMM qkv
    f += 2 * 2 * B * H * Dv * Dv * C + 2 * B * 2 * Dv * 8 * C * C   # EMM projection, MLP
    feat = 2 * Dv * C
    f += 2 * B * (feat * hid + hid * hid * 2 + hid * 9)             # encoder, regressor
    f += sh["rounds"] * 2 * B * ((feat + 22) * hid + hid * hid + 2 * hid)  # MoE a round
    return float(f)

