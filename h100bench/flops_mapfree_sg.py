"""Operations of a whole map-free SuperGlue request, from shapes.

What ``mfu.mapfree_sg`` divides by the time, each counted once as
multiply-adds x 2: SuperPoint's convolutions on both images of each pair
(the encoder at full, half, a quarter and an eighth of the side, the
detector and descriptor heads at an eighth); SuperGlue's keypoint encoder,
the 2 x layers attentional layers on both images (four projections, the
two attention products, the two-layer MLP), the final projections and
the score matrix; then the regressor's trunk once, with the MoE
(``flops_mapfree.regressor_flops``). NMS, the top-K, Sinkhorn, the
selection and the solver are left out, as ``flops.py`` leaves the
solver out: they move bytes, not products.
"""

from __future__ import annotations

from h100bench.flops_mapfree import regressor_flops

KENC = (3, 32, 64, 128, 256)  # the keypoint encoder's widths before D
HEAD = 256                    # the width of both heads' 3x3 convolution


def _conv(k, cin, cout, h, w):
    return 2 * k * k * cin * cout * h * w


def superpoint_flops(images: int, hw, channels) -> float:
    """SuperPoint's convolutions on ``images`` images of ``hw`` (H, W) and
    descriptor width ``channels``' D (channels = (c1, c2, c3, c4, D))."""
    H, W = hw
    c1, c2, c3, c4, D = channels
    f = _conv(3, 1, c1, H, W) + _conv(3, c1, c1, H, W)
    f += _conv(3, c1, c2, H // 2, W // 2) + _conv(3, c2, c2, H // 2, W // 2)
    f += _conv(3, c2, c3, H // 4, W // 4) + _conv(3, c3, c3, H // 4, W // 4)
    h, w = H // 8, W // 8
    f += _conv(3, c3, c4, h, w) + _conv(3, c4, c4, h, w)
    f += _conv(3, c4, HEAD, h, w) + _conv(1, HEAD, 65, h, w)
    f += _conv(3, c4, HEAD, h, w) + _conv(1, HEAD, D, h, w)
    return float(images * f)


def superglue_flops(B: int, K: int, D: int, layers: int) -> float:
    """SuperGlue's products for B pairs of K keypoints a side: the
    keypoint encoder, ``layers`` (self, cross) rounds, the final
    projections and the (K, K) scores."""
    widths = KENC + (D,)
    kenc = sum(2 * K * a * b for a, b in zip(widths[:-1], widths[1:]))
    layer = 20 * K * D * D + 4 * K * K * D   # q, k, v, merge; QK^T, AV; 2D->2D->D
    per_image = kenc + 2 * layers * layer + 2 * K * D * D
    return float(B * (2 * per_image + 2 * K * K * D))


def request_flops(sh: dict) -> float:
    """One map-free SuperGlue request of B pairs: the matcher once, the
    regressor's trunk once."""
    B = sh["B"]
    f = superpoint_flops(2 * B, sh["image_hw"], tuple(sh["channels"]) + (sh["D"],))
    f += superglue_flops(B, sh["K"], sh["D"], sh["layers"])
    return f + regressor_flops(sh)
