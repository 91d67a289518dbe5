"""Each kernel file's operations and bytes at a shape counted by hand."""

import pytest

from h100bench.flops import backbone_flops
from h100bench.trace import kernel_tables, symbol

SHAPES = dict(B=1, L=2, C=4, nhead=2, n_coarse_layers=1, K=2, WW=4, Cf=8, Hf=2, H_emm=1,
              D_emm=2, e=2, rounds=1)


@pytest.mark.parametrize("kernel, flops, nbytes", [
    # 2 applications of (20 L C^2 + 4 L C d + 2 L C) = 640 + 64 + 16 operations;
    # 3 B L C bf16 activations (48 B) + 10 C^2 bf16 weights (320 B) + LN f32 (64 B)
    ("K1", 2 * 720, 2 * 432),
    # 2 B L S C at L = S = 2: 32; the tokens 2 B L C bf16 (32 B), 16 B a row (32 B)
    ("K2", 32, 32 + 32),
    # n = B K = 2 windows, 4 applications of 20 WW Cf^2 + 4 WW Cf d = 5120 + 512;
    # windows 4 n WW Cf bf16 (512 B) + 2 layers x 10 Cf^2 bf16 (2560 B)
    ("K3", 4 * 2 * 5632, 512 + 2560),
    # 2 calls of B H (2 L^2 D + 2 L^2 Dv + 2 L Dv^2), Dv = 8: 16 + 64 + 256;
    # q, k, v bf16 (2 * 12 * 2 = 48 B) + the f32 (8, 8) result (256 B)
    ("K4", 2 * 336, 2 * 304),
    # 8 sweeps x 36 rotations x 111 + 2 x (6 x 3 x 65 + 200); 4 B x (171 + 2 x 30) floats
    ("small_linalg", 31968 + 2 * 1370, 4 * 231),
])
def test_kernel_work(kernel, flops, nbytes):
    assert kernel_tables()[kernel].work(SHAPES) == (flops, nbytes)


def test_backbone_flops():
    # one 16x16 image, widths (2, 3, 4), stem 1 -> 2: every convolution of the
    # FPN 8/2 counted as 2 k^2 Cin Cout at its output's pixels
    px = [256, 64, 16, 4]
    c = lambda k, a, b, at: 2 * k * k * a * b * px[at]  # noqa: E731
    want = (c(7, 1, 2, 1) + 4 * c(3, 2, 2, 1)
            + c(3, 2, 3, 2) + 3 * c(3, 3, 3, 2) + c(1, 2, 3, 2)
            + c(3, 3, 4, 3) + 3 * c(3, 4, 4, 3) + c(1, 3, 4, 3) + c(1, 4, 4, 3)
            + c(1, 3, 4, 2) + c(3, 4, 4, 2) + c(3, 4, 3, 2)
            + c(1, 2, 3, 1) + c(3, 3, 3, 1) + c(3, 3, 2, 1))
    assert backbone_flops(1, (16, 16), 2, (2, 3, 4)) == want


def test_kernel_names_are_disjoint_and_symbols_parse():
    seen = {}
    for name, mod in kernel_tables().items():
        for s in mod.SYMBOLS:
            assert s not in seen, (s, name, seen.get(s))
            seen[s] = name
    assert symbol("void (anonymous namespace)::eigh_kernel<float>(float const*, int)") \
        == "anon::eigh_kernel"
    assert symbol("void tc::row_pass_kernel<256, 8>(Params)") == "tc::row_pass_kernel"
