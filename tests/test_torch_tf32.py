"""The float32 tensor-core routes' arithmetic (3xTF32) against the JAX package.

K1's, K3's and K4's float32 routes (``far_loftr_layer_tf32``,
``far_fine_transformer_tf32``, ``far_bilinear_dual_softmax_tf32``) compute
each product on the tensor cores as three TF32 products
(``far_tpu_torch/ops/tf32.py``). A CUDA kernel cannot run here, so these
tests hold the routes' arithmetic,
written out in plain torch with every tensor-core product through
``matmul_3xtf32``, against the JAX package's float32 references on the
CPU at the main path's widths, to the 1e-4 max|ref| that ``chip_smoke.py``
holds the kernels to on the card. Each test also reads the same
arithmetic with one TF32 pass per product (``matmul_tf32``), which the
float32 routes must not settle for: it misses that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from far_tpu.ops.bilinear_attention import bilinear_dual_softmax_reference
from far_tpu.ops.fine_layer import fine_transformer_reference
from far_tpu.ops.loftr_layer import fused_loftr_layer_reference
from far_tpu_torch.ops.bilinear_attention import kperm_columns
from far_tpu_torch.ops.loftr_layer import layer_norm
from far_tpu_torch.ops.tf32 import matmul_3xtf32, round_tf32, split_tf32
from tests.test_torch_kernels import to_port

torch.set_num_threads(2)
TOL_REL = 1e-4  # chip_smoke.py phase 3's float32 tolerance, of max|ref|


def matmul_tf32(a, b):
    """a @ b as one TF32 product (big.big only): what a single pass keeps."""
    return round_tf32(a) @ round_tf32(b)


def kperm_pos(k: int) -> int:
    """Where column k of a group of 8 lands in the TF32 fragments' K order
    (``kperm_pos`` in ``csrc/hopper.cuh``)."""
    return (k & 1) * 4 + (k >> 1)


# ---- rounding ----------------------------------------------------------------


def _rna_bits(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 element by element on the IEEE bits: keep the sign,
    round the 23-bit mantissa field to its top 10 bits, half away from
    zero (a carry may raise the exponent, up to inf); inf and NaN as they
    are."""
    out = []
    for u in x.astype(np.float32).view(np.uint32).tolist():
        sign, mag = u & 0x80000000, u & 0x7FFFFFFF
        if mag >= 0x7F800000:
            out.append(u)
            continue
        low = mag & 0x1FFF
        mag -= low
        if low >= 0x1000:
            mag += 0x2000
        out.append(sign | mag)
    return np.array(out, dtype=np.uint32).view(np.float32)


def _rna_value(x: float) -> float:
    """The same for a normal float32, by value: the nearest number with 11
    significant bits, half away from zero."""
    m, e = np.frexp(np.float64(x))
    r = np.floor(abs(m) * 2.0 ** 11 + 0.5) * np.sign(m)
    return float(np.ldexp(r, e - 11))


HAND_PICKED = np.array([
    0.0, -0.0, 1.0, -1.0, 1.5,
    1.0 + 2.0 ** -11,              # a tie: rounds away from zero, to 1 + 2^-10
    -(1.0 + 2.0 ** -11),           # the same tie, negative
    1.0 + 3 * 2.0 ** -11,          # a tie from an odd lower bit
    1.0 + 2.0 ** -11 - 2.0 ** -23,  # just below the tie: down to 1
    2.0 - 2.0 ** -23,              # all mantissa bits set: carries into the exponent
    -(2.0 - 2.0 ** -23),
    np.float32(3.4028235e38),      # the largest float32 carries to inf
    1e-40, -1e-40, 2.0 ** -149,    # subnormals
    np.float32(1.1754942e-38),     # the largest subnormal carries to the smallest normal
    np.inf, -np.inf, np.nan,
    np.pi, -np.e, 1e-30, 123456.789,
], dtype=np.float32)


def test_round_tf32_matches_the_bits_on_hand_picked_values():
    got = round_tf32(torch.from_numpy(HAND_PICKED)).numpy()
    want = _rna_bits(HAND_PICKED)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[5] == 1.0 + 2.0 ** -10 and got[6] == -(1.0 + 2.0 ** -10)
    assert got[8] == 1.0 and got[9] == 2.0 and got[11] == np.inf
    assert got[15] == np.float32(2.0 ** -126)
    assert np.isnan(got[18]) and got[16] == np.inf and got[17] == -np.inf


def test_round_tf32_matches_the_bits_and_the_value_on_random_floats():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4000) * np.exp(rng.uniform(-30, 30, 4000))).astype(np.float32)
    got = round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _rna_bits(x).view(np.uint32))
    np.testing.assert_array_equal(got, np.array([_rna_value(v) for v in x], np.float32))
    # 10 mantissa bits: the low 13 bits are clear, the error at most half an ulp of TF32
    assert not (got.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(got - x) <= 2.0 ** -11 * np.abs(x))


def test_split_tf32_keeps_22_bits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4000).astype(np.float32))
    big, small = split_tf32(x)
    assert torch.equal(big, round_tf32(big)) and torch.equal(small, round_tf32(small))
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())


# ---- 3xTF32 products -------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(64, 64, 72), (37, 256, 129), (8, 4800, 16)])
def test_matmul_3xtf32_within_float32_ulps(M, K, N):
    """Against the float64 product: each element within 4 float32 ulps
    times sqrt(K), the ulp taken of the terms' root sum of squares
    sqrt(sum_i (a_i b_i)^2), the size of a sum of K terms of random sign
    (float32 accumulation of K terms, plus the dropped small.small ~2^-22
    of each). One TF32 pass misses that bound by far (~2^13 / sqrt(K))."""
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    exact = a.double() @ b.double()
    rss = ((a.double() ** 2) @ (b.double() ** 2)).sqrt()
    ulps = 2.0 ** -24 * np.sqrt(K) * rss
    err3 = (matmul_3xtf32(a, b).double() - exact).abs()
    err1 = (matmul_tf32(a, b).double() - exact).abs()
    assert float((err3 / ulps).max()) <= 4.0
    assert float((err1 / ulps).max()) > 4.0 * 25


# ---- K4 in float32 -----------------------------------------------------------------


def k4_route(q, k, v, scale, mm):
    """far_bilinear_dual_softmax_tf32's arithmetic: S = q k^T; each row's
    softmax; P = softmax_r(S) exp(S - cmax) with the column max; G^T =
    P^T v; H = G / csum; F = H v. The products through ``mm``, the rest in
    float32."""
    s = mm(q, k.transpose(-1, -2)) * scale
    rows = torch.softmax(s, dim=-1)
    E = torch.exp(s - s.amax(dim=-2, keepdim=True))
    csum = E.sum(dim=-2, keepdim=True)
    gt = mm((rows * E).transpose(-1, -2), v)           # (M, Dv)
    h = (gt / csum.transpose(-1, -2)).transpose(-1, -2)  # (Dv, M)
    return mm(h, v)


@pytest.mark.parametrize("seed,N,std", [(0, 512, 1.0), (1, 300, 1.5)])
def test_k4_3xtf32_matches_the_jax_reference(seed, N, std):
    """The main path's widths (D = 64, Dv = 70, scale 64^-0.5) at N tokens;
    q and k of std ``std`` give logits of std ``std``^2 (``chip_smoke.py``
    phase 3 holds the kernel at std 1, unit-normal q and k). 3xTF32 within 1e-4 max|ref| of the JAX float32 reference; one TF32
    pass per product outside it (the logits' ~2^-11 error enters the
    exponentials directly)."""
    rng = np.random.default_rng(seed)
    B, H, D, Dv = 1, 2, 64, 70
    q, k = ((std * rng.standard_normal((B, H, N, D))).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, N, Dv)).astype(np.float32)
    ref = np.asarray(bilinear_dual_softmax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tol = TOL_REL * float(np.abs(ref).max())
    err3 = float(np.abs(k4_route(tq, tk, tv, D ** -0.5, matmul_3xtf32).numpy() - ref).max())
    err1 = float(np.abs(k4_route(tq, tk, tv, D ** -0.5, matmul_tf32).numpy() - ref).max())
    print(f"K4 N={N} std={std}: 3xTF32 {err3 / tol:.3f}, one pass {err1 / tol:.3f} "
          f"of 1e-4 max|ref|")
    assert err3 <= tol
    assert err1 > tol


def test_kperm_columns_is_the_fragment_order():
    """The float32 K4 route feeds P^T from its accumulators as TF32 A
    fragments: a thread holds accumulator columns 2(t%4) and 2(t%4) + 1 of
    a k8 step, and the fragment's K slots t%4 and t%4 + 4 take them as
    they lie, so slot p holds column (0 2 4 6 1 3 5 7)[p]. v^T, the B
    operand, comes in that order (``kperm_columns``), and the product is
    P^T v."""
    rng = np.random.default_rng(2)
    n = 40
    pt = torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n, 72)).astype(np.float32))
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    # the fragments' columns, thread by thread: slot t%4 <- 2(t%4), slot t%4 + 4 <- 2(t%4) + 1
    slots = [None] * 8
    for t4 in range(4):
        slots[t4], slots[t4 + 4] = 2 * t4, 2 * t4 + 1
    assert slots == order and all(order[kperm_pos(k)] == k for k in range(8))
    a = pt[:, [8 * g + order[p] for g in range(n // 8) for p in range(8)]]
    vt = kperm_columns(v.t().contiguous())
    for g in range(n // 8):
        for k in range(8):
            assert torch.equal(vt[:, 8 * g + kperm_pos(k)], v[8 * g + k])
    np.testing.assert_allclose((a @ vt.t()).numpy(), (pt @ v).numpy(), rtol=1e-5, atol=1e-5)


# ---- K1 in float32 ---------------------------------------------------------------


def _jax_params(rng, C):
    """A layer's weights in the JAX kernels' layout ((in, out) kernels)."""
    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def ln():
        return np.stack([1 + 0.05 * rng.standard_normal(C),
                         0.05 * rng.standard_normal(C)]).astype(np.float32)

    return {"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
            "w0x": w(C, 2 * C), "w0m": w(C, 2 * C), "w1": w(2 * C, C),
            "ln1": ln(), "ln2": ln()}


def k1_route(x, src, p, nhead, mm):
    """far_loftr_layer_tf32's arithmetic: the five dense products through
    ``mm`` (the tensor cores), with elu + 1, 1/S and relu applied to their
    accumulators; the per-head k^T v and q KV and the LayerNorms in float32
    (CUDA cores). ``p`` in the JAX layout."""
    B, L, C = x.shape
    n = src.shape[1]
    d = C // nhead
    w = {key: torch.from_numpy(val) for key, val in p.items()}
    q = (F.elu(mm(x, w["wq"])) + 1.0).reshape(B, L, nhead, d)
    k = (F.elu(mm(src, w["wk"])) + 1.0).reshape(B, n, nhead, d)
    v = (mm(src, w["wv"]) / n).reshape(B, n, nhead, d)
    kv = torch.einsum("nshd,nshv->nhdv", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
    msg = (torch.einsum("nlhd,nhdv->nlhv", q, kv) * z[..., None] * n).reshape(B, L, C)
    m = layer_norm(mm(msg, w["wm"]), w["ln1"][0], w["ln1"][1])
    y = torch.relu(mm(x, w["w0x"]) + mm(m, w["w0m"]))
    return x + layer_norm(mm(y, w["w1"]), w["ln2"][0], w["ln2"][1])


@pytest.mark.parametrize("seed,L,S", [(0, 96, 80), (1, 64, 130)])
def test_k1_3xtf32_matches_the_jax_reference(seed, L, S):
    """C = 256, 8 heads of 32 (the coarse stack's), x and src of unit
    std: 3xTF32 within 1e-4 max|ref| of the JAX float32 reference; one
    TF32 pass per dense product outside it."""
    rng = np.random.default_rng(seed)
    B, C, H = 2, 256, 8
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    src = rng.standard_normal((B, S, C)).astype(np.float32)
    p = _jax_params(rng, C)
    ref = np.asarray(fused_loftr_layer_reference(
        jnp.asarray(x), jnp.asarray(src), {k: jnp.asarray(v) for k, v in p.items()}, H))
    tx, ts = torch.from_numpy(x), torch.from_numpy(src)
    tol = TOL_REL * float(np.abs(ref).max())
    err3 = float(np.abs(k1_route(tx, ts, p, H, matmul_3xtf32).numpy() - ref).max())
    err1 = float(np.abs(k1_route(tx, ts, p, H, matmul_tf32).numpy() - ref).max())
    print(f"K1 L={L} S={S}: 3xTF32 {err3 / tol:.3f}, one pass {err1 / tol:.3f} "
          f"of 1e-4 max|ref|")
    assert err3 <= tol
    assert err1 > tol


# ---- K3 in float32 ---------------------------------------------------------------

ROWS_K3 = 64  # rows of a block's tile in far_fine_transformer_tf32


def k3_layer(x, src, p, nhead, s, mm):
    """One application of far_fine_transformer_tf32 on a (T, R, C) stack of
    tiles, each R rows of whole s-token windows (a trailing partial window
    of zero rows in each tile): the dense products through ``mm``, elu + 1,
    1/s and relu on their accumulators; per window and head k^T v, sum(k)
    and q KV in float32 (the CUDA cores); rows past the tile's last whole
    window get msg = 0; the LayerNorms in float32. ``p`` in the port's
    layout (torch Linear weights)."""
    T, R, C = x.shape
    d, wpb = C // nhead, R // s
    q = F.elu(mm(x, p["wq"].t())) + 1.0
    k = F.elu(mm(src, p["wk"].t())) + 1.0
    v = mm(src, p["wv"].t()) * (1.0 / s)
    win = lambda t: t[:, :wpb * s].reshape(T, wpb, s, nhead, d)
    kw, vw, qw = win(k), win(v), win(q)
    kv = torch.einsum("twshd,twshe->twhde", kw, vw)
    z = 1.0 / (torch.einsum("twshd,twhd->twsh", qw, kw.sum(dim=2)) + 1e-6)
    msg = torch.zeros_like(x)
    msg[:, :wpb * s] = (torch.einsum("twshd,twhde->twshe", qw, kv) * z[..., None]
                        * s).reshape(T, wpb * s, C)
    m = layer_norm(mm(msg, p["wm"].t()), p["ln1"][0], p["ln1"][1])
    w0 = p["w0"]
    y = torch.relu(mm(x, w0[:, :C].t()) + mm(m, w0[:, C:].t()))
    return x + layer_norm(mm(y, p["w1"].t()), p["ln2"][0], p["ln2"][1])


def k3_route(f0, f1, params, names, nhead, mm, rows=ROWS_K3):
    """far_fine_transformer_tf32's arithmetic on (n, s, C) windows: rows //
    s whole windows a tile of ``rows`` rows, zero rows after them, all four
    applications on the tiles (cross layers sequential), the windows cut
    back out. ``rows = s`` packs one window a tile and no zero row."""
    n, s, C = f0.shape
    wpb = rows // s
    nt = -(-n // wpb)

    def pack(f):
        t = torch.zeros(nt * wpb, s, C)
        t[:n] = f
        return torch.cat([t.reshape(nt, wpb * s, C), torch.zeros(nt, rows - wpb * s, C)], 1)

    x0, x1 = pack(f0), pack(f1)
    for name, p in zip(names, params):
        if name == "self":
            x0 = k3_layer(x0, x0, p, nhead, s, mm)
            x1 = k3_layer(x1, x1, p, nhead, s, mm)
        else:
            x0 = k3_layer(x0, x1, p, nhead, s, mm)
            x1 = k3_layer(x1, x0, p, nhead, s, mm)

    def unpack(x):
        return x[:, :wpb * s].reshape(nt * wpb, s, C)[:n]

    return unpack(x0), unpack(x1)


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 12)])
def test_k3_3xtf32_matches_the_jax_reference(seed, n):
    """The main path's fine stack (s = 25, C = 128, 8 heads of 16, self then
    cross) on n windows in 64-row tiles (odd n: the last tile holds one
    window and 39 zero rows): 3xTF32 within 1e-4 max|ref| of the JAX float32
    reference; one TF32 pass per dense product outside it."""
    rng = np.random.default_rng(seed)
    s, C, H = 25, 128, 8
    f0, f1 = (rng.standard_normal((n, s, C)).astype(np.float32) for _ in range(2))
    jp = [_jax_params(rng, C) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_reference(jnp.asarray(f0), jnp.asarray(f1),
                                        [{k: jnp.asarray(v) for k, v in p.items()} for p in jp],
                                        names, H)
    ref = np.concatenate([np.asarray(r0), np.asarray(r1)])
    tp = [to_port(p) for p in jp]
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    tol = TOL_REL * float(np.abs(ref).max())

    def err(mm):
        o0, o1 = k3_route(t0, t1, tp, names, H, mm)
        return float(np.abs(torch.cat([o0, o1]).numpy() - ref).max())

    err3, err1 = err(matmul_3xtf32), err(matmul_tf32)
    print(f"K3 n={n}: 3xTF32 {err3 / tol:.3f}, one pass {err1 / tol:.3f} of 1e-4 max|ref|")
    assert err3 <= tol
    assert err1 > tol


@pytest.mark.parametrize("s,H", [(25, 8), (20, 8), (49, 8), (22, 4)])
def test_k3_tiles_confine_each_window(s, H):
    """The 64-row tiles (64 // s whole windows, the rest zero rows) give the
    windows what one window a tile, with no zero row, gives: the window
    reductions and the zero rows never reach another window's rows."""
    rng = np.random.default_rng(s + H)
    n, C = 5, 128
    f0, f1 = (torch.from_numpy(rng.standard_normal((n, s, C)).astype(np.float32))
              for _ in range(2))
    tp = [to_port(_jax_params(rng, C)) for _ in range(2)]
    names = ("self", "cross")
    mm = lambda a, b: a @ b
    tiled = k3_route(f0, f1, tp, names, H, mm)
    alone = k3_route(f0, f1, tp, names, H, mm, rows=s)
    for a, b in zip(tiled, alone):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
