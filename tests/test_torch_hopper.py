"""The tensor-core routes of K1-K4 (far_tpu_torch/csrc): bfloat16, and
K1's, K3's and K4's float32 (3xTF32) routes.

On the CPU: what surrounds the kernels - the weight packs that K1's and
K3's wrappers take (they must equal the weights cast to the dtype, and a
layer's call must see a changed weight), K4's zero padding of q, k and v
(it must change nothing), and the arithmetic of the K2 and K3 routes
written out in plain torch: K2's log-domain reduction and K3's packing of
windows into 128-row tiles. On a card (marked ``cuda``; each test skips
without one): every route against its plain version at ragged shapes and
at every shape it is built for, and shapes outside each route's set.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hopper.py
"""

import json
import math

import numpy as np
import pytest
import torch

from far_tpu_torch.models.transformer import LoFTREncoderLayer
from far_tpu_torch.ops.bilinear_attention import (
    bilinear_dual_softmax,
    bilinear_dual_softmax_plain,
    pad_columns,
)
from far_tpu_torch.ops.fine_layer import (
    fine_transformer,
    fine_transformer_plain,
    pack_fine_params,
)
from far_tpu_torch.ops.loftr_layer import (
    WEIGHTS,
    layer_norm,
    loftr_layer,
    loftr_layer_plain,
    pack_params,
)
from far_tpu_torch.ops.matching_kernel import (
    dual_softmax_rowcol,
    dual_softmax_rowcol_plain,
)

torch.set_num_threads(2)


def _layer(seed, C=32, nhead=4):
    torch.manual_seed(seed)
    layer = LoFTREncoderLayer(C, nhead)
    with torch.no_grad():  # LayerNorm away from its (1, 0) init
        for norm in (layer.norm1, layer.norm2):
            norm.weight.add_(0.1 * torch.randn_like(norm.weight))
            norm.bias.add_(0.1 * torch.randn_like(norm.bias))
    return layer


def _x(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_round_trips_to_raw(dtype):
    layer = _layer(0)
    raw = layer.raw()
    pack = pack_params(raw, dtype)
    for k in WEIGHTS:
        assert pack[k].dtype == dtype and pack[k].is_contiguous()
        assert torch.equal(pack[k], raw[k].detach().to(dtype))
    for k in ("ln1", "ln2"):
        assert pack[k].dtype == torch.float32 and pack[k].is_contiguous()
        assert torch.equal(pack[k], raw[k].detach())
    # packing a pack copies nothing
    again = pack_params(pack, dtype)
    assert all(again[k].data_ptr() == pack[k].data_ptr() for k in pack)


# The layer keeps no pack: every call packs raw() anew (a pack kept per
# layer moved nothing on the card, PERF.md), so no call sees stale weights.


def test_pack_rebuilt_after_load_state_dict():
    layer, other = _layer(0), _layer(1)
    x = _x()
    layer(x, x)
    layer.load_state_dict(other.state_dict())
    after = pack_params(layer.raw(), torch.bfloat16)
    for k, v in other.raw().items():
        want = v.detach().to(torch.bfloat16 if k in WEIGHTS else torch.float32)
        assert torch.equal(after[k], want)
    np.testing.assert_array_equal(layer(x, x).detach().numpy(),
                                  other(x, x).detach().numpy())


def test_pack_rebuilt_after_in_place_change():
    layer = _layer(0)
    x = _x()
    before = layer(x, x).detach()
    with torch.no_grad():
        layer.norm2.bias.add_(1.0)
        layer.q_proj.weight.mul_(2.0)
    after = pack_params(layer.raw(), torch.float32)
    assert torch.equal(after["wq"], layer.q_proj.weight.detach())
    # the forward pass sees the new weights
    ref = loftr_layer_plain(x, x, layer.raw(), 4)
    out = layer(x, x).detach()
    np.testing.assert_array_equal(out.numpy(), ref.detach().numpy())
    assert not torch.equal(out, before)


def test_pack_of_inference_mode_parameters_is_never_stale():
    """Layers made under inference_mode (parameters with no version
    counter) run, and see an in-place change."""
    x = _x()
    with torch.inference_mode():
        layer = _layer(0)
        first = layer(x, x)
        layer.k_proj.weight.add_(1.0)
        second = layer(x, x)
        ref = loftr_layer_plain(x, x, layer.raw(), 4)
    np.testing.assert_array_equal(second.numpy(), ref.numpy())
    assert not torch.equal(second, first)


@pytest.mark.parametrize("N,Dv", [(40, 70), (33, 13), (24, 72)])
def test_pad_v_changes_nothing(N, Dv):
    rng = np.random.default_rng(N + Dv)
    q, k = (torch.from_numpy(rng.standard_normal((2, 4, N, 8)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 4, N, Dv)).astype(np.float32))
    vp = pad_columns(v, 72)
    assert vp.shape == (2, 4, N, 72)
    assert torch.equal(vp[..., :Dv], v) and not vp[..., Dv:].any()
    ref = bilinear_dual_softmax_plain(q, k, v, 8 ** -0.5)
    out = bilinear_dual_softmax_plain(q, k, vp, 8 ** -0.5)[..., :Dv, :Dv]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("D", [8, 32, 64])
def test_pad_qk_changes_nothing(D):
    """The bf16 route pads q and k to 64 columns: S, hence F, is the same."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 30, w)).astype(np.float32))
               for w in (D, D, D + 6))
    ref = bilinear_dual_softmax_plain(q, k, v, D ** -0.5)
    out = bilinear_dual_softmax_plain(pad_columns(q, 64), pad_columns(k, 64),
                                      pad_columns(v, 72), D ** -0.5)
    np.testing.assert_allclose(out[..., :D + 6, :D + 6].numpy(), ref.numpy(),
                               rtol=0, atol=1e-6)


# ---- K2's log-domain reduction -------------------------------------------

LOG2E = 1.4426950408889634


def _k2_log_domain(f0, f1, inv_temp, dtype=torch.float32):
    """The bf16 route's arithmetic in plain torch (``dtype``): x = s log2 e,
    alpha / beta the log2 of each row's / column's softmax denominator,
    t = (2x - alpha_i) - beta_j once per element; both maxima are taken
    over t and exponentiated last."""
    x = torch.einsum("blc,bsc->bls", f0.to(dtype), f1.to(dtype)) * (inv_temp * LOG2E)
    rm, cm = x.amax(2, keepdim=True), x.amax(1, keepdim=True)
    alpha = rm + torch.log2(torch.exp2(x - rm).sum(2, keepdim=True))
    beta = cm + torch.log2(torch.exp2(x - cm).sum(1, keepdim=True))
    t = (2 * x - alpha) - beta
    tmax, idx = t.max(dim=2)  # first index on ties
    return torch.exp2(tmax).float(), idx, torch.exp2(t.amax(dim=1)).float()


def _k2_inputs(seed, B=2, L=96, S=80, C=32):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, S, C)).astype(np.float32)
    pick = rng.integers(0, S, (B, L))
    f0 = np.take_along_axis(f1, pick[..., None], axis=1) \
        + 0.5 * rng.standard_normal((B, L, C)).astype(np.float32)
    scale = torch.tensor(C ** -0.5).to(torch.bfloat16)
    return ((torch.from_numpy(f0).to(torch.bfloat16) * scale),
            (torch.from_numpy(f1).to(torch.bfloat16) * scale))


@pytest.mark.parametrize("seed,L,S", [(0, 96, 80), (1, 64, 130), (2, 200, 200)])
def test_k2_log_domain_matches_plain(seed, L, S):
    """In float64 the reduction is the plain version's function to 2e-6
    of the largest value: the plain version's own float32 rounding reaches
    1.2e-6 there (10 ulp of 1.0) and 1.5e-6 relative on smaller values.
    In float32, the kernel's type,
    1e-5 relative: the exponent
    2x - alpha - beta reaches ~40, which f32 carries to ~2.4e-6 absolute,
    and conf = 2^t turns each such rounding into ~1.7e-6 relative."""
    f0, f1 = _k2_inputs(seed, L=L, S=S)
    prv, pri, pcm = dual_softmax_rowcol_plain(f0, f1, 10.0)
    rv, ri, cm = _k2_log_domain(f0, f1, 10.0, torch.float64)
    top = float(prv.abs().max())
    np.testing.assert_allclose(rv.numpy(), prv.numpy(), rtol=0, atol=2e-6 * top)
    np.testing.assert_allclose(cm.numpy(), pcm.numpy(), rtol=0, atol=2e-6 * top)
    rv32, ri, cm32 = _k2_log_domain(f0, f1, 10.0)
    np.testing.assert_allclose(rv32.numpy(), prv.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(cm32.numpy(), pcm.numpy(), rtol=1e-5, atol=0)
    # an index may differ only at a near-tie of the plain conf
    sim = torch.einsum("blc,bsc->bls", f0.float(), f1.float()) * 10.0
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    at = torch.gather(conf, 2, ri[..., None])[..., 0]
    diff = ri != pri
    np.testing.assert_allclose(at[diff].numpy(), prv[diff].numpy(), rtol=1e-5, atol=0)


def test_k2_log_domain_keeps_the_first_index_on_exact_ties():
    f0, f1 = _k2_inputs(3, L=40, S=24)
    f1[:, 17] = f1[:, 5]  # columns 5 and 17 equal: every conf of 17 equals that of 5
    f1[:, 20] = f1[:, 5]
    _, ri, _ = _k2_log_domain(f0, f1, 10.0)
    _, pri, _ = dual_softmax_rowcol_plain(f0, f1, 10.0)
    assert not bool(((ri == 17) | (ri == 20)).any())
    assert bool((ri == 5).any())
    np.testing.assert_array_equal(ri.numpy(), pri.numpy())


@pytest.mark.parametrize("seed", [0, 4])
def test_k2_log_domain_mutual_pairs_compare_equal(seed):
    """A match survives models/matching.py's test row_val >= col_max[idx]
    exactly when it is mutual: both sides are 2^t of the same float."""
    f0, f1 = _k2_inputs(seed, L=120, S=100)
    rv, ri, cm = _k2_log_domain(f0, f1, 10.0)
    rv_bits = rv.view(torch.int32)
    cm_at = torch.gather(cm, 1, ri)
    mutual = rv >= cm_at
    assert int(mutual.sum()) > 0.5 * rv.numel()
    np.testing.assert_array_equal(rv_bits[mutual].numpy(),
                                  cm_at.view(torch.int32)[mutual].numpy())
    # the plain version finds the same mutual rows, but where a column's two
    # best rows are a near-tie
    prv, pri, pcm = dual_softmax_rowcol_plain(f0, f1, 10.0)
    pmutual = prv >= torch.gather(pcm, 1, pri)
    other = mutual != pmutual
    gap = (prv - torch.gather(pcm, 1, pri)).abs() / prv
    if bool(other.any()):
        assert float(gap[other].max()) < 1e-5


# ---- K3's tile form --------------------------------------------------------


def _k3_tile_form(f0, f1, params, names, nhead):
    """The bf16 route's layout in plain torch (float32): windows of s tokens
    packed 128 // s to a 128-row tile with zero rows after them, attention
    per head as q_h k_h^T masked to the row's window (pad rows form windows
    of their own), the masked row sum as the denominator, then . v."""
    n, s, C = f0.shape
    wpb, d = 128 // s, C // nhead
    nt = -(-n // wpb)

    def pack(x):
        x = torch.cat([x, x.new_zeros(nt * wpb - n, s, C)]).reshape(nt, wpb * s, C)
        return torch.cat([x, x.new_zeros(nt, 128 - wpb * s, C)], dim=1)

    win = torch.arange(128) // s
    mask = (win[:, None] == win[None, :]).float()

    def layer(x, y, p):
        q = torch.nn.functional.elu(x @ p["wq"].t()) + 1
        k = torch.nn.functional.elu(y @ p["wk"].t()) + 1
        v = y @ p["wv"].t() / s
        msg = torch.empty_like(x)
        for h in range(nhead):
            sl = slice(h * d, (h + 1) * d)
            a = (q[..., sl] @ k[..., sl].transpose(1, 2)) * mask
            msg[..., sl] = (a @ v[..., sl]) / (a.sum(-1, keepdim=True) + 1e-6) * s
        ln1, ln2 = p["ln1"], p["ln2"]
        m = layer_norm(msg @ p["wm"].t(), ln1[0], ln1[1])
        yy = torch.relu(x @ p["w0"][:, :C].t() + m @ p["w0"][:, C:].t())
        return x + layer_norm(yy @ p["w1"].t(), ln2[0], ln2[1])

    x0, x1 = pack(f0), pack(f1)
    for name, p in zip(names, params):
        if name == "self":
            x0, x1 = layer(x0, x0, p), layer(x1, x1, p)
        else:
            x0 = layer(x0, x1, p)
            x1 = layer(x1, x0, p)

    def unpack(x):
        return x[:, :wpb * s].reshape(nt * wpb, s, C)[:n]

    return unpack(x0), unpack(x1)


def _fine_params(rng, C, n_layers=2):
    def w(o, i):
        return torch.from_numpy((rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32))

    def ln():
        return torch.from_numpy(np.stack([1 + 0.05 * rng.standard_normal(C),
                                          0.05 * rng.standard_normal(C)]).astype(np.float32))

    return [{"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
             "w0": w(2 * C, 2 * C), "w1": w(C, 2 * C), "ln1": ln(), "ln2": ln()}
            for _ in range(n_layers)]


@pytest.mark.parametrize("n,s,C,H", [(10, 25, 128, 8), (28, 9, 64, 4), (7, 25, 128, 8)])
def test_k3_tile_form_matches_plain(n, s, C, H):
    """Packing, window masks and zero pad rows change nothing (f32)."""
    rng = np.random.default_rng(n * s + C)
    f0, f1 = (torch.from_numpy(rng.standard_normal((n, s, C)).astype(np.float32))
              for _ in range(2))
    params = _fine_params(rng, C)
    names = ("self", "cross")
    o0, o1 = _k3_tile_form(f0, f1, params, names, H)
    r0, r1 = fine_transformer_plain(f0, f1, params, names, H)
    np.testing.assert_allclose(o0.numpy(), r0.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o1.numpy(), r1.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_fine_params_round_trips(dtype):
    C = 32
    params = _fine_params(np.random.default_rng(0), C, n_layers=3)
    w, ln = pack_fine_params(params, dtype)
    assert w.dtype == dtype and w.is_contiguous() and w.numel() == 3 * 10 * C * C
    assert ln.dtype == torch.float32 and ln.is_contiguous() and ln.numel() == 3 * 4 * C
    for li, p in enumerate(params):
        off = li * 10 * C * C
        for k in WEIGHTS:
            n = p[k].numel()
            assert torch.equal(w[off:off + n].reshape(p[k].shape), p[k].to(dtype)), k
            off += n
        lnl = ln[li * 4 * C:(li + 1) * 4 * C].reshape(4, C)
        assert torch.equal(lnl[:2], p["ln1"]) and torch.equal(lnl[2:], p["ln2"])
    # on CPU tensors the wrapper, given the pack, is the plain version
    rng = np.random.default_rng(1)
    f0, f1 = (torch.from_numpy(rng.standard_normal((3, 9, C)).astype(np.float32))
              for _ in range(2))
    out = fine_transformer(f0, f1, params, ("self", "cross", "self"), 4,
                           pack=pack_fine_params(params, torch.float32))
    ref = fine_transformer_plain(f0, f1, params, ("self", "cross", "self"), 4)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


# ---- on a card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(C, g, device):
    def w(o, i):
        return (torch.randn(o, i, generator=g) / math.sqrt(i)).to(device)

    def ln():
        return torch.stack([1 + 0.05 * torch.randn(C, generator=g),
                            0.05 * torch.randn(C, generator=g)]).to(device)

    return {"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
            "w0": w(2 * C, 2 * C), "w1": w(C, 2 * C), "ln1": ln(), "ln2": ln()}


K1_TC_SHAPES = [(C, C // dh) for C in (64, 128, 192, 256) for dh in (8, 16, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,C,H", [(1, 4800, 4800, 256, 8), (2, 1000, 1200, 256, 8),
                                       (1, 300, 200, 128, 8), (2, 130, 70, 64, 8)]
                         + [(2, 200, 150, C, H) for C, H in K1_TC_SHAPES])
def test_loftr_layer_bf16_route_on_card(card, B, L, S, C, H):
    """Tolerance 6e-2 max|ref|: the kernel rounds k, v, KV, q, msg, m, y
    and out to bf16 (2^-8 relative each); the f32 plain version does not."""
    g = torch.Generator().manual_seed(B * L + S + C + H)
    x = torch.randn(B, L, C, generator=g).to(card, torch.bfloat16)
    src = torch.randn(B, S, C, generator=g).to(card, torch.bfloat16)
    p = _params(C, g, card)
    ref = loftr_layer_plain(x.float(), src.float(), p, H)
    before = loftr_layer.launches_tc
    out = loftr_layer(x, src, pack_params(p, torch.bfloat16), H)
    torch.cuda.synchronize()
    assert loftr_layer.launches_tc == before + 1
    err = float((out.float() - ref).abs().max())
    assert err <= 6e-2 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,C,H", [(2, 300, 200, 32, 4), (1, 257, 130, 96, 4),
                                       (1, 64, 64, 32, 8)])
def test_loftr_layer_bf16_outside_the_set_takes_cuda_cores(card, B, L, S, C, H):
    """bf16 shapes the tensor-core route is not built for (C = 32, the
    guard's coarse stack; C = 96 with a head width of 24) run the
    CUDA-core kernel, chosen by the shape check: launches + 1,
    launches_tc unchanged, tolerance 6e-2 max|ref| as above."""
    g = torch.Generator().manual_seed(B * L + S + C + H)
    x = torch.randn(B, L, C, generator=g).to(card, torch.bfloat16)
    src = torch.randn(B, S, C, generator=g).to(card, torch.bfloat16)
    p = _params(C, g, card)
    ref = loftr_layer_plain(x.float(), src.float(), p, H)
    before, before_tc = loftr_layer.launches, loftr_layer.launches_tc
    out = loftr_layer(x, src, pack_params(p, torch.bfloat16), H)
    torch.cuda.synchronize()
    assert loftr_layer.launches == before + 1
    assert loftr_layer.launches_tc == before_tc
    err = float((out.float() - ref).abs().max())
    assert err <= 6e-2 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(1, 1000, 64), (1, 203, 64), (2, 300, 8),
                                   (1, 257, 16), (1, 130, 32)])
def test_bilinear_bf16_route_on_card(card, B, N, D):
    """Tolerance 1e-2 max|ref|: the kernel rounds P and H = G / csum to
    bf16 (2^-9 relative each, random in sign) before sums over N."""
    g = torch.Generator().manual_seed(N + D)
    q, k = (torch.randn(B, 4, N, D, generator=g).to(card, torch.bfloat16)
            for _ in range(2))
    v = torch.randn(B, 4, N, D + 6, generator=g).to(card, torch.bfloat16)
    scale = D ** -0.5
    ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), scale)
    before = bilinear_dual_softmax.launches_tc
    out = bilinear_dual_softmax(q, k, v, scale)
    torch.cuda.synchronize()
    assert bilinear_dual_softmax.launches_tc == before + 1
    assert out.shape == (B, 4, D + 6, D + 6)
    err = float((out - ref).abs().max())
    assert err <= 1e-2 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,Dv", [(1, 300, 128, 128), (2, 257, 64, 80),
                                      (1, 130, 96, 40)])
def test_bilinear_bf16_outside_the_set_takes_cuda_cores(card, B, N, D, Dv):
    """bf16 with D > 64 or Dv > 72 runs the CUDA-core kernel (launches_tc
    unchanged); it rounds P and H to bf16 as the tensor-core route does,
    so the tolerance is the same 1e-2 max|ref|."""
    g = torch.Generator().manual_seed(N + D + Dv)
    q, k = (torch.randn(B, 4, N, D, generator=g).to(card, torch.bfloat16)
            for _ in range(2))
    v = torch.randn(B, 4, N, Dv, generator=g).to(card, torch.bfloat16)
    scale = D ** -0.5
    ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), scale)
    before, before_tc = bilinear_dual_softmax.launches, bilinear_dual_softmax.launches_tc
    out = bilinear_dual_softmax(q, k, v, scale)
    torch.cuda.synchronize()
    assert bilinear_dual_softmax.launches == before + 1
    assert bilinear_dual_softmax.launches_tc == before_tc
    assert out.shape == (B, 4, Dv, Dv)
    err = float((out - ref).abs().max())
    assert err <= 1e-2 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,C", [(2, 4800, 4800, 256), (1, 1000, 1200, 256),
                                     (2, 192, 192, 32), (1, 300, 130, 64),
                                     (2, 257, 129, 128), (1, 129, 500, 192),
                                     (1, 1, 1, 256)])
def test_dual_softmax_bf16_route_on_card(card, B, L, S, C):
    """Tolerance 1e-6 + 1e-4 max|ref| (phase 3's): the route computes S in
    f32 on the tensor cores and the statistics in the log2 domain. Every
    row index equals the plain one or is a near-tie; mutual pairs compare
    equal bit for bit."""
    g = torch.Generator().manual_seed(L + S + C)
    f0 = torch.randn(B, L, C, generator=g)
    f1 = torch.randn(B, S, C, generator=g)
    m = min(L, S)
    f1[:, :m] = f0[:, torch.randperm(L, generator=g)[:m]] + 0.5 * f1[:, :m]
    sc = torch.tensor(C ** -0.5).to(torch.bfloat16)
    a = (f0.to(torch.bfloat16) * sc).to(card).contiguous()
    b = (f1.to(torch.bfloat16) * sc).to(card).contiguous()
    before = dual_softmax_rowcol.launches_tc
    rv, ri, cm = dual_softmax_rowcol(a, b, 10.0)
    torch.cuda.synchronize()
    assert dual_softmax_rowcol.launches_tc == before + 1
    prv, pri, pcm = dual_softmax_rowcol_plain(a, b, 10.0)
    tol = 1e-6 + 1e-4 * float(prv.abs().max())
    assert float((rv - prv).abs().max()) <= tol
    assert float((cm - pcm).abs().max()) <= tol
    sim = torch.einsum("blc,bsc->bls", a.float(), b.float()) * 10.0
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    assert float((prv - torch.gather(conf, 2, ri[..., None])[..., 0]).abs().max()) <= tol
    cm_at = torch.gather(cm, 1, ri)
    mutual = rv >= cm_at
    assert torch.equal(rv[mutual].view(torch.int32), cm_at[mutual].view(torch.int32))


K1_TF32_SHAPES = [(C, C // dh) for C in (128, 256) for dh in (8, 16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,C,H", [(1, 4800, 4800, 256, 8), (2, 1000, 1200, 256, 8),
                                       (2, 6120, 6120, 256, 8), (1, 1, 1, 256, 8)]
                         + [(2, 200, 150, C, H) for C, H in K1_TF32_SHAPES])
def test_loftr_layer_f32_tf32_route_on_card(card, B, L, S, C, H):
    """float32 on the 3xTF32 route (launches_tf32 + 1): each product keeps
    float32 accuracy, so the tolerance is phase 3's float32 1e-4 max|ref|
    against the plain version in strict float32 (TF32 off)."""
    g = torch.Generator().manual_seed(B * L + S + C + H)
    x = torch.randn(B, L, C, generator=g).to(card)
    src = torch.randn(B, S, C, generator=g).to(card)
    p = _params(C, g, card)
    ref = loftr_layer_plain(x, src, p, H)
    before = loftr_layer.launches_tf32
    out = loftr_layer(x, src, pack_params(p, torch.float32), H)
    torch.cuda.synchronize()
    assert loftr_layer.launches_tf32 == before + 1
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,D,Dv", [(2, 4, 4800, 64, 70), (1, 4, 1000, 64, 70),
                                        (4, 3, 576, 64, 70), (1, 2, 37, 16, 13),
                                        (1, 1, 130, 64, 72), (2, 4, 203, 8, 14)])
def test_bilinear_f32_tf32_route_on_card(card, B, H, N, D, Dv):
    """float32 on the 3xTF32 route (launches_tf32 + 1), 1e-4 max|ref|
    against the plain version in strict float32, deterministic run to run."""
    g = torch.Generator().manual_seed(N + D + Dv)
    q, k = (torch.randn(B, H, N, D, generator=g).to(card) for _ in range(2))
    v = torch.randn(B, H, N, Dv, generator=g).to(card)
    ref = bilinear_dual_softmax_plain(q, k, v, D ** -0.5)
    before = bilinear_dual_softmax.launches_tf32
    out = bilinear_dual_softmax(q, k, v, D ** -0.5)
    again = bilinear_dual_softmax(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert bilinear_dual_softmax.launches_tf32 == before + 2
    assert torch.equal(out, again)
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.cuda
def test_f32_outside_the_tf32_sets_takes_cuda_cores(card):
    """float32 shapes the 3xTF32 routes are not built for (K1 C = 32, the
    guard's coarse stack; K4 D = 128) run the CUDA-core kernels:
    launches + 1, launches_tf32 and launches_tc unchanged."""
    g = torch.Generator().manual_seed(5)
    x, src = (torch.randn(2, 300, 32, generator=g).to(card) for _ in range(2))
    p = _params(32, g, card)
    counts = (loftr_layer.launches, loftr_layer.launches_tc, loftr_layer.launches_tf32)
    out = loftr_layer(x, src, pack_params(p, torch.float32), 4)
    torch.cuda.synchronize()
    assert (loftr_layer.launches, loftr_layer.launches_tc, loftr_layer.launches_tf32) == (
        counts[0] + 1, counts[1], counts[2])
    ref = loftr_layer_plain(x, src, p, 4)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    q, k, v = (torch.randn(1, 2, 257, 128, generator=g).to(card) for _ in range(3))
    f = bilinear_dual_softmax
    counts = (f.launches, f.launches_tc, f.launches_tf32)
    out = f(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_tc, f.launches_tf32) == (counts[0] + 1, counts[1], counts[2])
    ref = bilinear_dual_softmax_plain(q, k, v, 128 ** -0.5)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


K3_TC_SHAPES = [(C, C // dh) for C in (64, 128) for dh in (16, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,C,H", [(2051, 25, 128, 8), (7, 25, 128, 8), (1, 25, 128, 8)]
                         + [(23, s, C, H) for C, H in K3_TC_SHAPES for s in (9, 25, 49)])
def test_fine_transformer_bf16_route_on_card(card, n, s, C, H):
    """Tolerance 6e-2 max|ref|: the kernel rounds k, v, q, S, msg, m, y and
    x to bf16 at each of its four layer applications; the plain f32 version
    does not."""
    g = torch.Generator().manual_seed(n + s + C + H)
    x0, x1 = (torch.randn(n, s, C, generator=g).to(card) for _ in range(2))
    p = [_params(C, g, card) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_plain(x0, x1, p, names, H)
    before = fine_transformer.launches_tc
    o0, o1 = fine_transformer(x0.to(torch.bfloat16), x1.to(torch.bfloat16), p, names, H,
                              pack=pack_fine_params(p, torch.bfloat16))
    torch.cuda.synchronize()
    assert fine_transformer.launches_tc == before + 1
    tol = 6e-2 * float(max(r0.abs().max(), r1.abs().max()))
    assert float(max((o0.float() - r0).abs().max(), (o1.float() - r1).abs().max())) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,C,H", [(9, 25, 32, 4), (5, 9, 192, 8), (4, 81, 32, 4),
                                     (5, 25, 128, 16), (5, 25, 192, 8), (3, 25, 256, 8),
                                     (3, 81, 128, 8)])
def test_fine_transformer_bf16_outside_the_set_takes_cuda_cores(card, n, s, C, H):
    """bf16 shapes the tensor-core route is not built for (C = 32, 192 or
    256, a head width of 8 or 24, s = 81) run the CUDA-core kernel, chosen
    by the explicit shape check; it keeps 1 window a block where 2 exceed
    the card's shared memory (C >= 192 at s = 25, C = 128 at s = 81)."""
    g = torch.Generator().manual_seed(n + C)
    x0, x1 = (torch.randn(n, s, C, generator=g).to(card) for _ in range(2))
    p = [_params(C, g, card) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_plain(x0, x1, p, names, H)
    before, before_tc = fine_transformer.launches, fine_transformer.launches_tc
    o0, o1 = fine_transformer(x0.to(torch.bfloat16), x1.to(torch.bfloat16), p, names, H)
    torch.cuda.synchronize()
    assert fine_transformer.launches == before + 1
    assert fine_transformer.launches_tc == before_tc
    tol = 6e-2 * float(max(r0.abs().max(), r1.abs().max()))
    assert float(max((o0.float() - r0).abs().max(), (o1.float() - r1).abs().max())) <= tol


K3_TF32_SHAPES = [(16, s) for s in (22, 25, 49, 64)] + [(32, s) for s in (22, 25, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,C,H", [(2048, 25, 128, 8), (2051, 25, 128, 8), (7, 25, 128, 8),
                                     (1, 25, 128, 8)]
                         + [(23, s, 128, 128 // dh) for dh, s in K3_TF32_SHAPES])
def test_fine_transformer_f32_tf32_route_on_card(card, n, s, C, H):
    """float32 on the 3xTF32 route (launches_tf32 + 1) at the main shape
    (B=2: 2048 windows of 25 tokens, C=128, 8 heads), ragged window counts
    and every head width and window count a block it is built for: 1e-4
    max|ref| against the plain version in strict float32, the same bits
    run to run."""
    g = torch.Generator().manual_seed(n + s + H)
    x0, x1 = (torch.randn(n, s, C, generator=g).to(card) for _ in range(2))
    p = [_params(C, g, card) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_plain(x0, x1, p, names, H)
    before = (fine_transformer.launches_tc, fine_transformer.launches_tf32)
    o0, o1 = fine_transformer(x0, x1, p, names, H, pack=pack_fine_params(p, torch.float32))
    a0, a1 = fine_transformer(x0, x1, p, names, H)
    torch.cuda.synchronize()
    assert (fine_transformer.launches_tc, fine_transformer.launches_tf32) == (
        before[0], before[1] + 2)
    assert torch.equal(o0, a0) and torch.equal(o1, a1)
    tol = 1e-4 * float(max(r0.abs().max(), r1.abs().max()))
    assert float(max((o0 - r0).abs().max(), (o1 - r1).abs().max())) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,C,H", [(5, 25, 256, 8), (3, 81, 128, 8), (5, 25, 128, 16),
                                     (4, 25, 128, 2), (9, 25, 32, 4), (6, 9, 128, 8),
                                     (5, 21, 128, 8), (5, 21, 128, 4)])
def test_fine_transformer_f32_outside_the_tf32_set_takes_cuda_cores(card, n, s, C, H):
    """float32 shapes the 3xTF32 route is not built for (C = 256 or 32, s =
    81, a head width of 8 or 64, s <= 21: more than 2 windows a block,
    which would not leave their KV room in shared memory) run the CUDA-core
    kernel: launches + 1, launches_tc and launches_tf32 unchanged, 1e-4
    max|ref|."""
    g = torch.Generator().manual_seed(n * s + C + H)
    x0, x1 = (torch.randn(n, s, C, generator=g).to(card) for _ in range(2))
    p = [_params(C, g, card) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_plain(x0, x1, p, names, H)
    f = fine_transformer
    counts = (f.launches, f.launches_tc, f.launches_tf32)
    o0, o1 = f(x0, x1, p, names, H)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_tc, f.launches_tf32) == (counts[0] + 1, counts[1], counts[2])
    tol = 1e-4 * float(max(r0.abs().max(), r1.abs().max()))
    assert float(max((o0 - r0).abs().max(), (o1 - r1).abs().max())) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,C,H", [(7, 25, 128, 8), (5, 25, 256, 8), (4, 25, 192, 8),
                                     (3, 81, 128, 8)])
def test_fine_transformer_f32_every_window_size(card, n, s, C, H):
    """float32 at every block width: 2 windows a block at the main shape
    (the 3xTF32 route), 1 where 2 do not fit in the CUDA-core kernel
    (C >= 192 at s = 25, s = 81): tolerance 1e-4 max|ref|."""
    g = torch.Generator().manual_seed(n * s + C)
    x0, x1 = (torch.randn(n, s, C, generator=g).to(card) for _ in range(2))
    p = [_params(C, g, card) for _ in range(2)]
    names = ("self", "cross")
    r0, r1 = fine_transformer_plain(x0, x1, p, names, H)
    before, before_tc = fine_transformer.launches, fine_transformer.launches_tc
    o0, o1 = fine_transformer(x0, x1, p, names, H)
    torch.cuda.synchronize()
    assert fine_transformer.launches == before + 1
    assert fine_transformer.launches_tc == before_tc
    tol = 1e-4 * float(max(r0.abs().max(), r1.abs().max()))
    assert float(max((o0 - r0).abs().max(), (o1 - r1).abs().max())) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bare_wrappers_refuse_grad_and_auto_forms_train(card, dtype):
    """A bare K1, K3 or K4 wrapper on CUDA inputs that require grad raises
    in grad mode (its output would have no grad_fn), runs under no_grad,
    and its ``*_auto`` Function gives every input a gradient."""
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_auto
    from far_tpu_torch.ops.fine_layer import fine_transformer_auto
    from far_tpu_torch.ops.loftr_layer import loftr_layer_auto

    g = torch.Generator().manual_seed(5)
    x, src = (torch.randn(2, 96, 64, generator=g).to(card, dtype) for _ in range(2))
    q, k = (torch.randn(2, 4, 96, 32, generator=g).to(card, dtype) for _ in range(2))
    v = torch.randn(2, 4, 96, 38, generator=g).to(card, dtype)
    w0, w1 = (torch.randn(6, 25, 64, generator=g).to(card, dtype) for _ in range(2))
    p = _params(64, g, card)
    fp = [_params(64, g, card) for _ in range(2)]
    names = ("self", "cross")
    calls = {
        "loftr_layer": (lambda a, b: loftr_layer(a, b, p, 8),
                        lambda a, b: loftr_layer_auto(a, b, p, 8), (x, src)),
        "bilinear_dual_softmax": (lambda *a: bilinear_dual_softmax(*a, 0.2),
                                  lambda *a: bilinear_dual_softmax_auto(*a, 0.2), (q, k, v)),
        "fine_transformer": (lambda a, b: fine_transformer(a, b, fp, names, 8)[0],
                             lambda a, b: fine_transformer_auto(a, b, fp, names, 8)[0],
                             (w0, w1)),
    }
    for what, (bare, auto, inputs) in calls.items():
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        with pytest.raises(RuntimeError, match=f"{what}_auto"):
            bare(*leaves)
        with torch.no_grad():
            assert bare(*leaves).grad_fn is None
        auto(*leaves).float().sum().backward()
        torch.cuda.synchronize()
        for t in leaves:
            assert t.grad is not None and bool(torch.isfinite(t.grad).all()), what


# ---- the shapes of the ViTEss and map-free paths -------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loftr_layer_at_mapfree_tokens(card, dtype):
    """K1 at L = S = 6120, the coarse tokens of a 720x544 map-free matcher
    image (90x68; 6120 is not a multiple of 64), C = 256, 8 heads: f32 on
    the CUDA cores to 1e-4 max|ref|, bf16 on the tensor cores to 6e-2."""
    g = torch.Generator().manual_seed(6120)
    x, src = (torch.randn(2, 6120, 256, generator=g).to(card, dtype) for _ in range(2))
    p = _params(256, g, card)
    ref = loftr_layer_plain(x.float(), src.float(), p, 8)
    before = loftr_layer.launches_tc
    out = loftr_layer(x, src, pack_params(p, dtype), 8)
    torch.cuda.synchronize()
    assert loftr_layer.launches_tc == before + (dtype == torch.bfloat16)
    tol = (1e-4 if dtype == torch.float32 else 6e-2) * float(ref.abs().max())
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_softmax_at_mapfree_tokens(card, dtype):
    """K2 at 6120 x 6120, C = 256: bf16 inputs on the tensor-core route,
    f32 inputs on the CUDA cores; tolerance 1e-6 + 1e-4 max|ref|, every
    row index the plain one's or a near-tie."""
    g = torch.Generator().manual_seed(6121)
    f0 = torch.randn(2, 6120, 256, generator=g)
    f1 = f0[:, torch.randperm(6120, generator=g)] + 0.5 * torch.randn(2, 6120, 256,
                                                                      generator=g)
    sc = 256 ** -0.5
    a, b = ((f * sc).to(dtype).to(card).contiguous() for f in (f0, f1))
    before, before_tc = dual_softmax_rowcol.launches, dual_softmax_rowcol.launches_tc
    rv, ri, cm = dual_softmax_rowcol(a, b, 10.0)
    torch.cuda.synchronize()
    assert dual_softmax_rowcol.launches == before + 1
    assert dual_softmax_rowcol.launches_tc == before_tc + (dtype == torch.bfloat16)
    prv, _, pcm = dual_softmax_rowcol_plain(a, b, 10.0)
    tol = 1e-6 + 1e-4 * float(prv.abs().max())
    assert float((rv - prv).abs().max()) <= tol
    assert float((cm - pcm).abs().max()) <= tol
    sim = torch.einsum("blc,bsc->bls", a.float(), b.float()) * 10.0
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    assert float((prv - torch.gather(conf, 2, ri[..., None])[..., 0]).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_at_vitess_tokens(card, dtype):
    """K4 as ViTEss's CrossBlock runs it: B = 4, 3 heads, N = 24 x 24 = 576,
    D = 64, Dv = 70 (v padded to 72 on the tensor-core route); f32 on the
    CUDA cores to 1e-4 max|ref|, bf16 on the tensor cores to 1e-2."""
    g = torch.Generator().manual_seed(576)
    q, k = (torch.randn(4, 3, 576, 64, generator=g).to(card, dtype) for _ in range(2))
    v = torch.randn(4, 3, 576, 70, generator=g).to(card, dtype)
    ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), 0.125)
    before = bilinear_dual_softmax.launches_tc
    out = bilinear_dual_softmax(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert bilinear_dual_softmax.launches_tc == before + (dtype == torch.bfloat16)
    assert out.shape == (4, 3, 70, 70)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_auto_at_vitess_train_shape(card, dtype):
    """K4 as a ViTEss training step runs it, B = 6 (the interiornet
    preset's batch), 3 heads, N = 576, D = 64, Dv = 70: the wrapper against
    the plain version (f32 1e-4 max|ref|, bf16 1e-2), and
    bilinear_dual_softmax_auto's output equal to the wrapper's with its
    gradients within 1e-5 max|ref| of autograd through the plain version
    (what its backward recomputes below N = 1024) on the card."""
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_auto

    g = torch.Generator().manual_seed(6576)
    q, k = (torch.randn(6, 3, 576, 64, generator=g).to(card, dtype) for _ in range(2))
    v = torch.randn(6, 3, 576, 70, generator=g).to(card, dtype)
    cot = torch.randn(6, 3, 70, 70, generator=g).to(card)
    ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), 0.125)
    before = bilinear_dual_softmax.launches_tc
    out = bilinear_dual_softmax(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert bilinear_dual_softmax.launches_tc == before + (dtype == torch.bfloat16)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = bilinear_dual_softmax_auto(*leaves, 0.125)
    assert torch.equal(auto.detach(), out)
    grads = torch.autograd.grad(auto, leaves, cot)
    refs = torch.autograd.grad(bilinear_dual_softmax_plain(*leaves, 0.125), leaves, cot)
    for a, b in zip(grads, refs):
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * float(b.float().abs().max())


@pytest.mark.cuda
def test_small_vitess_step_card_vs_cpu(card):
    """One gated ViTEssTrainer forward and backward at the CPU tests' small
    widths (dim 48, depth 2, 64x64, B=2, f32, TF32 off) on the card
    against the CPU from the same weights and batch: the metrics within
    1e-4 relative, every gradient within 1e-3 max|g_cpu| past the trunk and
    3e-2 in the ResNet18 trunk and the RAFT block, where float32 does not
    fix the gradient more closely (test_torch_family_train.py measures the
    port's CPU float32 gradient there 1.0e-3 from float64 and JAX's
    1.9e-2; card vs CPU read 2.2e-3 of max|g_cpu| on
    resnet.layer1.0.conv2); the RAFT block's convolution biases, which
    feed a train-mode BatchNorm and whose exact gradient is 0, against
    their weight's max|g_cpu|; the BatchNorm statistics within 1e-5
    relative, and K4 launched twice on the card."""
    from far_tpu_torch.data.synthetic import SolverPoseDataset, SyntheticPairDataset
    from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
    from far_tpu_torch.train.family_trainers import ViTEssTrainer, collate_vitess

    cfg = ViTEssConfig(dim=48, depth=2, num_heads=3, fc_hidden=64, use_loftr_gating=True,
                       dtype="float32")
    ds = SolverPoseDataset(SyntheticPairDataset(n=2, hw=(64, 64), seed=1))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {}
        for device in (card, torch.device("cpu")):
            tr = ViTEssTrainer(cfg, device=device).init(seed=2)
            before = bilinear_dual_softmax.launches
            loss, metrics = tr.loss(collate_vitess([ds[0], ds[1]], device))
            loss.backward()
            res[device.type] = (
                {k: float(v.detach()) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in tr.model.named_parameters() if p.grad is not None},
                {n: v.cpu() for n, v in tr.model.state_dict().items()
                 if n.endswith(("running_mean", "running_var"))},
                bilinear_dual_softmax.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (m, g, s, launched), (m_ref, g_ref, s_ref, _) = res["cuda"], res["cpu"]
    assert launched == 2 and g.keys() == g_ref.keys()
    for k, v in m_ref.items():
        assert abs(m[k] - v) <= 1e-4 * abs(v), k
    for n, ref in g_ref.items():
        trunk = n.startswith(("resnet.", "extractor_final_conv."))
        scale = g_ref[n[:-4] + "weight"] if n in ViTEss.BIAS_BEFORE_BN else ref
        tol = 3e-2 if trunk else 1e-3
        assert float((g[n] - ref).abs().max()) <= tol * float(scale.abs().max()), n
    for n, ref in s_ref.items():
        assert float((s[n] - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), n


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 2051])
@pytest.mark.parametrize("n", [3, 4, 9])
def test_eigh_small_on_card(card, B, n):
    """far_eigh_small against torch.linalg.eigh on X^T X of Gaussian 20 x n:
    eigenvalues within 1e-5 max|lambda|; eigenvector k up to sign within
    1e-5 + 64 u max|lambda| / gap_k (u = 2^-24, first-order perturbation
    with room for both solvers' float32 rounding); one launch."""
    from far_tpu_torch.ops.small_linalg import eigh_small

    g = torch.Generator().manual_seed(B * 10 + n)
    X = torch.randn(B, 20, n, generator=g)
    A = (X.transpose(1, 2) @ X).to(card)
    before = eigh_small.launches
    w, V = eigh_small(A)
    w0, V0 = torch.linalg.eigh(A)
    torch.cuda.synchronize()
    assert eigh_small.launches == before + 1
    scale = w0.abs().amax(-1, keepdim=True)
    assert float(((w - w0).abs() / scale).max()) <= 1e-5
    gaps = torch.full_like(w0, float("inf"))
    gaps[..., 1:] = w0.diff(dim=-1)
    gaps[..., :-1] = torch.minimum(gaps[..., :-1], w0.diff(dim=-1))
    tol = 1e-5 + 64 * 2.0 ** -24 * scale / gaps
    d = torch.minimum((V - V0).abs().amax(-2), (V + V0).abs().amax(-2))
    assert bool((d <= tol).all()), float((d / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 2051])
def test_svd3_on_card(card, B):
    """far_svd3 against torch.linalg.svd on 3x3 matrices of singular values
    (1, [0.3, 1], [0, 1e-3]), the polish's kind: singular values
    descending within 1e-5 max S; the rank-2 projection (U diag(s1, s2,
    0)) Vh and the essential projection U diag(1, 1, 0) Vh within 1e-5
    max|ref|; one launch."""
    from far_tpu_torch.ops.small_linalg import svd3

    g = torch.Generator().manual_seed(B)
    Q1 = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))[0]
    Q2 = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))[0]
    sv = torch.stack([torch.ones(B), 0.3 + 0.7 * torch.rand(B, generator=g),
                      1e-3 * torch.rand(B, generator=g)], -1)
    F = ((Q1 * sv[:, None, :]) @ Q2).to(card)
    before = svd3.launches
    U, S, Vh = svd3(F)
    U0, S0, V0 = torch.linalg.svd(F)
    torch.cuda.synchronize()
    assert svd3.launches == before + 1
    assert bool((S[:, :-1] >= S[:, 1:]).all())
    assert float((S - S0).abs().max()) <= 1e-5 * float(S0.max())
    ess = torch.tensor([1.0, 1.0, 0.0], device=card)
    for a, b in (((U * (S * ess)[:, None, :]) @ Vh, (U0 * (S0 * ess)[:, None, :]) @ V0),
                 ((U * ess) @ Vh, (U0 * ess) @ V0)):
        err = (a - b).abs().amax((-2, -1)) / b.abs().amax((-2, -1))
        assert float(err.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1e-2, 1e-3])
def test_svd3_nearly_rank1_on_card(card, ratio):
    """far_svd3 on 2051 3x3 F of singular values (1, ratio, 0) against
    torch.linalg.svd in float64 of the same float32 F: singular values
    within 1e-5 max S; the rank-2 projection within 1e-5 max|ref|; the
    essential projection within 1e-5 + 8 u s1 / (s2 - s3) of max|ref| (u
    = 2^-24; u2, v2 are only that well determined in float32)."""
    from far_tpu_torch.ops.small_linalg import svd3

    g = torch.Generator().manual_seed(int(1 / ratio))
    Q1, Q2 = (torch.linalg.qr(torch.randn(2051, 3, 3, generator=g, dtype=torch.float64))[0]
              for _ in range(2))
    F = ((Q1 * torch.tensor([1.0, ratio, 0.0], dtype=torch.float64)) @ Q2).float().to(card)
    U, S, Vh = svd3(F)
    U0, S0, V0 = (x.float() for x in torch.linalg.svd(F.double()))
    assert bool((S[:, :-1] >= S[:, 1:]).all())
    assert float((S - S0).abs().max()) <= 1e-5
    ess = torch.tensor([1.0, 1.0, 0.0], device=card)
    rank2, ref2 = (U * (S * ess)[:, None, :]) @ Vh, (U0 * (S0 * ess)[:, None, :]) @ V0
    assert float(((rank2 - ref2).abs().amax((-2, -1)) / ref2.abs().amax((-2, -1))).max()) <= 1e-5
    essential, refe = (U * ess) @ Vh, (U0 * ess) @ V0
    tol = 1e-5 + 8 * 2.0 ** -24 * S0[:, 0] / (S0[:, 1] - S0[:, 2])
    err = (essential - refe).abs().amax((-2, -1)) / refe.abs().amax((-2, -1))
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["5pt", "8pt"])
def test_compiled_request_on_card(card, solver, tmp_path):
    """build_inference_fn at a small width on the card: the first call
    captures, a replay equals the eager far_forward from the same
    generator state bit for bit, with no host sync under
    set_sync_debug_mode("error"). The first call's warm-up adds one
    request's launches to the counters; a replay runs no wrapper and adds
    none, and a profiler trace of it shows the polish's small-matrix
    kernels as often as the warm-up launched them."""
    import dataclasses

    from far_tpu_torch.ops import launch_counts
    from far_tpu_torch.ops.small_linalg import eigh_small, svd3
    from far_tpu_torch.pipeline import build_inference_fn, far_forward, init_model
    from far_tpu_torch.tools.profile_forward import synthetic_batch
    from far_tpu_torch.utils.config import (
        AttentionStackConfig, BackboneConfig, FARConfig, FineConfig, MatchConfig,
        RegressConfig, SolverOptions)

    cfg = FARConfig(
        image_size=(96, 128), backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=AttentionStackConfig(d_model=32, nhead=4),
        match=MatchConfig(max_matches=32, thr=0.0), fine=FineConfig(d_model=16, nhead=4),
        regress=RegressConfig(d_model=32, emm_heads=4, hidden=64),
        solver=SolverOptions(num_hypotheses=256, refine_num_hypotheses=256,
                             minimal_solver=solver))
    model = init_model(cfg, seed=1, device=card)
    batch = synthetic_batch(2, *cfg.image_size, card, seed=3)
    gen = torch.Generator(device=card)
    with torch.inference_mode():
        ref = far_forward(model, batch, gen.manual_seed(2))
    fn = build_inference_fn(model)
    before = launch_counts()
    first = fn(batch, generator=gen.manual_seed(2))
    one = {k: v - before[k] for k, v in launch_counts().items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(batch, generator=gen.manual_seed(2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in launch_counts().items()} == one
    assert one[(loftr_layer, "launches")] > 0 and one[(eigh_small, "launches")] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(batch, generator=gen.manual_seed(2))
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"]
    for kernel, wrapper in (("eigh_kernel", eigh_small), ("svd3_kernel", svd3)):
        assert sum(kernel in n for n in names) == one[(wrapper, "launches")], kernel

    def fields(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            yield from (fields(v) if dataclasses.is_dataclass(v) else
                        [(f.name, v)] if isinstance(v, torch.Tensor) else [])

    for got in (first, out):
        for (name, a), (_, b) in zip(fields(got), fields(ref)):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_stage_marks_on_card(card):
    """The compiled request's marks at a small width on the card: the
    warm-up launches one mark a stage boundary, the eager far_forward and a
    replay launch none through the wrapper; a replay still equals the
    eager far_forward bit for bit. In a profiler trace of a replay the
    graph's marks come one a boundary, ``stage_ms()`` agrees with the
    trace's mark-to-mark spans within max(2 %, 10 us), each stage's
    node counter (kernel, copy and memset nodes) equals the device
    operations the trace shows between its marks, and no device event
    carries a program mark's name."""
    import dataclasses

    from far_tpu_torch.ops.stage_mark import stage_mark
    from far_tpu_torch.pipeline import REQUEST_MARK, build_inference_fn, far_forward, \
        init_model, request_stages
    from far_tpu_torch.tools.profile_forward import synthetic_batch
    from far_tpu_torch.utils.config import (
        AttentionStackConfig, BackboneConfig, FARConfig, FineConfig, MatchConfig,
        RegressConfig, SolverOptions)
    from far_tpu_torch.utils.prof import counters

    cfg = FARConfig(
        image_size=(96, 128), backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=AttentionStackConfig(d_model=32, nhead=4),
        match=MatchConfig(max_matches=32, thr=0.0), fine=FineConfig(d_model=16, nhead=4),
        regress=RegressConfig(d_model=32, emm_heads=4, hidden=64),
        solver=SolverOptions(num_hypotheses=256, refine_num_hypotheses=256))
    stages = request_stages(cfg)
    model = init_model(cfg, seed=1, device=card)
    batch = synthetic_batch(2, *cfg.image_size, card, seed=3)
    gen = torch.Generator(device=card)
    launches = stage_mark.launches
    with torch.inference_mode():
        ref = far_forward(model, batch, gen.manual_seed(2))
    assert stage_mark.launches == launches
    fn = build_inference_fn(model)
    before = counters()
    fn(batch, generator=gen.manual_seed(2))
    nodes = {k[len("far.capture.nodes."):]: v - before.get(k, 0)
             for k, v in counters().items() if k.startswith("far.capture.nodes.")}
    assert stage_mark.launches == launches + len(stages) + 1
    out = fn(batch, generator=gen.manual_seed(2))
    assert stage_mark.launches == launches + len(stages) + 1

    def fields(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            yield from (fields(v) if dataclasses.is_dataclass(v) else
                        [(f.name, v)] if isinstance(v, torch.Tensor) else [])

    for (name, a), (_, b) in zip(fields(out), fields(ref)):
        assert torch.equal(a, b), name
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(batch, generator=gen.manual_seed(2))
        torch.cuda.synchronize()
    ms = fn.stage_ms()
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [(s, e) for s, e, n in dev if "stage_mark_kernel" in n]
    assert len(marks) == len(stages) + 1
    assert sorted(ms) == sorted(stages) and sorted(nodes) == sorted(stages)
    for i, stage in enumerate(stages):
        traced = (marks[i + 1][0] - marks[i][0]) / 1e3
        assert abs(ms[stage] - traced) <= max(0.02 * traced, 0.010), (stage, ms[stage], traced)
        # from a mark's start: the next operation may start before the mark ends
        ops = sum(marks[i][0] < s < marks[i + 1][0] and "stage_mark_kernel" not in n
                  for s, _, n in dev)
        assert ops == nodes[stage], stage
    assert not {n for _, _, n in dev} & {REQUEST_MARK, *stages}
