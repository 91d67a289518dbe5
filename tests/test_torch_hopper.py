"""The bfloat16 tensor-core routes of K1 and K4 (far_tpu_torch/csrc).

On the CPU: what surrounds the kernels - the weight pack that K1's
wrapper takes (it must equal ``raw()`` cast to the dtype, and a layer's
call must see a changed weight) and K4's zero padding of q, k and v (it
must change nothing). On a card (marked ``cuda``; each test skips
without one): both routes against their plain versions at ragged shapes
and at every shape they are built for.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hopper.py
"""

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
from far_tpu_torch.ops.loftr_layer import (
    WEIGHTS,
    loftr_layer,
    loftr_layer_plain,
    pack_params,
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
def test_loftr_layer_bf16_route_names_a_shape_it_lacks(card):
    x = torch.zeros(1, 16, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(1, 16, 32\) with nhead=4"):
        loftr_layer(x, x, pack_params(_params(32, torch.Generator(), card),
                                      torch.bfloat16), 4)


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
