"""far_tpu_torch kernels' plain versions against the JAX references.

Each kernel of the port (far_tpu_torch/ops) has a plain PyTorch version
that the wrapper runs on CPU tensors and that chip_smoke.py holds the
CUDA kernel to on the card. Here the plain versions meet the jnp
reference functions in the same far_tpu/ops file on identical inputs
made with numpy. Tolerance: float32, rtol = atol = 1e-5 (summation order
only). K3 is also held to the Pallas kernel itself in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu.ops.bilinear_attention import (
    bilinear_dual_softmax_reference,
    bilinear_dual_softmax_streaming,
)
from far_tpu.ops.fine_layer import _fused, fine_transformer_reference
from far_tpu.ops.loftr_layer import fused_loftr_layer_reference
from far_tpu.ops.matching_kernel import dual_softmax_rowcol_reference
from far_tpu_torch.ops.bilinear_attention import (
    bilinear_dual_softmax,
    bilinear_dual_softmax_plain,
)
from far_tpu_torch.ops.fine_layer import fine_transformer, fine_transformer_plain
from far_tpu_torch.ops.loftr_layer import loftr_layer, loftr_layer_plain
from far_tpu_torch.ops.matching_kernel import (
    dual_softmax_rowcol,
    dual_softmax_rowcol_plain,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def jax_layer_params(rng, C):
    """A layer's weights in the JAX kernels' layout ((in, out) kernels)."""
    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def ln():
        return np.stack([1 + 0.05 * rng.standard_normal(C),
                         0.05 * rng.standard_normal(C)]).astype(np.float32)

    return {"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
            "w0x": w(C, 2 * C), "w0m": w(C, 2 * C), "w1": w(2 * C, C),
            "ln1": ln(), "ln2": ln()}


def to_port(p):
    """JAX layout -> the port's torch Linear layout (out, in)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {"wq": t(p["wq"].T), "wk": t(p["wk"].T), "wv": t(p["wv"].T),
            "wm": t(p["wm"].T),
            "w0": t(np.concatenate([p["w0x"], p["w0m"]], axis=0).T),
            "w1": t(p["w1"].T), "ln1": t(p["ln1"]), "ln2": t(p["ln2"])}


def jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("L,S,C,H", [(64, 64, 32, 4), (40, 56, 32, 4),
                                     (30, 30, 64, 8)])
def test_loftr_layer_plain_matches_reference(L, S, C, H):
    rng = np.random.default_rng(L + S)
    x = rng.standard_normal((2, L, C)).astype(np.float32)
    src = rng.standard_normal((2, S, C)).astype(np.float32)
    p = jax_layer_params(rng, C)
    ref = fused_loftr_layer_reference(jnp.asarray(x), jnp.asarray(src), jp(p), H)
    out = loftr_layer_plain(torch.from_numpy(x), torch.from_numpy(src),
                            to_port(p), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # on CPU tensors the wrapper is the plain version
    wrapped = loftr_layer(torch.from_numpy(x), torch.from_numpy(src),
                          to_port(p), H)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


@pytest.mark.parametrize("L,S", [(64, 64), (48, 80)])
def test_dual_softmax_rowcol_plain_matches_reference(L, S):
    rng = np.random.default_rng(L * S)
    C = 32
    f1 = rng.standard_normal((2, S, C)).astype(np.float32)
    # image 0 holds noisy copies of image-1 tokens: clear argmaxes
    pick = rng.integers(0, S, (2, L))
    f0 = np.take_along_axis(f1, pick[..., None], axis=1) \
        + 0.3 * rng.standard_normal((2, L, C)).astype(np.float32)
    scale = jnp.float32(1.0 / C ** 0.5).astype(jnp.bfloat16)
    a = jnp.asarray(f0).astype(jnp.bfloat16) * scale
    b = jnp.asarray(f1).astype(jnp.bfloat16) * scale
    rv, ri, cm = dual_softmax_rowcol_reference(a, b, 10.0)
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    prv, pri, pcm = dual_softmax_rowcol_plain(ta, tb, 10.0)
    np.testing.assert_allclose(prv.numpy(), np.asarray(rv), **TOL)
    np.testing.assert_allclose(pcm.numpy(), np.asarray(cm), **TOL)
    np.testing.assert_array_equal(pri.numpy(), np.asarray(ri))
    wrv, wri, wcm = dual_softmax_rowcol(ta, tb, 10.0)
    np.testing.assert_array_equal(wri.numpy(), pri.numpy())


def test_dual_softmax_argmax_takes_first_index_on_ties():
    f0 = torch.zeros(1, 4, 8)
    f1 = torch.zeros(1, 6, 8)  # every conf equal: argmax must be 0
    _, ri, _ = dual_softmax_rowcol_plain(f0, f1, 10.0)
    assert ri.tolist() == [[0, 0, 0, 0]]


def _fine_inputs(rng, n, s, C, n_layers=2):
    f0 = rng.standard_normal((n, s, C)).astype(np.float32)
    f1 = rng.standard_normal((n, s, C)).astype(np.float32)
    params = [jax_layer_params(rng, C) for _ in range(n_layers)]
    return f0, f1, params


@pytest.mark.parametrize("n,s,C,H", [(6, 25, 16, 4), (3, 9, 32, 8)])
def test_fine_transformer_plain_matches_reference(n, s, C, H):
    rng = np.random.default_rng(n * s)
    f0, f1, params = _fine_inputs(rng, n, s, C)
    names = ("self", "cross")
    r0, r1 = fine_transformer_reference(jnp.asarray(f0), jnp.asarray(f1),
                                        [jp(p) for p in params], names, H)
    o0, o1 = fine_transformer_plain(torch.from_numpy(f0), torch.from_numpy(f1),
                                    [to_port(p) for p in params], names, H)
    np.testing.assert_allclose(o0.numpy(), np.asarray(r0), **TOL)
    np.testing.assert_allclose(o1.numpy(), np.asarray(r1), **TOL)
    w0, w1 = fine_transformer(torch.from_numpy(f0), torch.from_numpy(f1),
                              [to_port(p) for p in params], names, H)
    np.testing.assert_array_equal(w0.numpy(), o0.numpy())
    np.testing.assert_array_equal(w1.numpy(), o1.numpy())


def test_fine_transformer_plain_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode on CPU), C=128, 8 heads."""
    rng = np.random.default_rng(7)
    f0, f1, params = _fine_inputs(rng, 4, 25, 128)
    names = ("self", "cross")
    r0, r1 = _fused(jnp.asarray(f0), jnp.asarray(f1), [jp(p) for p in params],
                    names, 8)
    o0, o1 = fine_transformer_plain(torch.from_numpy(f0), torch.from_numpy(f1),
                                    [to_port(p) for p in params], names, 8)
    np.testing.assert_allclose(o0.numpy(), np.asarray(r0), **TOL)
    np.testing.assert_allclose(o1.numpy(), np.asarray(r1), **TOL)


@pytest.mark.parametrize("N,D", [(64, 8), (48, 16)])
def test_bilinear_plain_matches_references(N, D):
    rng = np.random.default_rng(N + D)
    q = rng.standard_normal((2, 4, N, D)).astype(np.float32)
    k = rng.standard_normal((2, 4, N, D)).astype(np.float32)
    v = rng.standard_normal((2, 4, N, D + 6)).astype(np.float32)
    scale = D ** -0.5
    ref = bilinear_dual_softmax_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale)
    stream = bilinear_dual_softmax_streaming(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), scale, block=16)
    out = bilinear_dual_softmax_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(stream), **TOL)
    wrapped = bilinear_dual_softmax(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


def test_wrappers_reject_mixed_devices():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        dual_softmax_rowcol(x, x.to("meta"), 10.0)
