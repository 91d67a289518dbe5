"""far_tpu_torch's remaining matchers and baselines against far_tpu's, on
the CPU.

SuperPoint (``simple_nms``, ``_bilinear_sample``, the detector),
SuperGlue and ``match_pair_superglue``, SimpleTransformer, the magicleap
converters with their BatchNorm1d fold, ``SIFTMatching`` and the
augmentors. Inputs come from numpy seeds; weights are the JAX package's
own init carried into the port by ``flax_to_state_dict``. Tolerances:
indices and masks equal; float32 values within the stated multiple of
max|ref|.

The port's SuperPoint follows magicleap's published equations in three
steps where the JAX package departs from them: ``simple_nms`` adds two
suppression passes to the max-pool equality, and the descriptor map is
L2-normalised before it is sampled at magicleap's ``sample_descriptors``
coordinates (not at x / 8). Those steps are held to magicleap's form
written out below (``ml_simple_nms``, ``ml_sample_descriptors``; in JAX
for the detector, ``magicleap_superpoint`` puts them in the JAX
package's place); every other step keeps its JAX parity.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far_tpu.data import augment as jaugment
from far_tpu.models import feature_matching as jfm
from far_tpu.models import simple_transformer as jst
from far_tpu.models import superglue as jsg
from far_tpu.models import superpoint as jsp
from far_tpu.utils import convert_weights as jconvert
from far_tpu_torch.data import augment as taugment
from far_tpu_torch.models import feature_matching as tfm
from far_tpu_torch.models import simple_transformer as tst
from far_tpu_torch.models import superglue as tsg
from far_tpu_torch.models import superpoint as tsp
from far_tpu_torch.utils import convert_weights as tconvert

torch.set_num_threads(2)

# tests/test_superpoint_glue.py's widths
SP_SMALL = dict(channels=(8, 8, 16, 16), desc_dim=32, max_keypoints=32)
SG_SMALL = dict(desc_dim=32, num_layers=1, num_heads=4, sinkhorn_iterations=5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def carried(module, variables, cfg):
    """The port's module with the JAX variables loaded strictly."""
    sd = tconvert.flax_to_state_dict(np_tree(variables), cfg)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def close(out, ref, rel, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def textured(rng, B, H, W):
    """Smooth random images in [0, 1] with corners for the detector."""
    low = rng.random((B, 1, H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = torch.nn.functional.interpolate(torch.from_numpy(low), size=(H, W),
                                          mode="bilinear", align_corners=True)
    return img.permute(0, 2, 3, 1).numpy().copy()


# ---- SuperPoint ------------------------------------------------------------

# magicleap's SuperPoint steps, as published in SuperGluePretrainedNetwork/
# models/superpoint.py (``simple_nms``, ``sample_descriptors``)


def ml_simple_nms(scores, nms_radius: int):
    assert(nms_radius >= 0)

    def max_pool(x):
        return torch.nn.functional.max_pool2d(
            x, kernel_size=nms_radius*2+1, stride=1, padding=nms_radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def ml_sample_descriptors(keypoints, descriptors, s: int = 8):
    b, c, h, w = descriptors.shape
    keypoints = keypoints - s / 2 + 0.5
    keypoints /= torch.tensor([(w*s - s/2 - 0.5), (h*s - s/2 - 0.5)],
                              ).to(keypoints)[None]
    keypoints = keypoints*2 - 1  # normalize to (-1, 1)
    args = {'align_corners': True}
    descriptors = torch.nn.functional.grid_sample(
        descriptors, keypoints.view(b, 1, -1, 2), mode='bilinear', **args)
    descriptors = torch.nn.functional.normalize(
        descriptors.reshape(b, c, -1), p=2, dim=1)
    return descriptors


def magicleap_superpoint(monkeypatch):
    """The JAX package's SuperPointTPU with magicleap's NMS and descriptor
    sampling in place of its own, in jnp: every other step is the JAX
    package's. ``simple_nms`` as ``ml_simple_nms``; ``_bilinear_sample``,
    which SuperPointTPU calls at (x / 8, y / 8) and normalises after, reads
    the map L2-normalised over channels at magicleap's coordinates: with
    aligned corners ``grid_sample`` reads (g + 1) / 2 (w - 1) of the map at
    g = 2 (x - 3.5) / (8 w - 4.5) - 1."""
    import flax.linen as fnn

    def nms(scores, radius):
        k = 2 * radius + 1

        def pool(x):
            return fnn.max_pool(x[..., None], (k, k), (1, 1),
                                padding=((radius, radius), (radius, radius)))[..., 0]

        zeros = jnp.zeros_like(scores)
        keep = scores == pool(scores)
        for _ in range(2):
            supp = pool(keep.astype(jnp.float32)) > 0
            left = jnp.where(supp, zeros, scores)
            keep = keep | ((left == pool(left)) & ~supp)
        return jnp.where(keep, scores, zeros)

    bilinear = jsp._bilinear_sample

    def sample(fmap, xy):
        _, h, w, _ = fmap.shape
        fmap = fmap / jnp.maximum(jnp.linalg.norm(fmap, axis=-1, keepdims=True), 1e-12)
        kpts = xy * 8.0
        x = (kpts[..., 0] - 3.5) / (w * 8 - 4.5) * (w - 1)
        y = (kpts[..., 1] - 3.5) / (h * 8 - 4.5) * (h - 1)
        return bilinear(fmap, jnp.stack([x, y], -1))

    monkeypatch.setattr(jsp, "simple_nms", nms)
    monkeypatch.setattr(jsp, "_bilinear_sample", sample)


def test_simple_nms_matches_jax(monkeypatch):
    """Random scores with planted plateaus (ties must both survive) and
    a border maximum: the port keeps every score JAX's max-pool equality
    keeps, and equals magicleap's ``simple_nms`` bit for bit, as does the
    jnp form ``magicleap_superpoint`` gives the JAX package; the two
    suppression passes keep more than the equality alone."""
    rng = np.random.default_rng(0)
    s = rng.random((2, 24, 32)).astype(np.float32)
    s[0, 5, 5] = s[0, 5, 7] = 2.0
    s[1, 0, 0] = 3.0
    jax_once = {r: np.asarray(jsp.simple_nms(jnp.asarray(s), r)) for r in (1, 4)}
    magicleap_superpoint(monkeypatch)
    for r in (1, 4):
        out = tsp.simple_nms(torch.from_numpy(s), r).numpy()
        ref = ml_simple_nms(torch.from_numpy(s)[:, None], r)[:, 0].numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(np.asarray(jsp.simple_nms(jnp.asarray(s), r)), ref)
        kept = jax_once[r] > 0
        np.testing.assert_array_equal(out[kept], s[kept])
        assert (out > 0).sum() > kept.sum()


def test_bilinear_sample_matches_jax():
    """Points inside, on the edges and outside the map (clipped first):
    within 1e-6 max|ref|. ``sample_descriptors`` around it reads the map
    as magicleap's ``sample_descriptors`` does (its coordinates,
    ``grid_sample`` with aligned corners, normalised) at keypoints inside
    SuperPoint's 4-pixel border: within 1e-6."""
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)
    xy = rng.uniform([-2, -2], [11, 8], size=(2, 40, 2)).astype(np.float32)
    xy[:, :4] = [[0, 0], [8, 5], [8.0, 2.5], [3.5, 5.0]]
    ref = jsp._bilinear_sample(jnp.asarray(fmap), jnp.asarray(xy))
    out = tsp._bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(xy))
    close(out, ref, 1e-6)
    kpts = torch.from_numpy(rng.uniform([4, 4], [9 * 8 - 5, 6 * 8 - 5],
                                        size=(2, 40, 2)).astype(np.float32))
    kpts[:, :2] = torch.tensor([[4.0, 4.0], [9 * 8 - 5.0, 6 * 8 - 5.0]])
    fmap_t = torch.from_numpy(fmap)
    want = ml_sample_descriptors(kpts, fmap_t.permute(0, 3, 1, 2)).transpose(1, 2)
    close(tsp.sample_descriptors(fmap_t, kpts), want, 1e-6)


@pytest.mark.parametrize("threshold,max_kp", [(0.0, 32), (0.0157, 64)])
def test_superpoint_matches_jax(threshold, max_kp, monkeypatch):
    """The detector on textured 64x64 images against the JAX package's
    with magicleap's NMS and descriptor sampling (``magicleap_superpoint``):
    keypoints (top-k indices, the tied zero slots included), scores and
    ``valid`` equal to it, descriptors within 1e-5 max|ref|. In the
    second case fewer keypoints pass the threshold than
    ``max_keypoints``, and in one image fewer survive NMS than the 64
    slots (magicleap's suppression passes keep more than the equality
    alone, which left fewer in both), so the slots tied at 0 decide the
    tail of its ``kpts`` (both checked)."""
    magicleap_superpoint(monkeypatch)
    cfg_kw = dict(SP_SMALL, max_keypoints=max_kp, keypoint_threshold=threshold)
    jmodel = jsp.SuperPointTPU(jsp.SuperPointConfig(**cfg_kw))
    rng = np.random.default_rng(2)
    img = textured(rng, 2, 64, 64)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    ref = np_tree(jmodel.apply(variables, jnp.asarray(img)))
    cfg = tsp.SuperPointConfig(**cfg_kw)
    port = carried(tsp.SuperPoint(cfg), variables, cfg)
    with torch.no_grad():
        kpts, scores, valid, desc = port(torch.from_numpy(img))
    np.testing.assert_array_equal(kpts.numpy(), ref[0])
    np.testing.assert_array_equal(valid.numpy(), ref[2])
    close(scores, ref[1], 1e-5, "scores")
    close(desc, ref[3], 1e-5, "desc")
    if threshold:
        assert 0 < ref[2].sum(-1).min() and ref[2].sum(-1).max() < max_kp
        assert (ref[1] == 0).sum(-1).max() > 0


# ---- SuperGlue ---------------------------------------------------------------


def _sg_inputs(rng, B, K, D, hw, n_valid):
    kpts = rng.uniform(0, hw[1], size=(B, K, 2)).astype(np.float32)
    scores = rng.uniform(size=(B, K)).astype(np.float32)
    valid = np.arange(K)[None].repeat(B, 0) < np.array(n_valid)[:, None]
    desc = rng.normal(size=(B, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return kpts, scores, valid, desc


def test_superglue_matches_jax():
    """Two layers, 4 heads, 10 Sinkhorn iterations, K = 16 with padded
    slots in both images: matches0 equal, mscores0 within 1e-4 (absolute:
    they are probabilities)."""
    rng = np.random.default_rng(3)
    kw = dict(desc_dim=32, num_layers=2, num_heads=4, sinkhorn_iterations=10,
              match_threshold=0.01)
    a = _sg_inputs(rng, 2, 16, 32, (64, 64), [16, 11])
    perm = rng.permutation(16)
    b = (a[0][:, perm] + rng.normal(0, 1.0, (2, 16, 2)).astype(np.float32), a[1][:, perm],
         a[2][:, perm], a[3][:, perm])
    b[2][1, :3] = False
    jmodel = jsg.SuperGlueTPU(jsg.SuperGlueConfig(**kw))
    jin = [jnp.asarray(x) for x in (*a, *b)]
    variables = jmodel.init(jax.random.PRNGKey(0), *jin, image_hw=(64, 64))
    m0, conf = np_tree(jmodel.apply(variables, *jin, image_hw=(64, 64)))
    cfg = tsg.SuperGlueConfig(**kw)
    port = carried(tsg.SuperGlue(cfg), variables, cfg)
    with torch.no_grad():
        tm0, tconf = port(*[torch.from_numpy(x) for x in (*a, *b)], image_hw=(64, 64))
    assert tm0.dtype == torch.int32
    np.testing.assert_array_equal(tm0.numpy(), m0)
    np.testing.assert_allclose(tconf.numpy(), conf, rtol=0, atol=1e-4)
    assert (m0 >= 0).sum() >= 4  # matches really made


def test_match_pair_superglue_matches_jax(monkeypatch):
    """``match_pair_superglue`` end to end at tests/test_superpoint_glue.py's
    widths (thresholds 0) on a textured pair, the second shifted, against
    the JAX package's with magicleap's NMS and descriptor sampling
    (``magicleap_superpoint``): ok equal, pts0 and pts1 within 1e-4
    max|ref| (integer pixel positions)."""
    magicleap_superpoint(monkeypatch)
    rng = np.random.default_rng(4)
    img0 = textured(rng, 1, 64, 64)
    img1 = np.roll(img0, (3, 5), axis=(1, 2))
    sp_kw = dict(SP_SMALL, keypoint_threshold=0.0)
    sg_kw = dict(SG_SMALL, match_threshold=0.0)
    jsp_m = jsp.SuperPointTPU(jsp.SuperPointConfig(**sp_kw))
    jsg_m = jsg.SuperGlueTPU(jsg.SuperGlueConfig(**sg_kw))
    sp_vs = jsp_m.init(jax.random.PRNGKey(0), jnp.asarray(img0))
    k, s, v, d = jsp_m.apply(sp_vs, jnp.asarray(img0))
    sg_vs = jsg_m.init(jax.random.PRNGKey(1), k, s, v, d, k, s, v, d, image_hw=(64, 64))
    # one final projection for both images, as magicleap's weights give it,
    # so that a random model still matches the shifted pair
    sg_vs = jax.tree.map(lambda x: x, sg_vs)
    sg_vs["params"]["final_proj2"] = sg_vs["params"]["final_proj"]
    ref = np_tree(jsg.match_pair_superglue(jsp_m, sp_vs, jsg_m, sg_vs,
                                           jnp.asarray(img0), jnp.asarray(img1)))
    spc, sgc = tsp.SuperPointConfig(**sp_kw), tsg.SuperGlueConfig(**sg_kw)
    sp_t = carried(tsp.SuperPoint(spc), sp_vs, spc)
    sg_t = carried(tsg.SuperGlue(sgc), sg_vs, sgc)
    with torch.no_grad():
        out = tsg.match_pair_superglue(sp_t, sg_t, torch.from_numpy(img0),
                                       torch.from_numpy(img1))
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    close(out[0], ref[0], 1e-4, "pts0")
    close(out[1], ref[1], 1e-4, "pts1")
    assert ref[2].sum() >= 4


# ---- the magicleap converters ----------------------------------------------


def _magicleap_superglue_sd(cfg, rng):
    """A synthesized superglue_*.pth of magicleap's layout (Conv1d +
    BatchNorm1d MLPs, one shared final_proj), as tests/test_convert.py
    builds it, with BatchNorm counters."""
    D = cfg.desc_dim
    sd = {}

    def conv1d(name, cout, cin):
        sd[f"{name}.weight"] = rng.normal(size=(cout, cin, 1)).astype(np.float32) / np.sqrt(cin)
        sd[f"{name}.bias"] = rng.normal(size=(cout,)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = np.abs(rng.normal(size=(c,))).astype(np.float32) + 0.5
        sd[f"{name}.bias"] = rng.normal(size=(c,)).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(size=(c,)).astype(np.float32)
        sd[f"{name}.running_var"] = np.abs(rng.normal(size=(c,))).astype(np.float32) + 0.5
        sd[f"{name}.num_batches_tracked"] = np.asarray(7, np.int64)

    widths = [3, 32, 64, 128, 256, D]
    for i in range(4):
        conv1d(f"kenc.encoder.{3 * i}", widths[i + 1], widths[i])
        bn(f"kenc.encoder.{3 * i + 1}", widths[i + 1])
    conv1d("kenc.encoder.12", D, 256)
    for i in range(2 * cfg.num_layers):
        src = f"gnn.layers.{i}"
        for j in range(3):
            conv1d(f"{src}.attn.proj.{j}", D, D)
        conv1d(f"{src}.attn.merge", D, D)
        conv1d(f"{src}.mlp.0", 2 * D, 2 * D)
        bn(f"{src}.mlp.1", 2 * D)
        conv1d(f"{src}.mlp.3", D, 2 * D)
    conv1d("final_proj", D, D)
    sd["bin_score"] = np.asarray(1.3, np.float32)
    return sd


# magicleap's attention, as published in SuperGluePretrainedNetwork/models/
# superglue.py (``attention``, ``MultiHeadedAttention``; the GNN layer
# ``AttentionalPropagation`` is x + mlp([x, attn(x, source, source)]))


def ml_attention(query, key, value):
    dim = query.shape[1]
    scores = torch.einsum('bdhn,bdhm->bhnm', query, key) / dim**.5
    prob = torch.nn.functional.softmax(scores, dim=-1)
    return torch.einsum('bhnm,bdhm->bdhn', prob, value), prob


class MultiHeadedAttention(torch.nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        assert d_model % num_heads == 0
        self.dim = d_model // num_heads
        self.num_heads = num_heads
        self.merge = torch.nn.Conv1d(d_model, d_model, kernel_size=1)
        self.proj = torch.nn.ModuleList([copy.deepcopy(self.merge) for _ in range(3)])

    def forward(self, query, key, value):
        batch_dim = query.size(0)
        query, key, value = [l(x).view(batch_dim, self.dim, self.num_heads, -1)
                             for l, x in zip(self.proj, (query, key, value))]
        x, _ = ml_attention(query, key, value)
        return self.merge(x.contiguous().view(batch_dim, self.dim*self.num_heads, -1))


def _magicleap_gnn_layer(sd, i, D, heads):
    """gnn.layers.{i} of a magicleap state dict as the published modules
    (eval BatchNorm): (B, D, N) x, source -> x + delta."""
    attn = MultiHeadedAttention(heads, D)
    mlp = torch.nn.Sequential(torch.nn.Conv1d(2 * D, 2 * D, 1), torch.nn.BatchNorm1d(2 * D),
                              torch.nn.ReLU(), torch.nn.Conv1d(2 * D, D, 1))
    prefix = f"gnn.layers.{i}."
    own = {k[len(prefix):]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()
           if k.startswith(prefix)}
    attn.load_state_dict({k[5:]: v for k, v in own.items() if k.startswith("attn.")})
    mlp.load_state_dict({k[4:]: v for k, v in own.items() if k.startswith("mlp.")})
    mlp.eval()
    return lambda x, src: x + mlp(torch.cat([x, attn(x, src, src)], dim=1))


def test_converted_gnn_layer_matches_magicleap():
    """A self and a cross layer of a synthesized magicleap state dict,
    converted, against magicleap's published MultiHeadedAttention and MLP
    on the same weights: within 1e-5 max|ref|. Its heads are interleaved
    (channel j * heads + h): with the rows copied as they are, every output
    of the layer moves."""
    cfg = tsg.SuperGlueConfig(desc_dim=64, num_layers=1, num_heads=4)
    sd = _magicleap_superglue_sd(cfg, np.random.default_rng(9))
    ours, report = tconvert.convert_superglue_state_dict(sd, cfg)
    assert not report["missing"] and not report["unused"], report
    port = tsg.SuperGlue(cfg).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()}, strict=True)
    rng = np.random.default_rng(10)
    x, src = (torch.from_numpy(rng.normal(size=(2, 64, 11)).astype(np.float32))
              for _ in range(2))
    valid = torch.ones(2, 11, dtype=torch.bool)
    with torch.no_grad():
        for i, layer in enumerate((port.self_0, port.cross_0)):
            ref = _magicleap_gnn_layer(sd, i, 64, 4)(x, src)
            out = layer(x.transpose(1, 2), src.transpose(1, 2), valid).transpose(1, 2)
            close(out, ref, 1e-5, f"gnn.layers.{i}")


def test_superglue_converter_round_trip():
    """A synthesized magicleap SuperGlue state dict through the port's
    converter: nothing missing, nothing unused (the BatchNorm counters
    aside), loaded with strict=True, and equal to the JAX converter's
    variables carried across (max abs 0: the same float32 fold), but for
    the attention's q/k/v rows and merge columns: the JAX converter copies
    magicleap's interleaved heads as they are, so the port's are JAX's
    regrouped (port channel h * d + j is JAX's j * heads + h)."""
    cfg_kw = dict(desc_dim=64, num_layers=2, sinkhorn_iterations=5)
    cfg = tsg.SuperGlueConfig(**cfg_kw)
    sd = _magicleap_superglue_sd(cfg, np.random.default_rng(5))
    ours, report = tconvert.convert_superglue_state_dict(sd, cfg)
    assert not report["missing"] and not report["unused"], report
    tsg.SuperGlue(cfg).load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()},
                                       strict=True)
    jcfg = jsg.SuperGlueConfig(**cfg_kw)
    K = 8
    args = (jnp.zeros((1, K, 2)), jnp.zeros((1, K)), jnp.ones((1, K), bool),
            jnp.zeros((1, K, cfg.desc_dim)))
    variables = jsg.SuperGlueTPU(jcfg).init(jax.random.PRNGKey(0), *args, *args,
                                             image_hw=(32, 32))
    jvars, jreport = jconvert.convert_superglue_state_dict(sd, variables, jcfg)
    assert not jreport["missing"]
    via_jax = tconvert.flax_to_state_dict(np_tree(jvars), cfg)
    assert sorted(via_jax) == sorted(ours)
    heads, d = cfg.num_heads, cfg.desc_dim // cfg.num_heads
    regroup = (np.arange(d)[None, :] * heads + np.arange(heads)[:, None]).reshape(-1)
    n_regrouped = 0
    for k in ours:
        want = via_jax[k]
        if ".attn." in k and not k.endswith("merge.bias"):
            want = want[:, regroup] if ".merge." in k else want[regroup]
            n_regrouped += 1
        np.testing.assert_allclose(ours[k], want, rtol=0, atol=1e-6, err_msg=k)
    assert n_regrouped == 2 * cfg.num_layers * 7


def test_superpoint_converter_round_trip():
    """magicleap's superpoint_v1.pth keys are the port's own: a
    synthesized one converts with nothing missing or unused, loads
    strictly, and the JAX converter's variables carried back give the
    same tensors."""
    cfg = tsp.SuperPointConfig(max_keypoints=16)
    port = tsp.SuperPoint(cfg)
    rng = np.random.default_rng(6)
    sd = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in port.state_dict().items()}
    ours, report = tconvert.convert_superpoint_state_dict(sd, cfg)
    assert not report["missing"] and not report["unused"], report
    port.load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()}, strict=True)
    jmodel = jsp.SuperPointTPU(jsp.SuperPointConfig(max_keypoints=16))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    jvars, jreport = jconvert.convert_superpoint_state_dict(sd, variables, jmodel.cfg)
    assert not jreport["missing"] and not jreport["unused"]
    via_jax = tconvert.flax_to_state_dict(np_tree(jvars), cfg)
    for k in sd:
        np.testing.assert_array_equal(via_jax[k], sd[k], err_msg=k)


def test_bn_fold_equals_conv1d_batchnorm1d():
    """The fold of an eval-mode BatchNorm1d into its Conv1d, as a Linear,
    against torch's Conv1d then BatchNorm1d: within 1e-5 max|ref|."""
    rng = np.random.default_rng(7)
    conv = torch.nn.Conv1d(12, 20, 1)
    norm = torch.nn.BatchNorm1d(20).eval()
    with torch.no_grad():
        norm.running_mean.copy_(torch.from_numpy(rng.normal(size=20).astype(np.float32)))
        norm.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 20).astype(np.float32)))
        norm.weight.copy_(torch.from_numpy(rng.normal(size=20).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.normal(size=20).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(3, 12, 9)).astype(np.float32))
    with torch.no_grad():
        ref = norm(conv(x))
    fold_w, fold_b = tconvert._fold_bn_conv1d()
    t = lambda p: p.detach().numpy()
    w = fold_w(t(conv.weight), t(norm.weight), t(norm.running_var))
    b = fold_b(t(conv.bias), t(norm.weight), t(norm.bias), t(norm.running_mean),
               t(norm.running_var))
    out = torch.nn.functional.linear(x.transpose(1, 2), torch.from_numpy(w),
                                     torch.from_numpy(b)).transpose(1, 2)
    close(out, ref, 1e-5)


# ---- SimpleTransformer -------------------------------------------------------


@pytest.mark.parametrize("use_feats,cat_feats", [(False, False), (True, False), (True, True)])
def test_simple_transformer_matches_jax(use_feats, cat_feats):
    """tests/test_model_zoo.py's widths (64 wide, 4 heads, 2 layers), 32
    match tokens of which 20 valid, optional per-match features: the
    fused pose and the gate within 1e-4 max|ref|."""
    kw = dict(feat_size=64, num_heads=4, num_layers=2, hidden=64, use_feats=use_feats,
              cat_feats=cat_feats)
    rng = np.random.default_rng(8)
    corr = (rng.uniform(size=(2, 32, 2, 2)) * 100).astype(np.float32)
    valid = np.arange(32)[None].repeat(2, 0) < 20
    c, s = np.cos(0.3), np.sin(0.3)
    rt = np.stack([np.array([[c, 0, s, 0.4], [0, 1, 0, -0.2], [-s, 0, c, 0.8]], np.float32),
                   np.eye(3, 4, dtype=np.float32)])
    nc = np.array([100.0, 50.0], np.float32)
    feats = rng.normal(size=(2, 32, 2, 256)).astype(np.float32) if use_feats else None
    jmodel = jst.SimpleTransformer(jst.SimpleTransformerConfig(**kw))
    jargs = [jnp.asarray(x) for x in (corr, valid, rt, nc)]
    jf = None if feats is None else jnp.asarray(feats)
    variables = jmodel.init(jax.random.PRNGKey(0), *jargs, jf)
    ref = np_tree(jmodel.apply(variables, *jargs, jf))
    cfg = tst.SimpleTransformerConfig(**kw)
    port = carried(tst.SimpleTransformer(cfg), variables, cfg)
    with torch.no_grad():
        out = port(*[torch.from_numpy(x) for x in (corr, valid, rt, nc)],
                   None if feats is None else torch.from_numpy(feats))
    close(out[0], ref[0], 1e-4, "pose")
    close(out[1], ref[1], 1e-4, "gate")


def test_nerf_positional_encoding_matches_jax():
    x = np.random.default_rng(9).normal(size=(2, 5, 4)).astype(np.float32) * 50
    close(tst.nerf_positional_encoding(torch.from_numpy(x), 10),
          jst.nerf_positional_encoding(jnp.asarray(x), 10), 1e-6)


# ---- SIFT and the augmentors -------------------------------------------------


def test_sift_matches_jax():
    """``SIFTMatching`` on a textured pair (the second shifted): the
    padded points and mask equal to the JAX package's, both on OpenCV."""
    rng = np.random.default_rng(10)
    img = textured(rng, 1, 160, 200)[0] * 0.6 + 0.4 * rng.random((160, 200, 1))
    img1 = np.roll(img, (6, 9), axis=(0, 1))
    ref = jfm.SIFTMatching(num_features=500, max_matches=256).match(img, img1)
    out = tfm.SIFTMatching(num_features=500, max_matches=256).match(img, img1)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert ref[2].sum() >= 8


@pytest.mark.parametrize("name", ["dark", "mobile", "colorjitter"])
def test_augment_bit_equal(name):
    """Each augmentor on the same image and generator state: bit-equal to
    the JAX package's, the generator left in the same state."""
    img = np.random.default_rng(11).uniform(size=(16, 16, 3)).astype(np.float32)
    r0, r1 = np.random.default_rng(12), np.random.default_rng(12)
    ref = jaugment.build_augmentor(name)(img, r0)
    out = taugment.build_augmentor(name)(img, r1)
    np.testing.assert_array_equal(out, ref)
    assert r0.random() == r1.random()
    assert taugment.build_augmentor(None) is None
    with pytest.raises(ValueError):
        taugment.build_augmentor("sepia")
