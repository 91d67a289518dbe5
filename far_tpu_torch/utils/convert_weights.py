"""Weight layouts between the JAX package's Flax tree and the port.

The port's modules carry the reference's torch names, so a reference
state dict (``matcher.`` prefix stripped) loads with ``strict=True``.
``build_loftr_mapping`` is the port's own copy of the mapping in
``far_tpu/utils/convert_weights.py`` (torch key, Flax path, transform);
``flax_to_state_dict`` runs it backwards, turning the JAX package's
``{"params", "batch_stats"}`` tree (numpy arrays) into a torch-keyed
state dict: HWIO -> OIHW for convolutions, (in, out) -> (out, in) for
linears. ``load_flax_npz`` reads such a tree from an ``.npz`` written with
``jax.tree_util.keystr`` keys (``assets/tiny_guard.npz``), without JAX.
``init_weights`` gives a model deterministic random weights from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn


def _conv(v):
    return np.transpose(np.asarray(v), (2, 3, 1, 0))  # OIHW -> HWIO


def _linear(v):
    return np.transpose(np.asarray(v), (1, 0))


def _ident(v):
    return np.asarray(v)


_INVERSE = {
    _conv: lambda v: np.transpose(np.asarray(v), (3, 2, 0, 1)),  # HWIO -> OIHW
    _linear: lambda v: np.transpose(np.asarray(v), (1, 0)),
    _ident: lambda v: np.asarray(v),
}


def _bn_entries(src_prefix: str, dst_path: Tuple[str, ...]):
    """(param entries, batch_stats entries) for one BatchNorm."""
    params = [
        (f"{src_prefix}.weight", dst_path + ("scale",), _ident),
        (f"{src_prefix}.bias", dst_path + ("bias",), _ident),
    ]
    stats = [
        (f"{src_prefix}.running_mean", dst_path + ("mean",), _ident),
        (f"{src_prefix}.running_var", dst_path + ("var",), _ident),
    ]
    return params, stats


def _ln_entries(src_prefix: str, dst_path: Tuple[str, ...]):
    return [
        (f"{src_prefix}.weight", dst_path + ("scale",), _ident),
        (f"{src_prefix}.bias", dst_path + ("bias",), _ident),
    ]


def _lin_entries(src_prefix: str, dst_path: Tuple[str, ...],
                 bias: bool = True):
    out = [(f"{src_prefix}.weight", dst_path + ("kernel",), _linear)]
    if bias:
        out.append((f"{src_prefix}.bias", dst_path + ("bias",), _ident))
    return out


def _encoder_layer_entries(src: str, dst: Tuple[str, ...]):
    """One LoFTREncoderLayer (reference transformer.py:12-67)."""
    e = []
    for name in ("q_proj", "k_proj", "v_proj", "merge"):
        e += _lin_entries(f"{src}.{name}", dst + (name,), bias=False)
    e += _lin_entries(f"{src}.mlp.0", dst + ("mlp_0",), bias=False)
    e += _lin_entries(f"{src}.mlp.2", dst + ("mlp_1",), bias=False)
    e += _ln_entries(f"{src}.norm1", dst + ("norm1",))
    e += _ln_entries(f"{src}.norm2", dst + ("norm2",))
    return e


def _stack_entries(src: str, dst_root: Tuple[str, ...],
                   layer_names: Tuple[str, ...]):
    e = []
    for i, name in enumerate(layer_names):
        e += _encoder_layer_entries(
            f"{src}.layers.{i}", dst_root + (f"layer_{i}_{name}",))
    return e


def build_loftr_mapping(cfg) -> Tuple[list, list]:
    """(param entries, batch_stats entries) for the FARLoFTR tree.

    Entry: (torch_key, flax_path_tuple, transform).
    """
    P: List = []
    S: List = []

    # ----- backbone (ResNetFPN_8_2) ------------------------------------
    bb = ("backbone",)
    P.append(("backbone.conv1.weight", bb + ("Conv_0", "kernel"), _conv))
    p, s = _bn_entries("backbone.bn1", bb + ("_Norm_0", "BatchNorm_0"))
    P += p
    S += s
    for stage, layer in enumerate(("layer1", "layer2", "layer3")):
        for blk in range(2):
            src = f"backbone.{layer}.{blk}"
            dst = bb + (f"_Stage_{stage}", f"BasicBlock_{blk}")
            P.append((f"{src}.conv1.weight", dst + ("Conv_0", "kernel"), _conv))
            P.append((f"{src}.conv2.weight", dst + ("Conv_1", "kernel"), _conv))
            p, s = _bn_entries(f"{src}.bn1", dst + ("_Norm_0", "BatchNorm_0"))
            P += p
            S += s
            p, s = _bn_entries(f"{src}.bn2", dst + ("_Norm_1", "BatchNorm_0"))
            P += p
            S += s
            if stage > 0 and blk == 0:  # strided blocks have a downsample
                P.append((f"{src}.downsample.0.weight",
                          dst + ("Conv_2", "kernel"), _conv))
                p, s = _bn_entries(f"{src}.downsample.1",
                                   dst + ("_Norm_2", "BatchNorm_0"))
                P += p
                S += s
    # FPN: lateral 1x1s + refine stacks (order of creation: Conv_1..3)
    P.append(("backbone.layer3_outconv.weight", bb + ("Conv_1", "kernel"), _conv))
    P.append(("backbone.layer2_outconv.weight", bb + ("Conv_2", "kernel"), _conv))
    P.append(("backbone.layer1_outconv.weight", bb + ("Conv_3", "kernel"), _conv))
    for oc, src in ((0, "backbone.layer2_outconv2"),
                    (1, "backbone.layer1_outconv2")):
        dst = bb + (f"_OutConv2_{oc}",)
        P.append((f"{src}.0.weight", dst + ("Conv_0", "kernel"), _conv))
        p, s = _bn_entries(f"{src}.1", dst + ("_Norm_0", "BatchNorm_0"))
        P += p
        S += s
        P.append((f"{src}.3.weight", dst + ("Conv_1", "kernel"), _conv))

    # ----- coarse / fine transformers ----------------------------------
    P += _stack_entries("loftr_coarse", ("loftr_coarse",),
                        tuple(cfg.coarse.layer_names))
    P += _stack_entries("loftr_fine", ("fine_matching", "loftr_fine"),
                        tuple(cfg.fine.layer_names))

    # ----- Sinkhorn dustbin score (the JAX package's top-level param) -----
    if cfg.match.match_type == "sinkhorn":
        P.append(("bin_score", ("bin_score",), _ident))

    # ----- fine preprocess ----------------------------------------------
    if cfg.fine.concat_coarse_feat:
        P += _lin_entries("fine_preprocess.down_proj",
                          ("fine_preprocess", "down_proj"))
        P += _lin_entries("fine_preprocess.merge_feat",
                          ("fine_preprocess", "merge_feat"))

    # ----- FAR regressor --------------------------------------------------
    if cfg.regress_rt:
        r = ("regressor",)
        src = "loftr_regress"
        if cfg.regress.use_pos_embedding:
            # CrossBlock pos_embed (reference transformer.py:305-349,
            # live in the production FAR config via --use_pos_embedding)
            P.append((f"{src}.emm.pos_embed",
                      r + ("emm", "pos_embed"), _ident))
        P += _lin_entries(f"{src}.emm.cross_attn.qkv",
                          r + ("emm", "cross_attn", "qkv"))
        P += _lin_entries(f"{src}.emm.cross_attn.proj_fundamental",
                          r + ("emm", "cross_attn", "proj_fundamental"))
        P += _ln_entries(f"{src}.emm.norm1", r + ("emm", "norm1"))
        P += _ln_entries(f"{src}.emm.norm2", r + ("emm", "norm2"))
        P += _lin_entries(f"{src}.emm.mlp.fc1", r + ("emm", "mlp_fc1"))
        P += _lin_entries(f"{src}.emm.mlp.fc2", r + ("emm", "mlp_fc2"))
        P += _ln_entries(f"{src}.norm", r + ("norm",))
        if cfg.regress.use_simple_moe:
            P += _lin_entries(f"{src}.encoder.0", r + ("encoder_0",))
            P += _lin_entries(f"{src}.encoder.2", r + ("encoder_1",))
            P += _lin_entries(f"{src}.pose_regressor_simple_moe.0",
                              r + ("pose_moe_0",))
            P += _lin_entries(f"{src}.pose_regressor_simple_moe.2",
                              r + ("pose_moe_1",))
            P += _lin_entries(f"{src}.moe_predictor.0", r + ("moe_0",))
            P += _lin_entries(f"{src}.moe_predictor.2", r + ("moe_1",))
            P += _lin_entries(f"{src}.moe_predictor.4", r + ("moe_2",))
        else:
            P += _lin_entries(f"{src}.pose_regressor.0",
                              r + ("pose_regressor_0",))
            P += _lin_entries(f"{src}.pose_regressor.2",
                              r + ("pose_regressor_1",))
            P += _lin_entries(f"{src}.pose_regressor.4",
                              r + ("pose_regressor_2",))
        if cfg.regress.num_loftr_layers > 0:
            P += _stack_entries(
                f"{src}.loftr", r + ("loftr_extra",),
                tuple(cfg.regress.layer_names) * cfg.regress.num_loftr_layers)

    # ----- translation-scale head (Flax TranslationScaleHead) -------------
    if cfg.predict_translation_scale:
        for name in ("c1", "c2", "c3"):
            P.append((f"ts_head.{name}.weight", ("ts_head", name, "kernel"), _conv))
            P.append((f"ts_head.{name}.bias", ("ts_head", name, "bias"), _ident))
        for name in ("fc1", "fc2", "fc3"):
            P += _lin_entries(f"ts_head.{name}", ("ts_head", name))
    return P, S


def _get_path(tree: Dict[str, Any], path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def flax_to_state_dict(variables_np: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    """The JAX package's FARLoFTR variables -> a state dict with the
    reference's torch keys (no prefix). BatchNorms also get their
    ``num_batches_tracked`` counter (0), as a torch state dict has."""
    P, S = build_loftr_mapping(cfg)
    out: Dict[str, np.ndarray] = {}
    for entries, tree in ((P, variables_np["params"]),
                          (S, variables_np.get("batch_stats", {}))):
        for torch_key, path, tf in entries:
            out[torch_key] = np.ascontiguousarray(
                _INVERSE[tf](_get_path(tree, path)))
            if torch_key.endswith(".running_mean"):
                counter = torch_key[:-len("running_mean")] + "num_batches_tracked"
                out[counter] = np.zeros((), np.int64)
    return out


def load_flax_npz(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(variables, meta) from an ``.npz`` of a Flax tree flattened with
    ``jax.tree_util.keystr`` keys such as ``['params']['backbone']
    ['Conv_0']['kernel']``: the nested ``{"params", "batch_stats"}`` dict
    of numpy arrays, and the JSON of its ``__meta__`` entry (or {})."""
    variables: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(str(z[key]))
                continue
            path_ = [ast.literal_eval(part) for part in key[1:-1].split("][")]
            node = variables
            for k in path_[:-1]:
                node = node.setdefault(k, {})
            node[path_[-1]] = z[key]
    return variables, meta


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic random weights from ``torch.Generator(seed)``, drawn
    on the CPU in sorted key order: LeCun-normal kernels (Flax's default),
    unit norm scales, zero biases and BatchNorm means, unit variances,
    truncated-normal(0.02) position embeddings, and the Sinkhorn dustbin
    score at the config's ``skh_init_bin_score``."""
    g = torch.Generator().manual_seed(seed)
    for name, t in sorted(model.state_dict(keep_vars=True).items()):
        if name.endswith("num_batches_tracked") or name.endswith("running_mean"):
            v = torch.zeros(t.shape, dtype=t.dtype)
        elif name.endswith("running_var"):
            v = torch.ones(t.shape)
        elif name == "bin_score":
            v = torch.tensor(model.config.match.skh_init_bin_score)
        elif name.endswith("pos_embed"):
            v = (torch.randn(t.shape, generator=g) * 0.02).clamp(-0.04, 0.04)
        elif t.ndim >= 2:
            fan_in = int(np.prod(t.shape[1:]))
            v = torch.randn(t.shape, generator=g) / fan_in ** 0.5
        elif name.endswith("weight"):
            v = torch.ones(t.shape)
        else:
            v = torch.zeros(t.shape)
        t.copy_(v.to(t.dtype))
    return model
