"""Weight layouts between the JAX package's Flax tree and the port.

The port's modules carry the reference's torch names, so a reference
state dict (``matcher.`` prefix stripped) loads with ``strict=True``.
``build_loftr_mapping`` (with the 16/4 backbone and GroupNorm, which the
JAX package's mapping lacks), ``build_vitess_mapping``,
``build_sixdreg_mapping``, ``build_superpoint_mapping`` and
``build_simple_transformer_mapping`` are the port's own copies of the
mappings in ``far_tpu/utils/convert_weights.py`` (torch key, Flax path,
transform); ``build_superglue_mapping`` takes magicleap's SuperGlue
(Conv1d + BatchNorm1d, folded) to the port's keys, which are the JAX
package's names, and ``convert_superpoint_state_dict`` /
``convert_superglue_state_dict`` apply the magicleap layouts;
``flax_to_state_dict`` runs the one of its config's family backwards,
turning the JAX package's ``{"params", "batch_stats"}`` tree (numpy
arrays) into a torch-keyed state dict: HWIO -> OIHW for convolutions,
(in, out) -> (out, in) for linears, and the row permutation of
``_perm_linear`` undone (the JAX package flattens features token-major
where the reference, and the port, flatten them channel-major).
``load_flax_npz`` reads such a tree from an ``.npz`` written with
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


def _perm_linear(C: int, n_extra: int = 0, n_blocks: int = 1):
    """The transform of a Linear whose flattened input the reference orders
    channel-major (row c*HW + s) and the JAX package token-major (s*C + c):
    ``n_blocks`` same-size leading blocks permuted each, ``n_extra``
    trailing rows as they are. HW comes from the weight's shape. The
    returned transform carries its ``inverse``."""

    def perm(n_in):
        hw = (n_in - n_extra) // (n_blocks * C)
        if hw * n_blocks * C + n_extra != n_in:
            raise ValueError(f"cannot factor input dim {n_in} as "
                             f"{n_blocks}*{C}*HW + {n_extra}")
        base = (np.arange(C)[None, :] * hw + np.arange(hw)[:, None]).reshape(-1)
        return np.concatenate([base + b * C * hw for b in range(n_blocks)])

    def tf(v):
        w = _linear(v)                                    # (in, out)
        p = perm(w.shape[0])
        return np.concatenate([w[p], w[len(p):]], axis=0)

    def inverse(v):
        w = np.asarray(v)                                 # (in, out), permuted
        p = perm(w.shape[0])
        out = w.copy()
        out[p] = w[:len(p)]
        return np.transpose(out, (1, 0))

    tf.inverse = inverse
    return tf


def _inverse(tf):
    return getattr(tf, "inverse", None) or _INVERSE[tf]


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


def _torch_encoder_layer_entries(src: str, dst: Tuple[str, ...]):
    """One ``TorchTransformerEncoderLayer`` (``nn.TransformerEncoderLayer``'s
    names) from the JAX package's (qkv, proj, ff1, ff2, norm1, norm2)."""
    e = [(f"{src}.self_attn.in_proj_weight", dst + ("qkv", "kernel"), _linear),
         (f"{src}.self_attn.in_proj_bias", dst + ("qkv", "bias"), _ident)]
    e += _lin_entries(f"{src}.self_attn.out_proj", dst + ("proj",))
    e += _lin_entries(f"{src}.linear1", dst + ("ff1",))
    e += _lin_entries(f"{src}.linear2", dst + ("ff2",))
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

    # ----- backbone (ResNetFPN_8_2 or _16_4; BatchNorm or GroupNorm) ------
    bb = ("backbone",)
    kind = cfg.backbone.norm

    def norm(src, dst):
        if kind == "group":  # scale and bias as a LayerNorm's; no statistics
            P.extend(_ln_entries(src, dst + ("GroupNorm_0",)))
            return
        p, s = _bn_entries(src, dst + ("BatchNorm_0",))
        P.extend(p)
        S.extend(s)

    P.append(("backbone.conv1.weight", bb + ("Conv_0", "kernel"), _conv))
    norm("backbone.bn1", bb + ("_Norm_0",))
    top = 3 if cfg.backbone.resolution[0] == 8 else 4  # stages
    for stage in range(top):
        for blk in range(2):
            src = f"backbone.layer{stage + 1}.{blk}"
            dst = bb + (f"_Stage_{stage}", f"BasicBlock_{blk}")
            P.append((f"{src}.conv1.weight", dst + ("Conv_0", "kernel"), _conv))
            P.append((f"{src}.conv2.weight", dst + ("Conv_1", "kernel"), _conv))
            norm(f"{src}.bn1", dst + ("_Norm_0",))
            norm(f"{src}.bn2", dst + ("_Norm_1",))
            if stage > 0 and blk == 0:  # strided blocks have a downsample
                P.append((f"{src}.downsample.0.weight",
                          dst + ("Conv_2", "kernel"), _conv))
                norm(f"{src}.downsample.1", dst + ("_Norm_2",))
    # FPN, top-down: the lateral 1x1s in order of creation (Conv_1..3),
    # then the refine stacks (_OutConv2_0, _1)
    for i in range(3):
        P.append((f"backbone.layer{top - i}_outconv.weight",
                  bb + (f"Conv_{i + 1}", "kernel"), _conv))
    for oc in range(2):
        src = f"backbone.layer{top - 1 - oc}_outconv2"
        dst = bb + (f"_OutConv2_{oc}",)
        P.append((f"{src}.0.weight", dst + ("Conv_0", "kernel"), _conv))
        norm(f"{src}.1", dst + ("_Norm_0",))
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


def build_vitess_mapping(cfg) -> Tuple[list, list]:
    """(param entries, batch_stats entries) for the ViTEss tree, with the
    port's keys (no ``module.`` prefix; no trunk layer3/layer4/fc). The
    RAFT block's ``norm3`` appears under both its torch names."""
    P: List = []
    S: List = []

    def bn(src, dst):
        p, s = _bn_entries(src, dst)
        P.extend(p)
        S.extend(s)

    P.append(("resnet.conv1.weight", ("resnet", "conv1", "kernel"), _conv))
    bn("resnet.bn1", ("resnet", "bn1"))
    for layer in ("layer1", "layer2"):
        for b in range(2):
            src = f"resnet.{layer}.{b}"
            dst = ("resnet", f"{layer}_{b}")
            P.append((f"{src}.conv1.weight", dst + ("conv1", "kernel"), _conv))
            P.append((f"{src}.conv2.weight", dst + ("conv2", "kernel"), _conv))
            bn(f"{src}.bn1", dst + ("bn1",))
            bn(f"{src}.bn2", dst + ("bn2",))
            if layer == "layer2" and b == 0:
                P.append((f"{src}.downsample.0.weight", dst + ("down", "kernel"), _conv))
                bn(f"{src}.downsample.1", dst + ("bn_down",))

    e = ("extractor_final_conv",)
    for c in ("conv1", "conv2"):
        P.append((f"extractor_final_conv.{c}.weight", e + (c, "kernel"), _conv))
        P.append((f"extractor_final_conv.{c}.bias", e + (c, "bias"), _ident))
    bn("extractor_final_conv.norm1", e + ("norm1",))
    bn("extractor_final_conv.norm2", e + ("norm2",))
    P.append(("extractor_final_conv.downsample.0.weight", e + ("down", "kernel"), _conv))
    P.append(("extractor_final_conv.downsample.0.bias", e + ("down", "bias"), _ident))
    bn("extractor_final_conv.norm3", e + ("norm3",))
    bn("extractor_final_conv.downsample.1", e + ("norm3",))

    if cfg.fusion_transformer:
        P.append(("fusion_transformer.pos_embed", ("pos_embed",), _ident))
        for i in range(cfg.depth - 1):
            src = f"fusion_transformer.blocks.{i}"
            dst = (f"block_{i}",)
            P += _ln_entries(f"{src}.norm1", dst + ("norm1",))
            P += _lin_entries(f"{src}.attn.qkv", dst + ("qkv",))
            P += _lin_entries(f"{src}.attn.proj", dst + ("proj",))
            P += _ln_entries(f"{src}.norm2", dst + ("norm2",))
            P += _lin_entries(f"{src}.mlp.fc1", dst + ("fc1",))
            P += _lin_entries(f"{src}.mlp.fc2", dst + ("fc2",))
        src = f"fusion_transformer.blocks.{cfg.depth - 1}"  # the CrossBlock
        dst = ("cross_block",)
        P += _ln_entries(f"{src}.norm1", dst + ("norm1",))
        P += _lin_entries(f"{src}.cross_attn.qkv", dst + ("cross_attn", "qkv"))
        P += _lin_entries(f"{src}.cross_attn.proj_fundamental",
                          dst + ("cross_attn", "proj_fundamental"))
        P += _ln_entries(f"{src}.norm2", dst + ("norm2",))
        P += _lin_entries(f"{src}.mlp.fc1", dst + ("mlp_fc1",))
        P += _lin_entries(f"{src}.mlp.fc2", dst + ("mlp_fc2",))
        P += _ln_entries("fusion_transformer.norm", ("norm",))
    else:
        for i, name in ((0, "pool1"), (3, "pool2")):
            P.append((f"pool_transformer_output.{i}.weight", (name, "kernel"), _conv))
            P.append((f"pool_transformer_output.{i}.bias", (name, "bias"), _ident))
        bn("pool_transformer_output.1", ("pool_bn1",))
        bn("pool_transformer_output.4", ("pool_bn2",))

    def head_entries(src, dst_fmt, n_extra):
        first = _linear if cfg.fusion_transformer else \
            _perm_linear(cfg.pool_size, n_extra=n_extra, n_blocks=2)
        out = []
        for i, j in ((0, 0), (2, 1), (4, 2)):
            out += [(f"{src}.{i}.weight", (dst_fmt.format(j), "kernel"),
                     first if i == 0 else _linear),
                    (f"{src}.{i}.bias", (dst_fmt.format(j), "bias"), _ident)]
        return out

    P += head_entries("pose_regressor", "pose_regressor_{}", 0)
    if cfg.use_loftr_gating:  # [features, pred 9D, solver 9D + count]
        P += head_entries("moe_predictor", "moe_{}", 19)
    return P, S


def build_sixdreg_mapping(cfg) -> Tuple[list, list]:
    """(param entries, batch_stats entries) for MapfreeRegression (the
    reference's keys that the FAR configuration runs)."""
    P: List = []
    S: List = []

    def bn(src, dst):
        p, s = _bn_entries(src, dst)
        P.extend(p)
        S.extend(s)

    def preact(src, dst, has_shortcut, n_convs):
        for c in range(1, n_convs + 1):
            bn(f"{src}.bn{c}", dst + (f"bn{c}",))
            P.append((f"{src}.conv{c}.weight", dst + (f"conv{c}", "kernel"), _conv))
        if has_shortcut:
            P.append((f"{src}.shortcut.0.weight", dst + ("shortcut", "kernel"), _conv))

    exp = 4 if cfg.encoder_bottleneck else 1
    n_convs = 3 if cfg.encoder_bottleneck else 2
    enc = ("encoder",)
    P.append(("encoder.firstconv.weight", enc + ("firstconv", "kernel"), _conv))
    bn("encoder.firstbn", enc + ("firstbn",))
    in_planes = 64
    for si, (name, planes, stride) in enumerate(
            (("encoder1", 64, 1), ("encoder2", 128, 2), ("encoder3", 256, 2))):
        for b in range(cfg.encoder_blocks[si]):
            st = stride if b == 0 else 1
            preact(f"encoder.{name}.{b}", enc + (f"{name}_{b}",),
                   st != 1 or in_planes != planes * exp, n_convs)
            in_planes = planes * exp
    for ours, theirs in (("upconv4", "upconv4.conv1"), ("iconv4", "iconv4"),
                         ("upconv3", "upconv3.conv1"), ("iconv3", "iconv3"),
                         ("outconv", "outconv")):
        dst = enc + (ours,)
        P.append((f"encoder.{theirs}.conv.weight", dst + ("Conv_0", "kernel"), _conv))
        P.append((f"encoder.{theirs}.conv.bias", dst + ("Conv_0", "bias"), _ident))
        bn(f"encoder.{theirs}.normalize", dst + ("BatchNorm_0",))

    for b in (1, 2, 3):
        preact(f"head.resblock{b}", ("head", f"resblock{b}"), True, 2)

    if cfg.use_vanilla_transformer:
        for i in range(cfg.transformer_layers):
            P += _torch_encoder_layer_entries(f"transformer.layers.{i}", (f"transformer_{i}",))

    def head_entries(src, dst_fmt, n_extra):
        out = []
        for i, j in ((0, 0), (2, 1), (4, 2)):
            tf = _perm_linear(cfg.d_im, n_extra=n_extra) if i == 0 else _linear
            out += [(f"{src}.{i}.weight", (dst_fmt.format(j), "kernel"), tf),
                    (f"{src}.{i}.bias", (dst_fmt.format(j), "bias"), _ident)]
        return out

    P += head_entries("pose_regressor", "pose_regressor_{}", 0)
    if cfg.use_solver_preds:  # [features, pred 9D, solver 9D + 3 counts]
        P += head_entries("moe_predictor", "moe_{}", 21)
    return P, S


def build_simple_transformer_mapping(cfg) -> Tuple[list, list]:
    """(param entries, []) for SimpleTransformer: the JAX package's names,
    its ``encoder_i`` layers under ``TorchTransformerEncoderLayer``'s."""
    P: List = _lin_entries("pos_proj", ("pos_proj",))
    if cfg.use_feats:
        for i in range(2):
            P += _lin_entries(f"feat_enc_{i}", (f"feat_enc_{i}",))
    for i in range(cfg.num_layers):
        P += _torch_encoder_layer_entries(f"encoder.{i}", (f"encoder_{i}",))
    for name in ("moe_enc_0", "moe_enc_1", "pose_0", "pose_1", "moe_0", "moe_1", "moe_2"):
        P += _lin_entries(name, (name,))
    return P, []


# ---- SuperPoint / SuperGlue (magicleap/SuperGluePretrainedNetwork) -------


def build_superpoint_mapping(cfg) -> Tuple[list, list]:
    """(param entries, []) for SuperPoint: the port's keys are magicleap's
    ``superpoint_v1.pth`` ones (SuperGluePretrainedNetwork/models/
    superpoint.py:110-133), each beside the JAX package's path. Plain
    convolutions, no normalisation layers."""
    names = ["conv1a", "conv1b", "conv2a", "conv2b",
             "conv3a", "conv3b", "conv4a", "conv4b"]
    pairs = [(src, f"conv{i}") for i, src in enumerate(names)]
    pairs += [("convPa", "det_a"), ("convPb", "det_b"), ("convDa", "desc_a"),
              ("convDb", "desc_b")]
    P = []
    for src, dst in pairs:
        P.append((f"{src}.weight", (dst, "kernel"), _conv))
        P.append((f"{src}.bias", (dst, "bias"), _ident))
    return P, []


def _conv1d_linear(w):
    """Conv1d (O, I, 1) -> Linear (O, I)."""
    return np.asarray(w)[:, :, 0]


def _fold_bn_conv1d(eps: float = 1e-5):
    """(weight, bias) transforms folding an eval-mode BatchNorm1d into the
    Conv1d before it, in the port's Linear layout: y = (x - mean) gamma /
    sqrt(var + eps) + beta is affine, so conv then BN is one Linear
    (inference-exact; the folded weights carry no BN statistics)."""

    def weight(conv_w, bn_w, bn_rv):
        scale = np.asarray(bn_w) / np.sqrt(np.asarray(bn_rv) + eps)
        return _conv1d_linear(conv_w) * scale[:, None]

    def bias(conv_b, bn_w, bn_b, bn_rm, bn_rv):
        scale = np.asarray(bn_w) / np.sqrt(np.asarray(bn_rv) + eps)
        return (np.asarray(conv_b) - np.asarray(bn_rm)) * scale + np.asarray(bn_b)

    return weight, bias


def build_superglue_mapping(cfg) -> list:
    """Entries (magicleap key or keys, port key, transform) for SuperGlue
    from magicleap's superglue_{indoor,outdoor}.pth
    (SuperGluePretrainedNetwork/models/superglue.py), the JAX package's
    mapping (``far_tpu/utils/convert_weights.py``) in the port's layout:
    each Conv1d + BatchNorm1d of the MLPs folded into one Linear, the
    shared ``final_proj`` filling both ``final_proj`` and
    ``final_proj2``."""
    fold_w, fold_b = _fold_bn_conv1d()
    P = []

    def folded(conv, bn, dst):
        P.append(((f"{conv}.weight", f"{bn}.weight", f"{bn}.running_var"),
                  f"{dst}.weight", fold_w))
        P.append(((f"{conv}.bias", f"{bn}.weight", f"{bn}.bias",
                   f"{bn}.running_mean", f"{bn}.running_var"), f"{dst}.bias", fold_b))

    def plain(conv, dst):
        P.append((f"{conv}.weight", f"{dst}.weight", _conv1d_linear))
        P.append((f"{conv}.bias", f"{dst}.bias", _ident))

    # keypoint encoder MLP([3, 32, 64, 128, 256, D]): Conv1d at 3i and
    # BatchNorm1d at 3i+1 for the first four layers, a bare Conv1d at 12
    for i in range(4):
        folded(f"kenc.encoder.{3 * i}", f"kenc.encoder.{3 * i + 1}", f"kenc_{i}")
    plain("kenc.encoder.12", "kenc_4")
    # GNN: gnn.layers.{2i} is self_i, gnn.layers.{2i+1} cross_i
    for i in range(2 * cfg.num_layers):
        src = f"gnn.layers.{i}"
        dst = f"self_{i // 2}" if i % 2 == 0 else f"cross_{i // 2}"
        for j, name in enumerate(("q", "k", "v")):
            plain(f"{src}.attn.proj.{j}", f"{dst}.attn.{name}")
        plain(f"{src}.attn.merge", f"{dst}.attn.merge")
        # mlp = MLP([2D, 2D, D]): Conv1d at 0, BatchNorm1d at 1, Conv1d at 3
        folded(f"{src}.mlp.0", f"{src}.mlp.1", f"{dst}.fc1")
        plain(f"{src}.mlp.3", f"{dst}.fc2")
    for dst in ("final_proj", "final_proj2"):  # shared in the reference
        plain("final_proj", dst)
    P.append(("bin_score", "bin_score", _ident))
    return P


def _superglue_entries(cfg) -> Tuple[list, list]:
    """(param entries, []) from the port's SuperGlue keys to the JAX
    package's paths: the same names, Flax's ``kernel`` for ``weight``."""
    P = []
    for _, key, _ in build_superglue_mapping(cfg):
        *mod, leaf = key.split(".")
        if leaf == "weight":
            P.append((key, tuple(mod) + ("kernel",), _linear))
        else:
            P.append((key, tuple(mod) + (leaf,), _ident))
    return P, []


def _from_reference(sd: Dict[str, Any], entries) -> Tuple[Dict[str, np.ndarray], dict]:
    """Apply (source key or keys, port key, transform) entries to a
    reference state dict -> (port state dict of numpy arrays, report of
    the entries' ``missing`` source keys and the state dict's ``unused``
    ones; BatchNorm counters, which a fold drops, are not reported)."""
    sd = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
          for k, v in sd.items()}
    out, missing, used = {}, [], set()
    for src, key, tf in entries:
        srcs = (src,) if isinstance(src, str) else tuple(src)
        absent = [k for k in srcs if k not in sd]
        if absent:
            missing += absent
            continue
        used.update(srcs)
        out[key] = np.ascontiguousarray(tf(*(sd[k] for k in srcs)), np.float32)
    unused = [k for k in sd if k not in used and not k.endswith("num_batches_tracked")]
    return out, {"missing": missing, "unused": sorted(unused)}


def convert_superpoint_state_dict(sd: Dict[str, Any], cfg):
    """magicleap superpoint_v1.pth -> (the port's SuperPoint state dict,
    report): the keys are the same, so this only checks and copies."""
    entries = [(key, key, _ident) for key, _, _ in build_superpoint_mapping(cfg)[0]]
    return _from_reference(sd, entries)


def convert_superglue_state_dict(sd: Dict[str, Any], cfg):
    """magicleap superglue_{indoor,outdoor}.pth -> (the port's SuperGlue
    state dict, report), BatchNorm1d folded (inference-exact)."""
    return _from_reference(sd, build_superglue_mapping(cfg))


def build_mapping(cfg) -> Tuple[list, list]:
    """The mapping of ``cfg``'s family: FARConfig, ViTEssConfig,
    SixDRegConfig, SimpleTransformerConfig, SuperPointConfig or
    SuperGlueConfig."""
    from far_tpu_torch.models.simple_transformer import SimpleTransformerConfig
    from far_tpu_torch.models.sixdreg import SixDRegConfig
    from far_tpu_torch.models.superglue import SuperGlueConfig
    from far_tpu_torch.models.superpoint import SuperPointConfig
    from far_tpu_torch.models.vitess import ViTEssConfig

    if isinstance(cfg, ViTEssConfig):
        return build_vitess_mapping(cfg)
    if isinstance(cfg, SixDRegConfig):
        return build_sixdreg_mapping(cfg)
    if isinstance(cfg, SimpleTransformerConfig):
        return build_simple_transformer_mapping(cfg)
    if isinstance(cfg, SuperPointConfig):
        return build_superpoint_mapping(cfg)
    if isinstance(cfg, SuperGlueConfig):
        return _superglue_entries(cfg)
    return build_loftr_mapping(cfg)


def _get_path(tree: Dict[str, Any], path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def flax_to_state_dict(variables_np: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    """The JAX package's variables of ``cfg``'s model (FARLoFTR, ViTEss,
    MapfreeRegression, SimpleTransformer, SuperPoint or SuperGlue) -> a
    state dict with the port's torch keys (the reference's, no prefix). BatchNorms also get their ``num_batches_tracked`` counter
    (0), as a torch state dict has."""
    P, S = build_mapping(cfg)
    out: Dict[str, np.ndarray] = {}
    for entries, tree in ((P, variables_np["params"]),
                          (S, variables_np.get("batch_stats", {}))):
        for torch_key, path, tf in entries:
            out[torch_key] = np.ascontiguousarray(
                _inverse(tf)(_get_path(tree, path)))
            if torch_key.endswith(".running_mean"):
                counter = torch_key[:-len("running_mean")] + "num_batches_tracked"
                out[counter] = np.zeros((), np.int64)
    return out


def load_reference_state_dict(model: nn.Module, sd: Dict[str, Any]):
    """Load a reference checkpoint (tensors or arrays) into a ViTEss or a
    MapfreeRegression with ``strict=True``, after what the port's model
    does not hold is taken out: for ViTEss DDP's ``module.`` prefix and
    the trunk's unused ``resnet.layer3/layer4/fc``; for map-free the
    frozen matcher (``matcher.``, ``matching.``), the head's full-forward
    tail (``head.resblock4``, ``head.mlp``) and the loss weights ``s_r``,
    ``s_t``."""
    from far_tpu_torch.models.sixdreg import MapfreeRegression
    from far_tpu_torch.models.vitess import ViTEss

    if isinstance(model, ViTEss):
        prefix = "module."
        unused = lambda k: k.startswith(("resnet.layer3.", "resnet.layer4.", "resnet.fc."))
    elif isinstance(model, MapfreeRegression):
        prefix = ""
        unused = lambda k: k in ("s_r", "s_t") or k.startswith(
            ("matcher.", "matching.", "head.resblock4.", "head.mlp."))
    else:
        raise TypeError(f"no reference layout for {type(model).__name__}")
    own = {}
    for k, v in sd.items():
        k = k[len(prefix):] if k.startswith(prefix) else k
        if not unused(k):
            own[k] = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return model.load_state_dict(own, strict=True)


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
    score left at the value the module was built with (FARLoFTR: the
    config's ``skh_init_bin_score``; SuperGlue: 1)."""
    g = torch.Generator().manual_seed(seed)
    for name, t in sorted(model.state_dict(keep_vars=True).items()):
        if name.endswith("num_batches_tracked") or name.endswith("running_mean"):
            v = torch.zeros(t.shape, dtype=t.dtype)
        elif name.endswith("running_var"):
            v = torch.ones(t.shape)
        elif name == "bin_score":  # the dustbin score the module was built with
            v = t.detach().clone()
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
