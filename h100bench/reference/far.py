"""Plain float32 reference of the FAR matcher and regressor.

Written from the published LoFTR + FAR equations in plain torch: a
ResNet-FPN 8/2 backbone with BatchNorm in eval mode, the sine position
encoding, the linear-attention LoFTR stack, the dual-softmax coarse match
with mutual nearest neighbours and a static top-k, the 5x5 fine windows
with the coarse-context merge and a soft-argmax, and the EMM bilinear
regressor with its MoE gate. Parameters are named as the program's, so
one state dict loads into both. Nothing here imports the program.

Every product's operands and every layer's output go through ``quant``:
the identity for the reference, an fp8 rounding for the control
(``fp8``), which so stores what the bf16 program stores in bf16, one
precision lower.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.solver.rotations import (
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)

Quant = Callable[[torch.Tensor], torch.Tensor]

POSE_MEAN_6D = [-0.34898765, 0.17085525, -0.87944315, 0.50275223, 0.03533648,
                -0.18179045, -0.03533648, 0.98189617, 0.09313615]
POSE_STD_6D = [1.94014405, 0.36770130, 1.88317520, 0.51837117, 0.12717603,
               0.65426397, 0.12717603, 0.0188729, 0.09709263]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (amax to 448), as
    an fp8 GEMM takes its operands; returned in float32."""
    s = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


@dataclass(frozen=True)
class Shapes:
    """The configuration's sizes that the reference needs."""
    image_hw: Tuple[int, int] = (480, 640)
    initial_dim: int = 128
    block_dims: Tuple[int, int, int] = (128, 196, 256)
    d_coarse: int = 256
    nhead_coarse: int = 8
    n_coarse_layers: int = 8
    d_fine: int = 128
    nhead_fine: int = 8
    window: int = 5
    thr: float = 0.2
    border_rm: int = 2
    temperature: float = 0.1
    max_matches: int = 1024
    emm_heads: int = 4
    hidden: int = 512
    grid_fx: float = 517.0 / 9.0
    grid_fy: float = 517.0 / 8.0
    regress_rt: bool = True

    @property
    def coarse_hw(self):
        return self.image_hw[0] // 8, self.image_hw[1] // 8


def shapes_from_config(model: dict) -> Shapes:
    """The ``model`` block of a configuration file as ``Shapes``."""
    bb, co, fi, ma, rg = (model.get(k, {}) for k in
                          ("backbone", "coarse", "fine", "match", "regress"))
    d = Shapes()
    return Shapes(
        image_hw=tuple(model.get("image_size", d.image_hw)),
        initial_dim=bb.get("initial_dim", d.initial_dim),
        block_dims=tuple(bb.get("block_dims", d.block_dims)),
        d_coarse=co.get("d_model", d.d_coarse), nhead_coarse=co.get("nhead", d.nhead_coarse),
        n_coarse_layers=len(co.get("layer_names", ("self", "cross") * 4)),
        d_fine=fi.get("d_model", d.d_fine), nhead_fine=fi.get("nhead", d.nhead_fine),
        window=fi.get("window_size", d.window), thr=ma.get("thr", d.thr),
        border_rm=ma.get("border_rm", d.border_rm),
        temperature=ma.get("dsmax_temperature", d.temperature),
        max_matches=ma.get("max_matches", d.max_matches),
        emm_heads=rg.get("emm_heads", d.emm_heads), hidden=rg.get("hidden", d.hidden),
        grid_fx=rg.get("grid_fx", d.grid_fx), grid_fy=rg.get("grid_fy", d.grid_fy),
        regress_rt=model.get("regress_rt", True))


def _lin(x, m: nn.Linear, q: Quant):
    return F.linear(q(x), q(m.weight), m.bias)


def _conv(x, m: nn.Conv2d, q: Quant):
    return F.conv2d(q(x), q(m.weight), m.bias, m.stride, m.padding)


def _bn(x, m: nn.BatchNorm2d):
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


def _ln(x, m: nn.LayerNorm):
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, m.eps)


# ---- backbone ------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, 0, bias=False),
                                            nn.BatchNorm2d(planes))

    def run(self, x, q):
        y = F.relu(_bn(_conv(x, self.conv1, q), self.bn1))
        y = _bn(_conv(y, self.conv2, q), self.bn2)
        if self.downsample is not None:
            x = _bn(_conv(x, self.downsample[0], q), self.downsample[1])
        return q(F.relu(x + y))


def _outconv2(mid, out):
    return nn.Sequential(nn.Conv2d(mid, mid, 3, 1, 1, bias=False), nn.BatchNorm2d(mid),
                         nn.LeakyReLU(0.01), nn.Conv2d(mid, out, 3, 1, 1, bias=False))


class Backbone(nn.Module):
    """ResNet-FPN 8/2: coarse 1/8 map (block_dims[2]) and fine 1/2 map
    (block_dims[0]); the x2 upsample bilinear with aligned corners."""

    def __init__(self, s: Shapes):
        super().__init__()
        d0, d1, d2 = s.block_dims
        self.conv1 = nn.Conv2d(1, s.initial_dim, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(s.initial_dim)
        self.layer1 = nn.Sequential(Block(s.initial_dim, d0, 1), Block(d0, d0, 1))
        self.layer2 = nn.Sequential(Block(d0, d1, 2), Block(d1, d1, 1))
        self.layer3 = nn.Sequential(Block(d1, d2, 2), Block(d2, d2, 1))
        self.layer3_outconv = nn.Conv2d(d2, d2, 1, bias=False)
        self.layer2_outconv = nn.Conv2d(d1, d2, 1, bias=False)
        self.layer2_outconv2 = _outconv2(d2, d1)
        self.layer1_outconv = nn.Conv2d(d0, d1, 1, bias=False)
        self.layer1_outconv2 = _outconv2(d1, d0)

    def run(self, x, q):
        def stage(seq, t):
            for blk in seq:
                t = blk.run(t, q)
            return t

        def refine(t, seq):
            t = F.leaky_relu(_bn(_conv(t, seq[0], q), seq[1]), 0.01)
            return _conv(t, seq[3], q)

        def up2(t):
            return F.interpolate(t, scale_factor=2.0, mode="bilinear", align_corners=True)

        x0 = q(F.relu(_bn(_conv(x, self.conv1, q), self.bn1)))
        x1 = stage(self.layer1, x0)
        x2 = stage(self.layer2, x1)
        x3 = stage(self.layer3, x2)
        x3_out = _conv(x3, self.layer3_outconv, q)
        x2_out = refine(_conv(x2, self.layer2_outconv, q) + up2(x3_out), self.layer2_outconv2)
        x1_out = refine(_conv(x1, self.layer1_outconv, q) + up2(x2_out), self.layer1_outconv2)
        return q(x3_out), q(x1_out)


def sine_table(d_model: int, h: int, w: int) -> torch.Tensor:
    """LoFTR's sine position encoding (its temperature fix on), (h, w, C)."""
    pe = np.zeros((d_model, h, w), np.float32)
    y = np.cumsum(np.ones((h, w), np.float32), axis=0)[None]
    x = np.cumsum(np.ones((h, w), np.float32), axis=1)[None]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-math.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x * div)
    pe[1::4] = np.cos(x * div)
    pe[2::4] = np.sin(y * div)
    pe[3::4] = np.cos(y * div)
    return torch.from_numpy(pe.transpose(1, 2, 0).copy())


# ---- LoFTR layers ---------------------------------------------------------------

class EncoderLayer(nn.Module):
    """message = LN1(merge(linear_attention(q(x), k(src), v(src))));
    out = x + LN2(mlp([x, message]))."""

    def __init__(self, C: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(C, C, bias=False)
        self.k_proj = nn.Linear(C, C, bias=False)
        self.v_proj = nn.Linear(C, C, bias=False)
        self.merge = nn.Linear(C, C, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * C, 2 * C, bias=False), nn.ReLU(),
                                 nn.Linear(2 * C, C, bias=False))
        self.norm1 = nn.LayerNorm(C)
        self.norm2 = nn.LayerNorm(C)

    def run(self, x, src, q):
        B, L, C = x.shape
        S, H = src.shape[1], self.nhead
        Q = (F.elu(_lin(x, self.q_proj, q)) + 1.0).reshape(B, L, H, C // H)
        K = (F.elu(_lin(src, self.k_proj, q)) + 1.0).reshape(B, S, H, C // H)
        V = (_lin(src, self.v_proj, q) / S).reshape(B, S, H, C // H)
        KV = torch.einsum("nshd,nshv->nhdv", q(K), q(V))
        Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + 1e-6)
        msg = torch.einsum("nlhd,nhdv->nlhv", q(Q), q(KV)) * Z[..., None] * S
        msg = _ln(_lin(msg.reshape(B, L, C), self.merge, q), self.norm1)
        y = F.relu(_lin(torch.cat([x, msg], dim=-1), self.mlp[0], q))
        return q(x + _ln(_lin(y, self.mlp[2], q), self.norm2))


class Stack(nn.Module):
    def __init__(self, C: int, nhead: int, names):
        super().__init__()
        self.names = tuple(names)
        self.layers = nn.ModuleList([EncoderLayer(C, nhead) for _ in names])

    def run(self, f0, f1, q):
        for name, layer in zip(self.names, self.layers):
            if name == "self":
                f0, f1 = layer.run(f0, f0, q), layer.run(f1, f1, q)
            else:
                f0 = layer.run(f0, f1, q)
                f1 = layer.run(f1, f0, q)
        return f0, f1


# ---- regressor -----------------------------------------------------------------

def epipolar_basis(h, w, fx, fy) -> torch.Tensor:
    """[y^2, x^2, xy, y, x, 1] of the K^-1-normalised coarse grid, (h*w, 6)."""
    fxn, fyn = fx / w * 2.0, fy / h * 2.0
    x = torch.linspace(-1.0, 1.0, w)[None, :].expand(h, w) / fxn
    y = torch.linspace(-1.0, 1.0, h)[:, None].expand(h, w) / fyn
    return torch.stack([y * y, x * x, x * y, y, x, torch.ones_like(x)], -1).reshape(h * w, 6)


class CrossAttn(nn.Module):
    def __init__(self, C, H):
        super().__init__()
        self.qkv = nn.Linear(C, 3 * C)
        self.proj_fundamental = nn.Linear(H * (C // H + 6), C)


class Mlp(nn.Module):
    def __init__(self, C, hidden):
        super().__init__()
        self.fc1 = nn.Linear(C, hidden)
        self.fc2 = nn.Linear(hidden, C)


class EMM(nn.Module):
    def __init__(self, C, H):
        super().__init__()
        self.norm1 = nn.LayerNorm(C)
        self.cross_attn = CrossAttn(C, H)
        self.norm2 = nn.LayerNorm(C)
        self.mlp = Mlp(C, 4 * C)


def _seq(*dims):
    mods = []
    for i in range(len(dims) - 1):
        if i:
            mods.append(nn.ReLU())
        mods.append(nn.Linear(dims[i], dims[i + 1]))
    return nn.Sequential(*mods)


def _run_seq(seq, x, q):
    for m in seq:
        x = _lin(x, m, q) if isinstance(m, nn.Linear) else F.relu(x)
    return x


class Regressor(nn.Module):
    def __init__(self, s: Shapes):
        super().__init__()
        C, H, hid = s.d_coarse, s.emm_heads, s.hidden
        self.s = s
        self.emm = EMM(C, H)
        self.norm = nn.LayerNorm(C, eps=1e-6)
        feat = 2 * (C // H + 6) * C
        self.encoder = _seq(feat, hid, hid)
        self.pose_regressor_simple_moe = _seq(hid, hid, 9)
        self.moe_predictor = _seq(feat + 9 + 13, hid, hid, 2)

    def features(self, t0, t1, q: Quant = identity):
        """(B, 2 (D + 6) C) EMM features of the two token sets."""
        s = self.s
        B, N, C = t0.shape
        H = s.emm_heads
        D = C // H
        a = self.emm.cross_attn
        h, w = s.coarse_hw
        pos = epipolar_basis(h, w, s.grid_fx, s.grid_fy).to(t0.device)

        def split(x):
            t = _lin(_ln(x, self.emm.norm1), a.qkv, q).reshape(B, N, 3, H, D)
            t = t.permute(2, 0, 3, 1, 4)
            return t[0], t[1], torch.cat([t[2], pos[None, None].expand(B, H, N, 6)], -1)

        q0, k0, v0 = split(t0)
        q1, k1, v1 = split(t1)

        def bilinear(qq, kk, vv):  # v^T (softmax_r(S) * softmax_c(S)) v, one head at a time
            out = []
            for b in range(B):
                for hh in range(H):
                    S_ = (q(qq[b, hh]) @ q(kk[b, hh]).t()) * D ** -0.5
                    A = torch.softmax(S_, -1) * torch.softmax(S_, -2)
                    vf = vv[b, hh]
                    out.append(q(vf).t() @ q(q(A) @ q(vf)))
            return torch.stack(out).reshape(B, H * (D + 6), D + 6).transpose(-1, -2)

        f1 = _lin(bilinear(q1, k0, v0), a.proj_fundamental, q)  # image-1 queries
        f2 = _lin(bilinear(q0, k1, v1), a.proj_fundamental, q)
        fund = torch.cat([f2, f1], dim=1)
        m = self.emm.mlp
        fund = q(fund + _lin(F.gelu(_lin(_ln(fund, self.emm.norm2), m.fc1, q)), m.fc2, q))
        return q(_ln(fund, self.norm).reshape(B, -1))

    def fuse(self, feats, solver_in, q: Quant = identity):
        """MoE fusion -> (pose_9d, gate), as FAR's simple MoE with two weights."""
        mean = torch.tensor(POSE_MEAN_6D, device=feats.device)
        std = torch.tensor(POSE_STD_6D, device=feats.device)
        reg = _run_seq(self.pose_regressor_simple_moe, _run_seq(self.encoder, feats, q), q)
        sp = solver_in
        reg_t, solver_t, solver_rot = reg[..., :3], sp[..., :3], sp[..., 3:9]
        solver_t_un = solver_t * std[:3] + mean[:3]
        reg_t_un = reg_t * std[:3] + mean[:3]
        norm_reg = torch.linalg.norm(reg_t_un, dim=-1, keepdim=True)
        norm_sol = torch.linalg.norm(solver_t_un, dim=-1, keepdim=True).clamp(1e-3, 100.0)
        solver_t = (solver_t_un * norm_reg / norm_sol - mean[:3]) / std[:3]
        gate = torch.sigmoid(_run_seq(self.moe_predictor,
                                      torch.cat([feats, reg, sp], -1), q))
        w_t, w_r = gate[..., 0:1], gate[..., 1:2]
        pred_t = w_t * reg_t + (1.0 - w_t) * solver_t
        pred_r = w_r * reg[..., 3:] + (1.0 - w_r) * solver_rot
        return torch.cat([pred_t, pred_r], -1), gate


def normalized_9d(rt: torch.Tensor) -> torch.Tensor:
    """(B, 3, 4) pose -> (t, first two rotation rows), standardised."""
    mean = torch.tensor(POSE_MEAN_6D, device=rt.device)
    std = torch.tensor(POSE_STD_6D, device=rt.device)
    raw = torch.cat([rt[..., :3, 3], matrix_to_rotation_6d(rt[..., :3, :3])], -1)
    return (raw - mean) / std


def denormalize_9d(p: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(POSE_MEAN_6D, device=p.device)
    std = torch.tensor(POSE_STD_6D, device=p.device)
    raw = p * std + mean
    return torch.cat([rotation_6d_to_matrix(raw[..., 3:]), raw[..., :3, None]], -1)


# ---- the model ------------------------------------------------------------------

class FineMerge(nn.Module):
    def __init__(self, Cc, Cf):
        super().__init__()
        self.down_proj = nn.Linear(Cc, Cf)
        self.merge_feat = nn.Linear(2 * Cf, Cf)


class FarReference(nn.Module):
    def __init__(self, s: Shapes):
        super().__init__()
        self.s = s
        self.backbone = Backbone(s)
        self.loftr_coarse = Stack(s.d_coarse, s.nhead_coarse,
                                  ("self", "cross") * (s.n_coarse_layers // 2))
        self.fine_preprocess = FineMerge(s.d_coarse, s.d_fine)
        self.loftr_fine = Stack(s.d_fine, s.nhead_fine, ("self", "cross"))
        if s.regress_rt:
            self.loftr_regress = Regressor(s)

    def coarse(self, image0, image1, q: Quant = identity):
        """(B, H, W, 1) pair -> transformed tokens t0, t1 (B, L, C) and the
        fine maps (B, Hf, Wf, Cf)."""
        B = image0.shape[0]
        h, w = self.s.coarse_hw
        imgs = torch.cat([image0, image1]).permute(0, 3, 1, 2).float()
        fc, ff = self.backbone.run(imgs, q)
        t = fc.permute(0, 2, 3, 1) + sine_table(fc.shape[1], h, w).to(fc.device)
        t = q(t.reshape(2 * B, h * w, -1))
        t0, t1 = self.loftr_coarse.run(t[:B], t[B:], q)
        ff = ff.permute(0, 2, 3, 1)
        return t0, t1, ff[:B], ff[B:]

    def confidence(self, t0, t1, q: Quant = identity):
        """Dual-softmax confidences (B, L, S)."""
        C = t0.shape[-1]
        sim = q(t0 / C ** 0.5) @ q(t1 / C ** 0.5).transpose(1, 2) / self.s.temperature
        return torch.softmax(sim, 1) * torch.softmax(sim, 2)

    def select(self, conf):
        """Mutual nearest neighbours over the threshold, off the border, the
        K most confident in order -> (i_ids, j_ids, mconf, valid)."""
        s = self.s
        h, w = s.coarse_hw
        b = s.border_rm
        ys, xs = torch.meshgrid(torch.arange(h, device=conf.device),
                                torch.arange(w, device=conf.device), indexing="ij")
        inner = ((ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)).reshape(-1)
        row_val, j = conf.max(dim=2)
        col_max = conf.amax(dim=1)
        ok = (row_val >= torch.gather(col_max, 1, j)) & (row_val > s.thr) \
            & inner[None] & inner[j]
        score = torch.where(ok, row_val, torch.zeros_like(row_val))
        mconf, i_ids = torch.sort(score, dim=-1, descending=True, stable=True)
        k = min(s.max_matches, score.shape[1])
        mconf, i_ids = mconf[:, :k], i_ids[:, :k]
        return i_ids, torch.gather(j, 1, i_ids), mconf, mconf > 0

    def fine(self, ff0, ff1, t0, t1, i_ids, j_ids, q: Quant = identity):
        """Soft-argmax refinement at the given coarse matches -> (B, K, 2)
        offsets in window units (x, y), the window centred at j."""
        s = self.s
        W, Cf = s.window, s.d_fine
        h, w = s.coarse_hw
        r = W // 2
        B, K = i_ids.shape

        def windows(ff, ids):
            Hf, Wf = ff.shape[1:3]
            pad = F.pad(ff, (0, 0, r, r + max(0, 4 * (w - 1) + W - (Wf + 2 * r)),
                             r, r + max(0, 4 * (h - 1) + W - (Hf + 2 * r))))
            y0 = torch.div(ids, w, rounding_mode="floor") * 4
            x0 = (ids % w) * 4
            ar = torch.arange(W, device=ids.device)
            bb = torch.arange(B, device=ids.device)[:, None, None, None]
            out = pad[bb, (y0[..., None] + ar)[:, :, :, None], (x0[..., None] + ar)[:, :, None, :]]
            return out.reshape(B, K, W * W, Cf)

        fp = self.fine_preprocess
        wm = fp.merge_feat.weight

        def merge(ff, tok, ids):
            c = torch.gather(tok, 1, ids[..., None].expand(-1, -1, tok.shape[-1]))
            c = _lin(c, fp.down_proj, q)
            ctx = F.linear(q(c), q(wm[:, Cf:]), fp.merge_feat.bias)
            return q(F.linear(q(windows(ff, ids)), q(wm[:, :Cf])) + ctx[..., None, :])

        f0 = merge(ff0, t0, i_ids).reshape(B * K, W * W, Cf)
        f1 = merge(ff1, t1, j_ids).reshape(B * K, W * W, Cf)
        f0, f1 = self.loftr_fine.run(f0, f1, q)
        f0 = f0.reshape(B, K, W * W, Cf)
        f1 = f1.reshape(B, K, W * W, Cf)
        sim = torch.einsum("bkc,bkrc->bkr", q(f0[:, :, W * W // 2]), q(f1)) / Cf ** 0.5
        heat = q(torch.softmax(sim, -1))
        ax = torch.linspace(-1.0, 1.0, W, device=sim.device)
        grid = torch.stack([ax.repeat(W), ax.repeat_interleave(W)], -1)
        return heat @ grid


def ids_to_px(ids, w, scale: Optional[torch.Tensor]):
    """Coarse index -> pixel <x, y> at the image's resolution (stride 8)."""
    pts = torch.stack([(ids % w).float() * 8.0,
                       torch.div(ids, w, rounding_mode="floor").float() * 8.0], -1)
    return pts if scale is None else pts * scale[:, None, :]
