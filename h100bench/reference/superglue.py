"""Plain float32 reference of SuperPoint + SuperGlue.

Written from magicleap's published modules (SuperGluePretrainedNetwork,
``models/superpoint.py`` and ``models/superglue.py``; DeTone et al.,
CVPRW 2018; Sarlin et al., CVPR 2020, arXiv 1911.11763) in plain torch:

- SuperPoint: the VGG encoder at 1/8, the 65-way cell detector (softmax,
  dustbin dropped, each cell's 64 channels laid out as its 8x8 pixels),
  ``simple_nms`` (the max-pool equality and two suppression passes), the
  4-pixel border cleared, the keypoints over ``keypoint_threshold`` and
  the ``max_keypoints`` best of them, the descriptor head L2-normalised
  and read by ``sample_descriptors`` (``grid_sample`` with aligned
  corners at (x - s/2 + 0.5) / (w s - s/2 - 0.5), s = 8, normalised
  again);
- SuperGlue: keypoints normalised by 0.7 of the image's longer side, the
  keypoint encoder 3 -> 32 -> 64 -> 128 -> 256 -> D, 9 x (self, cross)
  attentional propagation (4 heads, x + MLP([x, attention]), MLP 2D -> 2D
  -> D), one ``final_proj`` for both images, scores over sqrt(D),
  ``log_optimal_transport`` with the learned dustbin over the valid
  counts m and n, and the mutual argmax over ``match_threshold``.

Departures, each kept by the program too:

- the BatchNorm of each MLP (keypoint encoder, GNN) in eval mode is
  folded into the linear layer before it, as the converter of the
  published weights folds it: a plain linear layer here;
- the heads of the attention are contiguous channel blocks (channel
  h d + j of head h), where magicleap's ``view`` interleaves them
  (channel j heads + h); the converter regroups the published rows;
- every side holds K = ``max_keypoints`` slots, the slots past the
  detections padded and masked: their keys, scores, dustbin entries
  and log marginals at -1e9, so they take no mass and the valid slots'
  answers are those of the unpadded model. Keypoints are
  ranked by a stable sort (the lower pixel index first on ties).

Parameters are named as the program's (``SuperGlueMatcher``: children
``superpoint`` and ``superglue``), except that the program's second
final projection, ``final_proj2``, is this ``final_proj`` again. Every
product's operands and every layer's output go through ``quant``, as in
``far.py``. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.far import Quant, identity

MASKED = -1e9
BORDER = 4
KENC = (32, 64, 128, 256)
ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")
POOL_AFTER = ("conv1b", "conv2b", "conv3b")


@dataclass(frozen=True)
class Shapes:
    """The configuration's sizes that the reference needs."""
    image_hw: Tuple[int, int] = (720, 544)
    channels: Tuple[int, int, int, int] = (64, 64, 128, 128)
    desc_dim: int = 256
    nms_radius: int = 3
    keypoint_threshold: float = 0.005
    max_keypoints: int = 2048
    num_layers: int = 9
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2


def shapes_from_config(config: dict) -> Shapes:
    """A configuration file's ``image_hw``, ``superpoint`` and ``superglue``
    blocks as ``Shapes``."""
    sp, sg = config["superpoint"], config["superglue"]
    return Shapes(image_hw=tuple(config["image_hw"]), channels=tuple(sp["channels"]),
                  desc_dim=sp["desc_dim"], nms_radius=sp["nms_radius"],
                  keypoint_threshold=sp["keypoint_threshold"],
                  max_keypoints=sp["max_keypoints"], num_layers=sg["num_layers"],
                  num_heads=sg["num_heads"], sinkhorn_iterations=sg["sinkhorn_iterations"],
                  match_threshold=sg["match_threshold"])


def _conv(x, m: nn.Conv2d, q: Quant):
    return F.conv2d(q(x), q(m.weight), m.bias, m.stride, m.padding)


def _lin(x, m: nn.Linear, q: Quant):
    return F.linear(q(x), q(m.weight), m.bias)


# ---- SuperPoint ----------------------------------------------------------------------

def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """magicleap's ``simple_nms`` on (B, H, W) scores."""
    def max_pool(x):
        return F.max_pool2d(x, kernel_size=radius * 2 + 1, stride=1, padding=radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def sample_descriptors(keypoints: torch.Tensor, descriptors: torch.Tensor, s: int = 8):
    """magicleap's ``sample_descriptors``: (B, K, 2) <x, y> pixels, (B, D, h,
    w) -> (B, K, D) unit descriptors."""
    b, c, h, w = descriptors.shape
    keypoints = keypoints - s / 2 + 0.5
    keypoints = keypoints / keypoints.new_tensor([(w * s - s / 2 - 0.5),
                                                  (h * s - s / 2 - 0.5)])[None]
    keypoints = keypoints * 2 - 1
    descriptors = F.grid_sample(descriptors, keypoints.view(b, 1, -1, 2), mode="bilinear",
                                align_corners=True)
    return F.normalize(descriptors.reshape(b, c, -1), p=2, dim=1).transpose(1, 2)


class SuperPointReference(nn.Module):
    def __init__(self, s: Shapes):
        super().__init__()
        self.s = s
        c1, c2, c3, c4 = s.channels
        cin = 1
        for name, cout in zip(ENCODER, (c1, c1, c2, c2, c3, c3, c4, c4)):
            self.add_module(name, nn.Conv2d(cin, cout, 3, 1, 1))
            cin = cout
        self.convPa = nn.Conv2d(c4, 256, 3, 1, 1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(c4, 256, 3, 1, 1)
        self.convDb = nn.Conv2d(256, s.desc_dim, 1)

    def dense(self, image, q: Quant = identity):
        """(B, H, W, 1) -> (the detector's heat (B, H, W) before NMS, the
        unit descriptor map (B, D, H/8, W/8))."""
        x = image.permute(0, 3, 1, 2).float()
        for name in ENCODER:
            x = q(F.relu(_conv(x, getattr(self, name), q)))
            if name in POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        scores = _conv(q(F.relu(_conv(x, self.convPa, q))), self.convPb, q)
        scores = F.softmax(scores, 1)[:, :-1]
        b, _, h, w = scores.shape
        scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
        scores = scores.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)
        desc = _conv(q(F.relu(_conv(x, self.convDa, q))), self.convDb, q)
        return scores, F.normalize(desc, p=2, dim=1)

    def nms_heat(self, heat):
        """The heat after NMS with the border cleared."""
        s = self.s
        heat = simple_nms(heat[:, None], s.nms_radius)[:, 0]
        H, W = heat.shape[1:]
        keep = torch.zeros_like(heat)
        keep[:, BORDER:H - BORDER, BORDER:W - BORDER] = 1.0
        return heat * keep

    def detect(self, image, q: Quant = identity):
        """(B, H, W, 1) -> keypoints (B, K, 2) <x, y>, scores (B, K), valid
        (B, K), unit descriptors (B, K, D): the K best of the NMS'd heat,
        valid over the threshold."""
        heat, desc = self.dense(image, q)
        nms = self.nms_heat(heat)
        W = nms.shape[2]
        scores, idx = torch.sort(nms.flatten(1), dim=-1, descending=True, stable=True)
        scores, idx = scores[:, :self.s.max_keypoints], idx[:, :self.s.max_keypoints]
        kpts = torch.stack([idx % W, idx // W], -1).float()
        return kpts, scores, scores > self.s.keypoint_threshold, sample_descriptors(kpts, desc)


# ---- SuperGlue -----------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, D):
        super().__init__()
        self.q, self.k, self.v, self.merge = (nn.Linear(D, D) for _ in range(4))


class Propagation(nn.Module):
    """x + MLP([x, attention(x, source)]), one GNN layer."""

    def __init__(self, D):
        super().__init__()
        self.attn = Attention(D)
        self.fc1 = nn.Linear(2 * D, 2 * D)
        self.fc2 = nn.Linear(2 * D, D)

    def run(self, x, source, s_valid, heads: int, q: Quant):
        B, N, D = x.shape
        d = D // heads
        split = lambda t: t.reshape(B, -1, heads, d).transpose(1, 2)
        qq = split(_lin(x, self.attn.q, q))
        kk = split(_lin(source, self.attn.k, q))
        vv = split(_lin(source, self.attn.v, q))
        logits = torch.einsum("bhnd,bhmd->bhnm", q(qq), q(kk)) / d ** 0.5
        prob = F.softmax(logits.masked_fill(~s_valid[:, None, None, :], MASKED), -1)
        msg = torch.einsum("bhnm,bhmd->bhnd", q(prob), q(vv)).transpose(1, 2).reshape(B, N, D)
        msg = _lin(msg, self.attn.merge, q)
        y = _lin(q(F.relu(_lin(torch.cat([x, msg], -1), self.fc1, q))), self.fc2, q)
        return q(x + y)


def log_optimal_transport(scores, alpha, iters: int, valid0, valid1):
    """magicleap's ``log_optimal_transport`` over the valid slots (m, n of
    them a pair); a padded slot's scores, dustbin entries and log mass at
    -1e9, so each iteration is the unpadded one's on the valid slots."""
    b, m_, n_ = scores.shape
    ms = valid0.sum(-1, keepdim=True).float()
    ns = valid1.sum(-1, keepdim=True).float()
    bins0 = torch.where(valid0[..., None], alpha.expand(b, m_, 1), MASKED)
    bins1 = torch.where(valid1[:, None], alpha.expand(b, 1, n_), MASKED)
    alpha = alpha.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, alpha], -1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([torch.where(valid0, norm, MASKED), ns.log() + norm], 1)
    log_nu = torch.cat([torch.where(valid1, norm, MASKED), ms.log() + norm], 1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v.unsqueeze(1), dim=2)
        v = log_nu - torch.logsumexp(couplings + u.unsqueeze(2), dim=1)
    return couplings + u.unsqueeze(2) + v.unsqueeze(1) - norm[..., None]


class SuperGlueReference(nn.Module):
    def __init__(self, s: Shapes):
        super().__init__()
        self.s = s
        D = s.desc_dim
        widths = (3,) + KENC + (D,)
        for i in range(len(widths) - 1):
            self.add_module(f"kenc_{i}", nn.Linear(widths[i], widths[i + 1]))
        for i in range(s.num_layers):
            self.add_module(f"self_{i}", Propagation(D))
            self.add_module(f"cross_{i}", Propagation(D))
        self.final_proj = nn.Linear(D, D)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def encode(self, kpts, scores, desc, q: Quant):
        H, W = self.s.image_hw
        size = kpts.new_tensor([W, H])
        x = torch.cat([(kpts - size / 2) / (size.max() * 0.7), scores[..., None]], -1)
        n = len(KENC) + 1
        for i in range(n):
            x = _lin(x, getattr(self, f"kenc_{i}"), q)
            if i < n - 1:
                x = q(F.relu(x))
        return q(desc + x)

    def scores(self, kpts0, scores0, valid0, desc0, kpts1, scores1, valid1, desc1,
               q: Quant = identity):
        """The (B, K, K) score matrix, -1e9 where either slot is padded."""
        s = self.s
        x0 = self.encode(kpts0, scores0, desc0, q)
        x1 = self.encode(kpts1, scores1, desc1, q)
        for i in range(s.num_layers):
            sl, cl = getattr(self, f"self_{i}"), getattr(self, f"cross_{i}")
            x0, x1 = sl.run(x0, x0, valid0, s.num_heads, q), sl.run(x1, x1, valid1, s.num_heads, q)
            x0, x1 = (cl.run(x0, x1, valid1, s.num_heads, q),
                      cl.run(x1, x0, valid0, s.num_heads, q))
        m0, m1 = _lin(x0, self.final_proj, q), _lin(x1, self.final_proj, q)
        sc = torch.einsum("bnd,bmd->bnm", q(m0), q(m1)) / s.desc_dim ** 0.5
        return sc.masked_fill(~(valid0[:, :, None] & valid1[:, None, :]), MASKED)

    def assignment(self, scores, valid0, valid1):
        """(B, K, K) exp of the transport's log assignment, dustbins left
        out."""
        Z = log_optimal_transport(scores, self.bin_score, self.s.sinkhorn_iterations, valid0,
                                  valid1)
        return Z[:, :-1, :-1].exp()

    def select(self, P, valid0):
        """magicleap's mutual argmax over ``match_threshold``: (matches0
        (B, K) int64 or -1, mscores0 (B, K))."""
        max0, max1 = P.max(2), P.max(1)
        idx0, idx1 = max0.indices, max1.indices
        mutual0 = torch.arange(P.shape[1], device=P.device)[None] == idx1.gather(1, idx0)
        ok = mutual0 & (max0.values > self.s.match_threshold) & valid0
        return torch.where(ok, idx0, -1), torch.where(ok, max0.values, 0.0)


class SuperPointSuperGlueReference(nn.Module):
    """The two under the program's child names."""

    def __init__(self, s: Shapes):
        super().__init__()
        self.s = s
        self.superpoint = SuperPointReference(s)
        self.superglue = SuperGlueReference(s)


def heat_at(heat, kpts):
    """(B, H, W) read at integer keypoints (B, K, 2) <x, y> -> (B, K)."""
    W = heat.shape[2]
    idx = (kpts[..., 1].long() * W + kpts[..., 0].long()).clamp(0, heat[0].numel() - 1)
    return heat.flatten(1).gather(1, idx)

