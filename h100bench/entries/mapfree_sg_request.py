"""Map-free FAR inference with SuperPoint + SuperGlue as its matcher,
through the compiled request, ``build_mapfree_fn``.

As ``mapfree_request.py``, whose pool, draws, request, sample and blocks
this entry keeps (its ``Session``), with another matcher: set-up builds
``SuperGlueMatcher`` (SuperPoint and SuperGlue from the configuration's
``superpoint`` and ``superglue`` blocks) and the regressor on the device,
loads weights made from the seed (``reference/weights.py``, one draw for
the detector, the matcher and the regressor; the program's two final
projections both take the reference's one ``final_proj``), and runs
request 0 twice: the first call captures the CUDA graph, the second
replays it. The check runs the plain references
(``reference/judge_mapfree_sg.py``) over the sampled requests, in blocks
of pairs.

Traffic keys: those of ``mapfree_request.py``.
"""

from __future__ import annotations

import random
import statistics
from dataclasses import fields
from pathlib import Path
from types import SimpleNamespace

import torch

from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.superglue import SuperGlueConfig
from far_tpu_torch.models.superglue_matcher import SuperGlueMatcher
from far_tpu_torch.models.superpoint import SuperPointConfig
from far_tpu_torch.pipeline import build_mapfree_fn
from h100bench.common import (PAIRS, SAMPLE, UNIFORMS, WEIGHTS, build, pin, state_shapes,
                              sub_seed)
from h100bench.reference import judge_mapfree_sg as jsg
from h100bench.reference import sixdreg as rs
from h100bench.reference import superglue as rsg
from h100bench.reference.far import fp8
from h100bench.reference.synthetic import make_pairs
from h100bench.reference.weights import make_state_dict
from h100bench.trace import load_module

base = load_module(Path(__file__).resolve().parent / "mapfree_request.py")
PARTS = ("matcher.", "regressor.")


class References(torch.nn.Module):
    """The two references under one state dict: ``matcher.*`` (SuperPoint
    and SuperGlue), ``regressor.*``, the program's names after the
    prefix."""

    def __init__(self, config: dict):
        super().__init__()
        self.matcher = rsg.SuperPointSuperGlueReference(rsg.shapes_from_config(config))
        self.regressor = rs.SixDRegReference(rs.shapes_from_config(config["regressor"]))


def weights(config: dict, seed: int, device) -> dict:
    """The state dict of the references, one draw from the seed's weight
    stream."""
    return make_state_dict(state_shapes(lambda: References(config)),
                           sub_seed(seed, WEIGHTS), device)


def matcher_state(sd: dict) -> dict:
    """The program's matcher state from the references': SuperGlue's one
    final projection in both of the program's."""
    out = base.part(sd, PARTS[0])
    for k in list(out):
        if k.startswith("superglue.final_proj."):
            out[k.replace("final_proj.", "final_proj2.")] = out[k]
    return out


class Session(base.Session):
    def __init__(self, ctx, program: bool = True):
        wl, dev, c = ctx.workload, ctx.device, ctx.config
        self.ctx = ctx
        self.sp_cfg = build(SuperPointConfig, c["superpoint"])
        self.sg_cfg = build(SuperGlueConfig, c["superglue"])
        self.reg_cfg = build(SixDRegConfig, c["regressor"])
        self.batch = B = wl["batch"]
        self.device = dev
        P, U = wl["pool_pairs"], wl["uniform_slots"]
        if P % B:
            raise ValueError(f"pool_pairs {P} is not a multiple of batch {B}")
        g = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, PAIRS))
        img0, img1, K, reg0, reg1, _ = make_pairs(P, tuple(c["image_hw"]), g, dev, channels=3,
                                                  extra_hw=self.reg_cfg.image_hw)
        gray = lambda im: im.mean(-1, keepdim=True)
        self.pool = pin((gray(img0), gray(img1), K, reg0, reg1), dev)
        del img0, img1, K, reg0, reg1
        gu = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, UNIFORMS))
        self.uniforms = []
        for r, cfg in enumerate(jsg.solver_configs()):
            n, S, _ = cfg.ransac_config(r > 0).sampling()
            self.uniforms.append(torch.rand((U, B, n, S), generator=gu, device=dev))
        sp, sg = self.sp_cfg, self.sg_cfg
        self.shapes = dict(
            B=B, image_hw=tuple(c["image_hw"]), channels=tuple(sp.channels), D=sg.desc_dim,
            K=sp.max_keypoints, layers=sg.num_layers, heads=sg.num_heads,
            iters=sg.sinkhorn_iterations, rounds=len(self.uniforms),
            reg_hw=tuple(self.reg_cfg.image_hw), reg_blocks=tuple(self.reg_cfg.encoder_blocks),
            reg_out=self.reg_cfg.encoder_out_layers, reg_layers=self.reg_cfg.transformer_layers,
            reg_hidden=self.reg_cfg.hidden)
        self.outputs, self.answered = [], 0
        self.sampler = random.Random(sub_seed(ctx.seed, SAMPLE))
        if not program:
            return
        sd = weights(c, ctx.seed, dev)
        with torch.device(dev):
            matcher, reg = SuperGlueMatcher(sp, sg), MapfreeRegression(self.reg_cfg)
        matcher.load_state_dict(matcher_state(sd))
        reg.load_state_dict(base.part(sd, PARTS[1]))
        del sd
        self.models = (matcher.eval(), reg.eval())
        self.fn = build_mapfree_fn(*self.models)
        self.request(0, keep=False)
        self.request(0, keep=False)

    def stats(self) -> str:
        """Median valid keypoints and matches a pair, inliers, and the
        gate's range, over the sampled requests."""
        m = [o.matches for _, o in self.outputs]
        kpts = torch.cat([x.kvalid0.float().sum(-1) for x in m]
                         + [x.kvalid1.float().sum(-1) for x in m])
        valid = torch.cat([x.valid.float().sum(-1) for x in m])
        inl = torch.cat([o.num_inliers.float() for _, o in self.outputs])
        gate = torch.cat([o.gating.float() for _, o in self.outputs])
        lo, hi = gate.amin(0).tolist(), gate.amax(0).tolist()
        med = lambda t: statistics.median(t.tolist())
        return (f"valid keypoints an image median {med(kpts)} least {kpts.min().item()}, "
                f"valid matches a pair median {med(valid)} least {valid.min().item()}, "
                f"median inliers a pair {med(inl)}, gate (t) {lo[0]:.6g}..{hi[0]:.6g}, "
                f"gate (R) {lo[1]:.6g}..{hi[1]:.6g} over the {len(self.outputs)} sampled "
                f"requests (match_threshold {self.sg_cfg.match_threshold})")

    def _references(self):
        ref = References(self.ctx.config).to(self.device)
        ref.load_state_dict(weights(self.ctx.config, self.ctx.seed, self.device))
        return ref.eval()

    def check(self) -> dict:
        """The program's state freed, the references judge the sampled
        requests' pairs in blocks of ``check_block``."""
        kept = sorted(self.outputs, key=lambda x: x[0])
        self.outputs, self.fn, self.models = [], None, None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ref = self._references()
        outs = [dict(**{f.name: getattr(o.matches, f.name) for f in fields(o.matches)}, E=o.E,
                     num_inliers=o.num_inliers, solver_rt=o.solver_rt,
                     regressed_9d=o.regressed_9d, gating=o.gating, R=o.R, t=o.t)
                for _, o in kept]
        outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        parts = []
        for b, (img0, img1, K, reg0, reg1), u in self.blocks([i for i, _ in kept]):
            blk = SimpleNamespace(**{k: v[b] for k, v in outs.items()})
            parts.append(jsg.judge(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                   blk, u))
        return jsg.merge(parts)

    def control(self, rng, quant=fp8) -> dict:
        """The control: the references through ``quant`` in the program's
        place, on as many requests as a run judges, judged the same way."""
        ref = self._references()
        wl = self.ctx.workload
        parts = []
        for _, (img0, img1, K, reg0, reg1), u in self.blocks(
                rng.sample(range(wl["check_pool"]), wl["check_requests"])):
            out = jsg.mapfree_forward(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                      u, quant)
            parts.append(jsg.judge(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                   out, u))
        return jsg.merge(parts)


def setup(ctx) -> Session:
    return Session(ctx)
