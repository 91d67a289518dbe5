"""Map-free FAR inference through the compiled request, ``build_mapfree_fn``.

Set-up builds the matcher (``FARLoFTR`` with ``regress_rt`` off) and the
regressor (``MapfreeRegression``) on the device from the configuration
file, loads weights made from the seed (``reference/weights.py``, one
draw for both), makes the pool of synthetic scenes on the device and
keeps it in pinned host memory (each scene seen at the matcher's size in
grayscale and at the regressor's in RGB), draws both rounds' solver
uniforms for a pool of request slots, and runs request 0 twice: the first
call captures the CUDA graph, the second replays it. A request copies its
B pairs of both sizes from the pinned pool to the card, replays the graph
with its slot's uniforms, and reads R, t and the gate back on the host.
Only the outputs of ``check_requests`` requests stay on the device, a
sample of every request answered, drawn from the seed as they come
(reservoir sampling). The check runs the plain references
(``reference/judge_mapfree.py``) over that sample, in blocks of pairs.

Traffic keys: ``batch``, ``pool_pairs`` (a multiple of ``batch``),
``uniform_slots``, ``check_requests``, ``check_pool``, ``check_block``,
``trace_requests``.
"""

from __future__ import annotations

import random
import statistics
from types import SimpleNamespace

import torch

from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.pipeline import build_mapfree_fn
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.config import FARConfig
from h100bench.common import (PAIRS, SAMPLE, UNIFORMS, WEIGHTS, build, pin, state_shapes,
                              sub_seed)
from h100bench.reference import judge_mapfree as jm
from h100bench.reference import sixdreg as rs
from h100bench.reference.far import FarReference, fp8, shapes_from_config
from h100bench.reference.synthetic import make_pairs
from h100bench.reference.weights import make_state_dict

PARTS = ("matcher.", "regressor.")


class References(torch.nn.Module):
    """The two references under one state dict: ``matcher.*``,
    ``regressor.*``, the program's names after the prefix."""

    def __init__(self, config: dict):
        super().__init__()
        self.matcher = FarReference(shapes_from_config(config["model"]))
        self.regressor = rs.SixDRegReference(rs.shapes_from_config(config["regressor"]))


def weights(config: dict, seed: int, device) -> dict:
    """The state dict of both models, one draw from the seed's weight
    stream."""
    return make_state_dict(state_shapes(lambda: References(config)),
                           sub_seed(seed, WEIGHTS), device)


def part(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class Session:
    def __init__(self, ctx, program: bool = True):
        wl, dev = ctx.workload, ctx.device
        self.ctx = ctx
        self.cfg = build(FARConfig, ctx.config["model"])
        self.reg_cfg = build(SixDRegConfig, ctx.config["regressor"])
        self.batch = B = wl["batch"]
        self.device = dev
        P, U = wl["pool_pairs"], wl["uniform_slots"]
        if P % B:
            raise ValueError(f"pool_pairs {P} is not a multiple of batch {B}")
        g = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, PAIRS))
        img0, img1, K, reg0, reg1, _ = make_pairs(P, self.cfg.image_size, g, dev, channels=3,
                                                  extra_hw=self.reg_cfg.image_hw)
        gray = lambda im: im.mean(-1, keepdim=True)
        self.pool = pin((gray(img0), gray(img1), K, reg0, reg1), dev)
        del img0, img1, K, reg0, reg1
        gu = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, UNIFORMS))
        self.uniforms = []
        for r, cfg in enumerate(jm.solver_configs()):
            n, S, _ = cfg.ransac_config(r > 0).sampling()
            self.uniforms.append(torch.rand((U, B, n, S), generator=gu, device=dev))
        sh = self.cfg
        self.shapes = dict(
            B=B, L=sh.coarse_hw[0] * sh.coarse_hw[1], C=sh.coarse.d_model,
            nhead=sh.coarse.nhead, n_coarse_layers=len(sh.coarse.layer_names),
            K=sh.match.max_matches, WW=sh.fine.window_size ** 2, Cf=sh.fine.d_model,
            Hf=sh.fine.nhead, e=2 if sh.dtype == "bfloat16" else 4, rounds=len(self.uniforms),
            image_hw=tuple(sh.image_size), initial_dim=sh.backbone.initial_dim,
            block_dims=tuple(sh.backbone.block_dims), reg_hw=tuple(self.reg_cfg.image_hw),
            reg_blocks=tuple(self.reg_cfg.encoder_blocks),
            reg_out=self.reg_cfg.encoder_out_layers, reg_layers=self.reg_cfg.transformer_layers,
            reg_hidden=self.reg_cfg.hidden)
        self.outputs, self.answered = [], 0
        self.sampler = random.Random(sub_seed(ctx.seed, SAMPLE))
        if not program:
            return
        sd = weights(ctx.config, ctx.seed, dev)
        with torch.device(dev):
            matcher, reg = FARLoFTR(self.cfg), MapfreeRegression(self.reg_cfg)
        matcher.load_state_dict(part(sd, PARTS[0]))
        reg.load_state_dict(part(sd, PARTS[1]))
        del sd
        self.models = (matcher.eval(), reg.eval())
        self.fn = build_mapfree_fn(*self.models)
        self.request(0, keep=False)
        self.request(0, keep=False)

    def inputs(self, i: int, on=None):
        """The pairs of request i at both sizes, copied to the device."""
        B, P = self.batch, self.pool[0].shape[0]
        s = (i * B) % P
        dev = on or self.device
        return [t[s:s + B].to(dev, non_blocking=True) for t in self.pool]

    def slot(self, i: int):
        return [u[i % u.shape[0]] for u in self.uniforms]

    def request(self, i: int, keep: bool = True):
        """One request: (pairs, pairs with a non-finite answer)."""
        img0, img1, K, reg0, reg1 = self.inputs(i)
        out = self.fn(PairBatch(image0=img0, image1=img1, K0=K, K1=K), reg0, reg1,
                      uniforms=self.slot(i))
        host = torch.cat([out.R.flatten(1), out.t, out.gating], 1).cpu()
        if keep:
            self.keep(i, out)
        return self.batch, int((~torch.isfinite(host).all(1)).sum())

    def keep(self, i: int, out):
        """Reservoir sampling: after n requests each is kept with the same
        chance, ``check_requests`` of them; the others are freed."""
        k, n = self.ctx.workload["check_requests"], self.answered
        self.answered += 1
        if n < k:
            self.outputs.append((i, out))
        else:
            j = self.sampler.randrange(n + 1)
            if j < k:
                self.outputs[j] = (i, out)

    def stats(self) -> str:
        """Median valid matches and inliers a pair, and the gate's range,
        over the sampled requests."""
        valid = torch.cat([o.matches.valid.float().sum(-1) for _, o in self.outputs])
        inl = torch.cat([o.num_inliers.float() for _, o in self.outputs])
        gate = torch.cat([o.gating.float() for _, o in self.outputs])
        lo, hi = gate.amin(0).tolist(), gate.amax(0).tolist()
        return (f"median valid matches a pair {statistics.median(valid.tolist())}, "
                f"median inliers a pair {statistics.median(inl.tolist())}, gate (t) "
                f"{lo[0]:.6g}..{hi[0]:.6g}, gate (R) {lo[1]:.6g}..{hi[1]:.6g} over the "
                f"{len(self.outputs)} sampled requests (match.thr {self.cfg.match.thr})")

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
        outs = [dict(i_ids=o.matches.i_ids, j_ids=o.matches.j_ids, mconf=o.matches.mconf,
                     valid=o.matches.valid, mkpts0_f=o.matches.mkpts0_f,
                     mkpts1_f=o.matches.mkpts1_f, E=o.E, num_inliers=o.num_inliers,
                     solver_rt=o.solver_rt, regressed_9d=o.regressed_9d, gating=o.gating,
                     R=o.R, t=o.t) for _, o in kept]
        outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        parts = []
        for b, (img0, img1, K, reg0, reg1), u in self.blocks([i for i, _ in kept]):
            blk = SimpleNamespace(**{k: v[b] for k, v in outs.items()})
            parts.append(jm.judge(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                  blk, u))
        return jm.merge(parts)

    def blocks(self, picks):
        """(rows, inputs, uniforms) of the requests ``picks`` stacked, in
        blocks of ``check_block`` pairs."""
        inputs = [torch.cat(x) for x in zip(*(self.inputs(i) for i in picks))]
        uniforms = [torch.cat(x) for x in zip(*(self.slot(i) for i in picks))]
        n = self.ctx.workload["check_block"]
        for s in range(0, inputs[0].shape[0], n):
            b = slice(s, s + n)
            yield b, [t[b] for t in inputs], [u[b] for u in uniforms]

    def control(self, rng, quant=fp8) -> dict:
        """The control: the references through ``quant`` in the program's
        place, on as many requests as a run judges, judged the same way."""
        ref = self._references()
        wl = self.ctx.workload
        parts = []
        for _, (img0, img1, K, reg0, reg1), u in self.blocks(
                rng.sample(range(wl["check_pool"]), wl["check_requests"])):
            out = jm.mapfree_forward(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                     u, quant)
            parts.append(jm.judge(ref.matcher, ref.regressor, img0, img1, K, K, reg0, reg1,
                                  out, u))
        return jm.merge(parts)


def setup(ctx) -> Session:
    return Session(ctx)
