"""FAR inference through the compiled request, ``build_inference_fn``.

Set-up builds ``FARLoFTR`` on the device from the configuration file,
loads weights made from the seed (``reference/weights.py``), makes the
pool of synthetic pairs on the device and keeps it in pinned host memory,
draws the solver's uniforms for a pool of request slots, and runs request
0 twice: the first call captures the CUDA graph, the second replays it. A
request copies its B pairs from the pinned pool to the card, replays the
graph with its slot's uniforms, and reads R, t and the gate back on the
host. Only the outputs of ``check_requests`` requests stay on the device,
a sample of every request answered, drawn from the seed as they come
(reservoir sampling), so what the run holds does not grow with the
requests it finishes. The check runs the plain reference
(``reference/judge.py``) over that sample, in blocks of pairs.

Traffic keys: ``batch``, ``pool_pairs`` (a multiple of ``batch``),
``uniform_slots``, ``check_requests``, ``check_block``, ``trace_requests``.
"""

from __future__ import annotations

import random
import statistics
from types import SimpleNamespace

import torch

from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.pipeline import build_inference_fn
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.config import FARConfig
from h100bench.common import (PAIRS, SAMPLE, UNIFORMS, WEIGHTS, build, pin, state_shapes,
                              sub_seed)
from h100bench.reference import judge as jg
from h100bench.reference.far import FarReference, fp8, shapes_from_config
from h100bench.reference.synthetic import make_pairs
from h100bench.reference.weights import make_state_dict

def reference_shapes(model_cfg: dict):
    return state_shapes(lambda: FarReference(shapes_from_config(model_cfg)))


class Session:
    def __init__(self, ctx, program: bool = True):
        wl, dev = ctx.workload, ctx.device
        self.ctx = ctx
        self.model_cfg = ctx.config["model"]
        self.solver = self.model_cfg.get("solver", {})
        self.cfg = build(FARConfig, self.model_cfg)
        self.batch = B = wl["batch"]
        self.device = dev
        P, U = wl["pool_pairs"], wl["uniform_slots"]
        if P % B:
            raise ValueError(f"pool_pairs {P} is not a multiple of batch {B}")
        g = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, PAIRS))
        img0, img1, K = make_pairs(P, self.cfg.image_size, g, dev)
        self.pool = pin((img0, img1, K), dev)
        del img0, img1, K
        first, refine = jg.solver_configs(self.solver)
        gu = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, UNIFORMS))
        rounds = max(self.cfg.solver.fine_pred_steps, 1)
        self.uniforms = []
        for r in range(rounds):
            n, S, _ = (first if r == 0 else refine).ransac_config(r > 0).sampling()
            self.uniforms.append(torch.rand((U, B, n, S), generator=gu, device=dev))
        sh = self.cfg
        self.shapes = dict(
            B=B, L=sh.coarse_hw[0] * sh.coarse_hw[1], C=sh.coarse.d_model,
            nhead=sh.coarse.nhead, n_coarse_layers=len(sh.coarse.layer_names),
            K=sh.match.max_matches, WW=sh.fine.window_size ** 2, Cf=sh.fine.d_model,
            Hf=sh.fine.nhead, H_emm=sh.regress.emm_heads,
            D_emm=sh.coarse.d_model // sh.regress.emm_heads, hidden=sh.regress.hidden,
            e=2 if sh.dtype == "bfloat16" else 4, rounds=rounds,
            image_hw=tuple(sh.image_size), initial_dim=sh.backbone.initial_dim,
            block_dims=tuple(sh.backbone.block_dims))
        self.outputs, self.answered = [], 0
        self.sampler = random.Random(sub_seed(ctx.seed, SAMPLE))
        if not program:
            return
        with torch.device(dev):
            model = FARLoFTR(self.cfg)
        model.load_state_dict(make_state_dict(reference_shapes(self.model_cfg),
                                              sub_seed(ctx.seed, WEIGHTS), dev))
        self.model = model.eval()
        self.fn = build_inference_fn(self.model)
        self.request(0, keep=False)
        self.request(0, keep=False)

    def inputs(self, i: int, on=None):
        """The pairs of request i, copied to the device."""
        B, P = self.batch, self.pool[0].shape[0]
        s = (i * B) % P
        dev = on or self.device
        return [t[s:s + B].to(dev, non_blocking=True) for t in self.pool]

    def slot(self, i: int):
        return [u[i % u.shape[0]] for u in self.uniforms]

    def request(self, i: int, keep: bool = True):
        """One request: (pairs, pairs with a non-finite answer)."""
        img0, img1, K = self.inputs(i)
        out = self.fn(PairBatch(image0=img0, image1=img1, K0=K, K1=K), uniforms=self.slot(i))
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
        """Median valid matches and inliers a pair over the sampled requests."""
        valid = torch.cat([o.matches.valid.float().sum(-1) for _, o in self.outputs])
        inl = torch.cat([o.num_inliers.float() for _, o in self.outputs])
        return (f"median valid matches a pair {statistics.median(valid.tolist())}, "
                f"median inliers a pair {statistics.median(inl.tolist())} over the "
                f"{len(self.outputs)} sampled requests (match.thr {self.cfg.match.thr})")

    def _reference(self):
        ref = FarReference(shapes_from_config(self.model_cfg)).to(self.device)
        ref.load_state_dict(make_state_dict(reference_shapes(self.model_cfg),
                                            sub_seed(self.ctx.seed, WEIGHTS), self.device))
        return ref.eval()

    def check(self) -> dict:
        """The program's state freed, the reference judges the sampled
        requests' pairs in blocks of ``check_block``."""
        kept = sorted(self.outputs, key=lambda x: x[0])
        self.outputs, self.fn, self.model = [], None, None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ref = self._reference()
        outs = [dict(i_ids=o.matches.i_ids, j_ids=o.matches.j_ids, mconf=o.matches.mconf,
                     valid=o.matches.valid, mkpts0_f=o.matches.mkpts0_f,
                     mkpts1_f=o.matches.mkpts1_f, E=o.E, num_inliers=o.num_inliers,
                     solver_rt=o.solver_rt, gating=o.gating, R=o.R, t=o.t) for _, o in kept]
        outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        parts = []
        for b, (img0, img1, K), u in self.blocks([i for i, _ in kept]):
            blk = SimpleNamespace(**{k: v[b] for k, v in outs.items()})
            parts.append(jg.judge(ref, img0, img1, K, K, blk, u, self.solver))
        return jg.merge(parts)

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
        """The control: the reference through ``quant`` in the program's
        place, on as many requests as a run judges, judged the same way."""
        ref = self._reference()
        wl = self.ctx.workload
        parts = []
        for _, (img0, img1, K), u in self.blocks(
                rng.sample(range(wl["check_pool"]), wl["check_requests"])):
            out = jg.far_forward(ref, img0, img1, K, K, u, self.solver, quant)
            parts.append(jg.judge(ref, img0, img1, K, K, out, u, self.solver))
        return jg.merge(parts)


def setup(ctx) -> Session:
    return Session(ctx)

