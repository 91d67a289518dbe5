"""End-to-end FAR inference on the card: images -> fused 6DoF pose.

Counterpart of ``far_tpu/pipeline.py`` (``make_solver_configs``,
``far_forward``, ``mapfree_forward``, ``vitess_forward``,
``build_inference_fn``, ``init_model``): matcher -> RANSAC -> regressor
-> prior-biased RANSAC -> regressor for FAR and map-free 6DReg, matcher
-> RANSAC -> gated ViTEss for the 8-point ViT. The entry points run on
CUDA unless the caller asks for ``device="cpu"`` (there every kernel
wrapper runs its plain version); without a card and without that request
they raise. On a card ``build_inference_fn`` returns the counterpart of
the JAX package's ``jax.jit(far_forward)``: the request captured once per
signature in a CUDA graph and replayed after (``CompiledRequest``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from far_tpu_torch.models.constants import denormalize_9d
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
from far_tpu_torch.parallel.comm import local_device
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose
from far_tpu_torch.solvers.ransac import draw_round_uniforms
from far_tpu_torch.types import FarOutput, PairBatch, SolverSummary
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights
from far_tpu_torch.utils.prof import (
    BACKBONE, COARSE, EMM, FINE, MATCH, REQUEST_MARK, MarkSink, add_counter, mark, marking,
    round_mark)


def make_solver_configs(cfg: FARConfig) -> Tuple[SolverConfig, SolverConfig]:
    """(first-round, refinement-round) solver configs; with
    solver='prior_ransac' the first round has no prior yet."""
    so = cfg.solver
    base = dict(
        num_hypotheses=so.num_hypotheses,
        minimal_solver=so.minimal_solver,
        pixel_thr=so.pixel_thr,
        prior_inl_th=so.prior_inl_th,
        prior_lambda=so.prior_lambda,
        bias_sigma_sq=so.bias_sigma_sq,
        scoring=so.scoring,
    )
    if so.solver == "prior_ransac":
        first = SolverConfig(solver="prior_ransac_noprior", **base)
        refine = SolverConfig(solver="prior_ransac", **{
            **base, "num_hypotheses": so.refine_num_hypotheses})
    elif so.solver == "prior_ransac_noprior":
        first = refine = SolverConfig(solver="prior_ransac_noprior", **base)
    else:
        first = refine = SolverConfig(solver="ransac", **base)
    return first, refine


def _summarize(est, num_before) -> SolverSummary:
    return SolverSummary(rt=est.rt34, num_before=num_before,
                         num_after=est.num_inliers, num_tight=est.num_tight,
                         num_ultra_tight=est.num_ultra_tight,
                         success=est.success)


def _device_of(model: FARLoFTR) -> torch.device:
    return next(model.parameters()).device


def draw_uniforms(cfg: FARConfig, B: int, generator: Optional[torch.Generator] = None,
                  device=None) -> List[torch.Tensor]:
    """The sampler's draws of every round of ``far_forward``, in its order:
    one (B, n_samples, S) float32 tensor per round (``RansacConfig.sampling``
    of the round's solver config), from ``generator`` or the device's
    default generator. ``far_forward`` without ``uniforms`` and the
    compiled request both draw through here, so the same generator state
    gives both the same draws."""
    first, refine = make_solver_configs(cfg)
    steps = max(cfg.solver.fine_pred_steps, 1)
    # sampling() reads only the budget and the minimal solver, not the prior
    return [draw_round_uniforms((first if i == 0 else refine).ransac_config(False),
                                B, generator, device) for i in range(steps)]


def request_stages(cfg: FARConfig) -> Tuple[str, ...]:
    """The stages of ``far_forward`` in order, each ended by a mark of its
    name (``utils.prof.mark``) after ``REQUEST_MARK`` opens the first: the
    backbone; the position encoding and coarse transformer (K1); the coarse
    match (K2) with the scale head; the fine stage (K3) to the refined
    keypoints; the EMM features (K4); then each solver round with its MoE
    fusion."""
    steps = max(cfg.solver.fine_pred_steps, 1)
    return (BACKBONE, COARSE, MATCH, FINE, EMM) + tuple(round_mark(i) for i in range(steps))


def far_forward(
    model: FARLoFTR,
    batch: PairBatch,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
) -> FarOutput:
    """Full FAR inference for a batch of pairs on the model's device.

    Round 0 solves without a prior; each of the config's
    ``fine_pred_steps - 1`` later rounds re-solves with the previous
    fused pose as a prior and re-fuses. The start and the end of each of
    ``request_stages`` are marked (``utils.prof.mark``). With
    ``predict_translation_scale`` every round's t is scaled by the
    matcher's predicted scale.

    Args:
        generator: the RANSAC sampler's generator (on the model's device);
            every round's draws are taken from it up front
            (``draw_uniforms``).
        uniforms: optional sampler draws in place of the generator's, one
            (B, n_samples, S) tensor per round: S = 5 and n_samples =
            max(H // 20, 1) for the 5-point solver, S = 8 and n_samples =
            H for the 8-point one, H the round's hypothesis budget
            (``RansacConfig.sampling``).
        prior_pcl: optional (P, 3) probe cloud of the prior rounds.
    """
    cfg = model.config
    device = _device_of(model)
    if batch.image0.device != device:
        raise ValueError(f"batch on {batch.image0.device}, model on {device}")
    steps = max(cfg.solver.fine_pred_steps, 1)
    if uniforms is not None and len(uniforms) != steps:
        raise ValueError(f"need {steps} uniform tensors, got {len(uniforms)}")
    first_cfg, refine_cfg = make_solver_configs(cfg)
    if uniforms is None:
        uniforms = draw_uniforms(cfg, batch.image0.shape[0], generator, device)

    mark(REQUEST_MARK)
    out = model.match(batch)
    m = out.matches
    num_before = m.valid.float().sum(-1)
    features = model.regress_features(out.feat_c0, out.feat_c1)
    mark(EMM)

    prior_rt = None
    for i in range(steps):
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid,
            prior_rt=prior_rt, translation_scale=out.translation_scale,
            cfg=first_cfg if i == 0 else refine_cfg,
            prior_pcl=prior_pcl, uniforms=uniforms[i])
        pose_9d, gate = model.regress_fuse(features, _summarize(est, num_before))
        prior_rt = denormalize_9d(pose_9d)
        mark(round_mark(i))

    return FarOutput(
        R=prior_rt[..., :3, :3], t=prior_rt[..., :3, 3], solver_rt=est.rt34,
        regressed_9d=pose_9d, prior_rt=prior_rt, matches=m,
        num_inliers=est.num_inliers, success=est.success, E=est.E,
        gating=gate, translation_scale=out.translation_scale)


def mapfree_forward(
    matcher: FARLoFTR,
    reg_model: MapfreeRegression,
    batch: PairBatch,
    image0_reg: torch.Tensor,
    image1_reg: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
    pixel_thr: float = 2.0,
    fine_pred_steps: int = 2,
):
    """Map-free FAR inference: matcher -> RANSAC -> 6DReg -> prior loop.

    Round 0 solves with plain RANSAC under MAGSAC scoring (the
    reference's cv2 USAC_MAGSAC); each later round with the prior-biased
    engine around the previous fused [R|t]. The regressor runs whole in
    every round, as the JAX package's does.

    Args:
        batch: the matcher-resolution grayscale pair with intrinsics.
        image0_reg/image1_reg: the regressor-resolution RGB pair
            (B, H, W, 3) in [0, 1].
        uniforms: optional sampler draws, one (B, H, 8) tensor per round
            (H: 2048 hypotheses in round 0, the refinement budget after).
    Returns:
        (R (B, 3, 3), t (B, 3), gate, the last round's PoseEstimate).
    """
    if uniforms is not None and len(uniforms) != fine_pred_steps:
        raise ValueError(f"need {fine_pred_steps} uniform tensors, got {len(uniforms)}")
    m = matcher.match(batch).matches
    first_cfg = SolverConfig(solver="ransac", pixel_thr=pixel_thr, scoring="magsac")
    refine_cfg = SolverConfig(solver="prior_ransac")
    prior_rt = R = t = gate = est = None
    for i in range(fine_pred_steps):
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid, prior_rt=prior_rt,
            cfg=first_cfg if i == 0 else refine_cfg, prior_pcl=prior_pcl,
            uniforms=None if uniforms is None else uniforms[i], generator=generator)
        counts = torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)
        R, t, _, gate = reg_model(image0_reg, image1_reg, est.rt34, counts)
        prior_rt = torch.cat([R, t[..., None]], -1)
    return R, t, gate, est


def vitess_forward(
    vitess_model: ViTEss,
    images: torch.Tensor,
    matcher: Optional[FARLoFTR] = None,
    matcher_batch: Optional[PairBatch] = None,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
):
    """8-point ViT inference, gated by the solver's pose when a matcher is
    given: matcher -> RANSAC (no prior, 2048 8-point hypotheses) ->
    ViTEss(images, [R|t], inlier count).

    Args:
        images: (B, 2, H, W, 3) RGB in [0, 1].
        uniforms: optional (B, 2048, 8) sampler draws for the solver.
    Returns:
        (t (B, 3), R (B, 3, 3), the normalized 9D pose, gate or None).
    """
    solver_pose = num_corr = None
    if matcher is not None:
        m = matcher.match(matcher_batch).matches
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, matcher_batch.K0, matcher_batch.K1, m.valid,
            cfg=SolverConfig(solver="prior_ransac_noprior"), uniforms=uniforms,
            generator=generator)
        solver_pose, num_corr = est.rt34, est.num_inliers
    return vitess_model(images, solver_pose, num_corr)


# the batch fields far_forward reads
REQUEST_FIELDS = ("image0", "image1", "K0", "K1", "scale0", "scale1")


def request_signature(model: FARLoFTR, batch: PairBatch,
                      uniforms: Optional[Sequence[torch.Tensor]] = None,
                      prior_pcl: Optional[torch.Tensor] = None) -> tuple:
    """What a captured request is specialised to, as JAX's jit is to its
    arguments' shapes: shape, dtype and device of each batch field
    ``far_forward`` reads, of ``uniforms`` (or that none was given) and of
    ``prior_pcl``; the storages of the model's parameters and buffers
    (``load_state_dict`` copies into them in place, so it keeps the key;
    moving or replacing them changes it); the mode; and the numerics flags
    the eager request reads (TF32 in cuBLAS and cuDNN, cuDNN itself,
    deterministic algorithms)."""
    def spec(t):
        return None if t is None else (tuple(t.shape), t.dtype, str(t.device))

    return (tuple(spec(getattr(batch, f)) for f in REQUEST_FIELDS),
            None if uniforms is None else tuple(spec(u) for u in uniforms),
            spec(prior_pcl),
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers())),
            model.training,
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled, torch.are_deterministic_algorithms_enabled()))


def _map_tensors(fn, out):
    """``out`` (a dataclass of tensors, nested dataclasses and None) with
    ``fn`` applied to every tensor."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if dataclasses.is_dataclass(out):
        return type(out)(**{f.name: _map_tensors(fn, getattr(out, f.name))
                            for f in dataclasses.fields(out)})
    return out


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    batch: PairBatch                      # static inputs, filled before a replay
    uniforms: List[torch.Tensor]
    prior_pcl: Optional[torch.Tensor]
    output: FarOutput                     # static outputs in the graph's pool
    pool_bytes: int                       # device memory the capture added to the pool
    stages: Tuple[str, ...]               # request_stages of the model's config
    slots: torch.Tensor                   # int64 clock (ns) of each mark, written by a run


class CompiledRequest:
    """``far_forward`` as one CUDA graph per request signature: the port's
    ``jax.jit(far_forward)``.

    A call looks up ``request_signature``. The first call of a signature
    runs the eager request on a side stream (the warm-up: kernel builds,
    ``cudaFuncSetAttribute``, cuDNN's plan choice, the cached tables and
    the allocator's growth stay out of the capture), returns its output,
    then captures the same request into a graph. Every signature's graph
    takes its memory from one pool of this object's: replays run one at a
    time on one stream and their outputs are cloned before the next, so
    one graph's intermediates may reuse another's. Later calls copy the
    batch fields (and ``uniforms`` / ``prior_pcl`` when given) into the
    graph's static inputs, draw the
    sampler's uniforms outside the graph into its static buffers where
    none are given (``draw_uniforms``: the draws an eager request from the
    same generator state takes), replay, and return clones of the static
    outputs, so nothing returned aliases the graph. The kernel wrappers'
    launch counters count the warm-up, whose kernels they launch; a
    capture records kernels without running them and a replay runs them
    without the wrappers, so neither adds to a counter (a profiler trace
    of a replay shows its kernels). A failed capture raises, naming the
    op; there is no eager fallback on the card. On a CPU model a call is
    the eager ``far_forward``.

    The graph holds a device mark at the request's start and at the end of
    each of ``request_stages`` (``utils.prof.mark``); ``stage_ms`` reads
    the last request's. The warm-up and the capture write counters
    (``utils.prof.counters``, summed over signatures):
    ``far.capture.warmup_s`` (the warm-up to its synchronize),
    ``far.capture.record_s`` (the capture with the graph's instantiation)
    and ``far.capture.nodes.<stage>`` (the stage's operation nodes:
    kernels, copies and memsets, marks left out)."""

    def __init__(self, model: FARLoFTR):
        self.model = model
        self.graphs: Dict[tuple, _Captured] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None  # the graphs' memory pool, made at the first capture
        self._last: Optional[_Captured] = None  # the signature that ran last

    def __call__(self, batch: PairBatch, generator=None, uniforms=None, prior_pcl=None):
        model = self.model
        device = _device_of(model)
        with torch.inference_mode():
            if device.type != "cuda":
                return far_forward(model, batch, generator, uniforms, prior_pcl)
            if batch.image0.device != device:
                raise ValueError(f"batch on {batch.image0.device}, model on {device}")
            key = request_signature(model, batch, uniforms, prior_pcl)
            entry = self.graphs.get(key)
            if entry is None:
                return self._capture(key, batch, generator, uniforms, prior_pcl)
            for f in REQUEST_FIELDS:
                src = getattr(batch, f)
                if src is not None:
                    getattr(entry.batch, f).copy_(src)
            if uniforms is None:
                uniforms = draw_uniforms(model.config, batch.image0.shape[0], generator,
                                         device)
            for dst, src in zip(entry.uniforms, uniforms):
                dst.copy_(src)
            if prior_pcl is not None:
                entry.prior_pcl.copy_(prior_pcl)
            entry.graph.replay()
            self._last = entry
            return _map_tensors(torch.Tensor.clone, entry.output)

    def pool_bytes(self) -> int:
        """Device memory the captures of every signature reserved: the
        size of the graphs' pool."""
        return sum(e.pool_bytes for e in self.graphs.values())

    def stage_ms(self) -> Dict[str, float]:
        """{stage: device ms} of the last request on the card, from its
        marks' clock (a replay's; before a signature's first replay, its
        warm-up's): the time from one mark to the next. Copies the slots
        to the host, which waits for the request."""
        if self._last is None:
            raise RuntimeError("stage_ms: no request has run on the card")
        t = self._last.slots.tolist()
        return {s: (t[i + 1] - t[i]) / 1e6 for i, s in enumerate(self._last.stages)}

    def _capture(self, key, batch, generator, uniforms, prior_pcl) -> FarOutput:
        model = self.model
        device = _device_of(model)
        static = PairBatch(**{f: None if getattr(batch, f) is None
                              else getattr(batch, f).clone() for f in REQUEST_FIELDS})
        if uniforms is None:
            uniforms = draw_uniforms(model.config, batch.image0.shape[0], generator, device)
        static_u = [u.to(device).clone() for u in uniforms]
        static_pcl = None if prior_pcl is None else prior_pcl.to(device).clone()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        stages = request_stages(model.config)
        slots = torch.zeros(len(stages) + 1, dtype=torch.int64, device=device)
        stream, main = self._stream, torch.cuda.current_stream(device)
        stream.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), marking(MarkSink(slots)):
            out = far_forward(model, static, None, static_u, static_pcl)
        torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        sink = MarkSink(slots)
        t0 = time.perf_counter()
        try:
            with marking(sink), torch.cuda.graph(graph, pool=self._pool, stream=stream):
                static_out = far_forward(model, static, None, static_u, static_pcl)
        except Exception as exc:  # the op that broke the capture, by its frame
            frames = [f for f in traceback.extract_tb(exc.__traceback__)
                      if "far_tpu_torch" in f.filename]
            where = (f" at {frames[-1].filename}:{frames[-1].lineno} ({frames[-1].line})"
                     if frames else "")
            raise RuntimeError(f"capturing the request in a CUDA graph failed{where}: "
                               f"{exc}") from exc
        record_s = time.perf_counter() - t0
        if tuple(sink.names) != (REQUEST_MARK,) + stages:
            raise RuntimeError(f"the capture marked {sink.names}, not the request's "
                               f"stages {stages}")
        add_counter("far.capture.warmup_s", warmup_s)
        add_counter("far.capture.record_s", record_s)
        for i, stage in enumerate(stages, 1):  # the nodes between two marks
            add_counter(f"far.capture.nodes.{stage}",
                        sink.nodes[i] - sink.nodes[i - 1] - 1)
        self.graphs[key] = self._last = _Captured(
            graph, static, static_u, static_pcl, static_out,
            torch.cuda.memory_reserved(device) - reserved, stages, slots)
        main.wait_stream(stream)
        _map_tensors(lambda t: t.record_stream(main), out)
        return out


def build_inference_fn(model: FARLoFTR) -> Callable[..., FarOutput]:
    """(batch, generator=None, uniforms=None, prior_pcl=None) -> FarOutput,
    under ``torch.inference_mode``: a ``CompiledRequest`` (captured once
    per ``request_signature`` on a card; the eager ``far_forward`` on the
    CPU)."""
    return CompiledRequest(model)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise, and
    ``"cuda"`` this rank's card (``parallel.comm.local_device``)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: far_tpu_torch runs on the GPU; "
                           "pass device='cpu' for the plain CPU versions")
    return local_device(dev)


def init_model(cfg: Optional[FARConfig] = None, seed: int = 0,
               device=None) -> FARLoFTR:
    """The model with deterministic random weights (``init_weights``), in
    eval mode on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    model = FARLoFTR(cfg or FARConfig())
    init_weights(model, seed)
    return model.to(dev).eval()


def init_vitess(cfg: Optional[ViTEssConfig] = None, seed: int = 0,
                device=None) -> ViTEss:
    """ViTEss with ``init_weights(seed)``, in eval mode on ``device``."""
    dev = resolve_device(device)
    return init_weights(ViTEss(cfg or ViTEssConfig()), seed).to(dev).eval()


def init_sixdreg(cfg: Optional[SixDRegConfig] = None, seed: int = 0,
                 device=None) -> MapfreeRegression:
    """MapfreeRegression with ``init_weights(seed)``, in eval mode on
    ``device``."""
    dev = resolve_device(device)
    return init_weights(MapfreeRegression(cfg or SixDRegConfig()), seed).to(dev).eval()
