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
signature in a CUDA graph and replayed after (``CompiledRequest``);
``build_mapfree_fn`` does the same for ``mapfree_forward``, whose matcher
is ``FARLoFTR`` or SuperPoint + SuperGlue (``SuperGlueMatcher``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from far_tpu_torch.models.constants import denormalize_9d
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.superglue_matcher import SuperGlueMatcher
from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
from far_tpu_torch.parallel.comm import local_device
from far_tpu_torch.solvers.pose_estimation import SolverConfig, estimate_pose
from far_tpu_torch.solvers.ransac import draw_round_uniforms
from far_tpu_torch.types import FarOutput, MapfreeOutput, PairBatch, SolverSummary
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights
from far_tpu_torch.utils.prof import (
    BACKBONE, COARSE, EMM, FINE, MATCH, REQUEST_MARK, MarkSink, add_counter, encode_mark, mark,
    marking, round_mark, solve_mark, volume_mark)


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


def mapfree_solver_configs(pixel_thr: float = 2.0) -> Tuple[SolverConfig, SolverConfig]:
    """(first-round, prior-round) solver configs of ``mapfree_forward``:
    RANSAC at ``pixel_thr`` under MAGSAC scoring (the reference's cv2
    USAC_MAGSAC), then the prior-biased engine; 2,048 8-point hypotheses
    each."""
    return (SolverConfig(solver="ransac", pixel_thr=pixel_thr, scoring="magsac"),
            SolverConfig(solver="prior_ransac"))


def draw_mapfree_uniforms(B: int, generator: Optional[torch.Generator] = None,
                          device=None, fine_pred_steps: int = 2) -> List[torch.Tensor]:
    """The sampler's draws of every round of ``mapfree_forward``, in its
    order: one (B, 2048, 8) float32 tensor a round, from ``generator`` or
    the device's default generator (see ``draw_uniforms``)."""
    first, refine = mapfree_solver_configs()
    return [draw_round_uniforms((first if i == 0 else refine).ransac_config(i > 0),
                                B, generator, device) for i in range(fine_pred_steps)]


Matcher = Union[FARLoFTR, SuperGlueMatcher]


def mapfree_stages(fine_pred_steps: int = 2,
                   matcher_stages: Sequence[str] = FARLoFTR.MATCH_STAGES) -> Tuple[str, ...]:
    """The stages of ``mapfree_forward`` in order, each ended by a mark of
    its name after ``REQUEST_MARK``: the matcher's (``MATCH_STAGES``:
    LoFTR's backbone, coarse transformer (K1), coarse match (K2) and fine
    stage (K3); SuperPoint + SuperGlue's detections, GNN and Sinkhorn);
    then in each round the solver, the ResUNet on both images, the
    correlation volume with the head, and the transformer with the pose
    MLP and the MoE (``mapfree_forward`` runs the regressor's trunk in
    round 0 alone, so a later round's ``encode`` and ``volume`` stages
    hold nothing and its last stage is the MoE)."""
    rounds = tuple(m(i) for i in range(fine_pred_steps)
                   for m in (solve_mark, encode_mark, volume_mark, round_mark))
    return tuple(matcher_stages) + rounds


def mapfree_forward(
    matcher: Matcher,
    reg_model: MapfreeRegression,
    batch: PairBatch,
    image0_reg: torch.Tensor,
    image1_reg: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
    pixel_thr: float = 2.0,
    fine_pred_steps: int = 2,
) -> MapfreeOutput:
    """Map-free FAR inference: matcher -> RANSAC -> 6DReg -> prior loop.

    Round 0 solves with plain RANSAC under MAGSAC scoring (the
    reference's cv2 USAC_MAGSAC); each later round with the prior-biased
    engine around the previous fused [R|t]. The regressor's trunk (the
    ResUNet, volume, head, transformer and pose MLP) reads the regressor
    pair alone, so it runs once, in round 0; each round then blends its
    pose with the round's solver pose (the MoE), as ``far_forward`` fuses
    its EMM features. The JAX package runs the regressor whole in every
    round, to the same result. The start and the end of each of
    ``mapfree_stages`` are marked (``utils.prof.mark``); a later round's
    ``encode`` and ``volume`` marks follow its ``solve`` mark at once.

    Args:
        matcher: ``FARLoFTR`` or ``SuperGlueMatcher``: ``match(batch)``
            gives the padded correspondences and marks the matcher's
            stages.
        batch: the matcher-resolution grayscale pair with intrinsics.
        image0_reg/image1_reg: the regressor-resolution RGB pair
            (B, H, W, 3) in [0, 1].
        generator: the sampler's generator; every round's draws are taken
            from it up front (``draw_mapfree_uniforms``).
        uniforms: optional sampler draws, one (B, 2048, 8) tensor per
            round.
    """
    if fine_pred_steps < 1:
        raise ValueError(f"fine_pred_steps must be at least 1, got {fine_pred_steps}")
    if uniforms is not None and len(uniforms) != fine_pred_steps:
        raise ValueError(f"need {fine_pred_steps} uniform tensors, got {len(uniforms)}")
    if uniforms is None:
        uniforms = draw_mapfree_uniforms(batch.image0.shape[0], generator,
                                         batch.image0.device, fine_pred_steps)
    first_cfg, refine_cfg = mapfree_solver_configs(pixel_thr)
    mark(REQUEST_MARK)
    m = matcher.match(batch).matches
    prior_rt = features = None
    for i in range(fine_pred_steps):
        est = estimate_pose(
            m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid, prior_rt=prior_rt,
            cfg=first_cfg if i == 0 else refine_cfg, prior_pcl=prior_pcl,
            uniforms=uniforms[i])
        mark(solve_mark(i))
        if features is None:  # the image-only trunk, once a request
            vols = reg_model.encode(image0_reg, image1_reg)
            mark(encode_mark(i))
            grid = reg_model.volume(*vols)
            mark(volume_mark(i))
            features = reg_model.tokens(grid)
            pose_9d = reg_model.regress(features)
        else:
            mark(encode_mark(i))
            mark(volume_mark(i))
        counts = torch.stack([est.num_inliers, est.num_tight, est.num_ultra_tight], -1)
        R, t, _, gate = reg_model.blend(features, pose_9d, est.rt34, counts)
        prior_rt = torch.cat([R, t[..., None]], -1)
        mark(round_mark(i))
    return MapfreeOutput(
        R=R, t=t, gating=gate, regressed_9d=pose_9d, solver_rt=est.rt34, E=est.E,
        num_inliers=est.num_inliers, num_tight=est.num_tight,
        num_ultra_tight=est.num_ultra_tight, matches=m)


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


# the batch fields far_forward and mapfree_forward read
REQUEST_FIELDS = ("image0", "image1", "K0", "K1", "scale0", "scale1")


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype, str(t.device))


def _map_inputs(fn, inputs):
    """A request's inputs (a ``PairBatch``, a tensor, None or a tuple of
    them) with ``fn`` applied to each tensor: a batch's ``REQUEST_FIELDS``
    as a ``PairBatch`` again (its other fields left out), None as None."""
    if isinstance(inputs, PairBatch):
        return PairBatch(**{f: None if getattr(inputs, f) is None else fn(getattr(inputs, f))
                            for f in REQUEST_FIELDS})
    if isinstance(inputs, (tuple, list)):
        return tuple(_map_inputs(fn, x) for x in inputs)
    return None if inputs is None else fn(inputs)


def _leaves(inputs) -> List[torch.Tensor]:
    """The tensors of a request's inputs, in ``_map_inputs``' order."""
    out: List[torch.Tensor] = []
    _map_inputs(out.append, inputs)
    return out


def request_signature(modules, inputs, uniforms: Optional[Sequence[torch.Tensor]] = None,
                      prior_pcl: Optional[torch.Tensor] = None) -> tuple:
    """What a captured request is specialised to, as JAX's jit is to its
    arguments' shapes: shape, dtype and device of each input tensor and of
    each batch field the requests read (``inputs``: a ``PairBatch``, a
    tensor or a tuple of them), of ``uniforms`` (or that none was given) and of
    ``prior_pcl``; the storages of the parameters and buffers of
    ``modules`` (a module or a sequence of them; ``load_state_dict`` copies
    into them in place, so it keeps the key; moving or replacing them
    changes it); their modes; and the numerics flags the eager request
    reads (TF32 in cuBLAS and cuDNN, cuDNN itself, deterministic
    algorithms)."""
    mods = (modules,) if isinstance(modules, torch.nn.Module) else tuple(modules)

    def spec(x):
        if isinstance(x, PairBatch):
            return tuple(_spec(getattr(x, f)) for f in REQUEST_FIELDS)
        if isinstance(x, (tuple, list)):
            return tuple(spec(y) for y in x)
        return _spec(x)

    return (spec(inputs),
            None if uniforms is None else tuple(_spec(u) for u in uniforms),
            _spec(prior_pcl),
            tuple(t.data_ptr() for m in mods
                  for t in itertools.chain(m.parameters(), m.buffers())),
            tuple(m.training for m in mods),
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
    inputs: tuple                         # static inputs, filled before a replay
    uniforms: List[torch.Tensor]
    prior_pcl: Optional[torch.Tensor]
    output: object                        # static outputs (a dataclass) in the graph's pool
    pool_bytes: int                       # device memory the capture added to the pool
    stages: Tuple[str, ...]               # the request's stages
    slots: torch.Tensor                   # int64 clock (ns) of each mark, written by a run


class CompiledRequest:
    """A request function as one CUDA graph per request signature: the
    port's ``jax.jit`` of ``far_forward`` (``build_inference_fn``) and of
    ``mapfree_forward`` (``build_mapfree_fn``).

    Args:
        forward: the eager request, ``forward(*inputs, generator=,
            uniforms=, prior_pcl=)`` -> a dataclass of tensors.
        modules: the modules whose parameters, buffers and modes enter the
            signature; the first's device is the request's.
        stages: () -> the names the request marks after ``REQUEST_MARK``,
            in order (read at each capture).
        draw: (inputs, generator, device) -> each round's sampler draws,
            the ones the eager request takes from the same generator
            state.
        prefix: the counters' prefix (``<prefix>.capture.*``).

    A call ``fn(*inputs, generator=None, uniforms=None, prior_pcl=None)``
    looks up ``request_signature``. The first call of a signature runs the
    eager request on a side stream (the warm-up: kernel builds,
    ``cudaFuncSetAttribute``, cuDNN's plan choice, the cached tables and
    the allocator's growth stay out of the capture), returns its output,
    then captures the same request into a graph. Every signature's graph
    takes its memory from one pool of this object's: replays run one at a
    time on one stream and their outputs are cloned before the next, so
    one graph's intermediates may reuse another's. Later calls copy the
    inputs (and ``uniforms`` / ``prior_pcl`` when given) into the graph's
    static inputs, draw the sampler's uniforms outside the graph into its
    static buffers where none are given (``draw``), replay, and return
    clones of the static outputs, so nothing returned aliases the graph.
    The kernel wrappers' launch counters count the warm-up, whose kernels
    they launch; a capture records kernels without running them and a
    replay runs them without the wrappers, so neither adds to a counter
    (a profiler trace of a replay shows its kernels). A failed capture
    raises, naming the op; there is no eager fallback on the card. On a
    CPU model a call is the eager ``forward``.

    The graph holds a device mark at the request's start and at the end of
    each of ``stages`` (``utils.prof.mark``); ``stage_ms`` reads the last
    request's. The warm-up and the capture write counters
    (``utils.prof.counters``, summed over signatures):
    ``<prefix>.capture.warmup_s`` (the warm-up to its synchronize),
    ``<prefix>.capture.record_s`` (the capture with the graph's
    instantiation) and ``<prefix>.capture.nodes.<stage>`` (the stage's
    operation nodes: kernels, copies and memsets, marks left out)."""

    def __init__(self, forward: Callable, modules: Sequence[torch.nn.Module],
                 stages: Callable[[], Tuple[str, ...]], draw: Callable,
                 prefix: str = "far"):
        self.forward = forward
        self.modules = tuple(modules)
        self.stages = stages
        self.draw = draw
        self.prefix = prefix
        self.graphs: Dict[tuple, _Captured] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None  # the graphs' memory pool, made at the first capture
        self._last: Optional[_Captured] = None  # the signature that ran last

    def __call__(self, *inputs, generator=None, uniforms=None, prior_pcl=None):
        device = _device_of(self.modules[0])
        with torch.inference_mode():
            if device.type != "cuda":
                return self.forward(*inputs, generator=generator, uniforms=uniforms,
                                    prior_pcl=prior_pcl)
            for x in _leaves(inputs):
                if x.device != device:
                    raise ValueError(f"batch on {x.device}, model on {device}")
            key = request_signature(self.modules, inputs, uniforms, prior_pcl)
            entry = self.graphs.get(key)
            if entry is None:
                return self._capture(key, inputs, generator, uniforms, prior_pcl)
            for dst, src in zip(_leaves(entry.inputs), _leaves(inputs)):
                dst.copy_(src)
            if uniforms is None:
                uniforms = self.draw(inputs, generator, device)
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

    def _capture(self, key, inputs, generator, uniforms, prior_pcl):
        device = _device_of(self.modules[0])
        static = _map_inputs(torch.Tensor.clone, inputs)
        if uniforms is None:
            uniforms = self.draw(inputs, generator, device)
        static_u = [u.to(device).clone() for u in uniforms]
        static_pcl = None if prior_pcl is None else prior_pcl.to(device).clone()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        stages = tuple(self.stages())
        slots = torch.zeros(len(stages) + 1, dtype=torch.int64, device=device)
        stream, main = self._stream, torch.cuda.current_stream(device)
        stream.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), marking(MarkSink(slots)):
            out = self.forward(*static, uniforms=static_u, prior_pcl=static_pcl)
        torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        sink = MarkSink(slots)
        t0 = time.perf_counter()
        try:
            with marking(sink), torch.cuda.graph(graph, pool=self._pool, stream=stream):
                static_out = self.forward(*static, uniforms=static_u, prior_pcl=static_pcl)
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
        add_counter(f"{self.prefix}.capture.warmup_s", warmup_s)
        add_counter(f"{self.prefix}.capture.record_s", record_s)
        for i, stage in enumerate(stages, 1):  # the nodes between two marks
            add_counter(f"{self.prefix}.capture.nodes.{stage}",
                        sink.nodes[i] - sink.nodes[i - 1] - 1)
        self.graphs[key] = self._last = _Captured(
            graph, static, static_u, static_pcl, static_out,
            torch.cuda.memory_reserved(device) - reserved, stages, slots)
        main.wait_stream(stream)
        _map_tensors(lambda t: t.record_stream(main), out)
        return out


def build_inference_fn(model: FARLoFTR) -> Callable[..., FarOutput]:
    """(batch, generator=None, uniforms=None, prior_pcl=None) -> FarOutput,
    under ``torch.inference_mode``: a ``CompiledRequest`` of
    ``far_forward`` (captured once per ``request_signature`` on a card;
    the eager ``far_forward`` on the CPU)."""
    return CompiledRequest(
        lambda batch, **kw: far_forward(model, batch, **kw), (model,),
        lambda: request_stages(model.config),
        lambda inputs, generator, device: draw_uniforms(
            model.config, inputs[0].image0.shape[0], generator, device))


def build_mapfree_fn(matcher: Matcher,
                     reg_model: MapfreeRegression) -> Callable[..., MapfreeOutput]:
    """(batch, image0_reg, image1_reg, generator=None, uniforms=None,
    prior_pcl=None) -> MapfreeOutput, under ``torch.inference_mode``: a
    ``CompiledRequest`` of ``mapfree_forward`` (captured once per
    signature on a card, the counterpart of the JAX package's
    ``jax.jit(mapfree_forward)``; the eager ``mapfree_forward`` on the
    CPU), with ``mapfree_forward``'s defaults: two rounds, MAGSAC at 2 px.
    Its stages are the matcher's then the rounds' (``mapfree_stages``),
    its counters ``<matcher.MAPFREE_PREFIX>.capture.*``: ``mapfree`` for
    LoFTR, ``mapfree_sg`` for SuperPoint + SuperGlue."""
    return CompiledRequest(
        lambda batch, image0_reg, image1_reg, **kw: mapfree_forward(
            matcher, reg_model, batch, image0_reg, image1_reg, **kw),
        (matcher, reg_model), lambda: mapfree_stages(matcher_stages=matcher.MATCH_STAGES),
        lambda inputs, generator, device: draw_mapfree_uniforms(
            inputs[0].image0.shape[0], generator, device),
        prefix=matcher.MAPFREE_PREFIX)


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
