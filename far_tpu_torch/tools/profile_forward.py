"""Where one request of a model family spends its time on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m far_tpu_torch.tools.profile_forward [--family far|vitess|mapfree]
        [--dtype bfloat16] [--batch 4] [--solver 5pt|8pt]

``--family far`` (the default): ``far_forward`` under ``FARConfig`` at its
defaults (480x640, full width, the 5-point solver unless ``--solver
8pt``); stages: backbone, coarse transformer, coarse match, fine stage,
EMM features, each solver round, each MoE fusion. ``--family vitess``:
``vitess_forward`` with ``ViTEssConfig(use_loftr_gating=True)`` at
224x224 gated by a ``FARConfig()`` matcher at 480x640; stages: the gating
matcher, the solver, trunk + RAFT block, ViT blocks, CrossBlock (K4 x2),
heads. ``--family mapfree``: ``mapfree_forward`` with a 720x544
``FARConfig(regress_rt=False)`` matcher and ``SixDRegConfig()`` at
368x272; stages: the matcher, then per round the solver, ResUNet x2, the
correlation volume, the head, the transformer, the pose MLP and MoE.
Random weights from seeds 0 (matcher) and 1 (regressor). After two
warm-up requests it times one request by stage with CUDA events, then
traces one more with ``torch.profiler`` and prints the device time of the
busiest kernels and the share of the request's wall time in which the
card ran no kernel; for ``far`` the stages are those of the eager
``far_forward`` (a CUDA graph replay calls no module method), followed by
the kernels launched and their device time inside each solver round, and
then the compiled request (``build_inference_fn``: a CUDA graph replay):
its ms (median of 3), its graph pool, the device ms of each of its
stages in the last replay (``CompiledRequest.stage_ms``, read from the
marks inside the graph) and one traced replay's idle share.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

import far_tpu_torch.models.loftr as loftr_mod
import far_tpu_torch.pipeline as pipeline_mod
from far_tpu_torch.pipeline import build_inference_fn, init_model
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.config import FARConfig, SolverOptions


def synthetic_batch(B: int, H: int, W: int, device, seed: int = 0) -> PairBatch:
    """Smooth random images, image 1 a shifted crop of image 0, with
    intrinsics of focal length 517.97 px centred in the image."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(B, 1, H // 8 + 2, W // 8 + 2, generator=g)
    img = torch.nn.functional.interpolate(low, size=(H + 16, W + 32),
                                          mode="bilinear", align_corners=True)
    K = torch.tensor([[517.97, 0.0, W / 2.0], [0.0, 517.97, H / 2.0],
                      [0.0, 0.0, 1.0]]).expand(B, 3, 3).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous().to(device)
    return PairBatch(image0=nhwc(img[:, :, :H, :W]), image1=nhwc(img[:, :, 16:, 32:]),
                     K0=K.to(device), K1=K.to(device))


class StageTimer:
    """CUDA event pairs around named stages, read after one synchronize;
    ``prefix`` is put before the names of the stages that start while it
    is set."""

    def __init__(self):
        self.events = []
        self.prefix = ""

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            label = self.prefix + name
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((label, start, end))
            return out
        return timed

    def totals(self):
        torch.cuda.synchronize()
        out = collections.OrderedDict()
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def busy_ms(prof) -> float:
    """Length of the union of the trace's device kernel intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def round_profile(call):
    """(kernels launched, their device ms, host ms) of one solver round,
    traced alone: every kernel in the trace belongs to it (copies and
    memsets are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    return len(kernels), dev_ms, wall


def report(title: str, timer: StageTimer, fn, t0: float) -> None:
    """Print the request's stage table (``fn`` has just run under
    ``timer``, started at host time ``t0``), then trace one more request."""
    stages = timer.totals()
    wall = (time.perf_counter() - t0) * 1e3
    request = stages.pop("request")
    print(f"{title}: request {request:.3f} ms on the device clock, {wall:.3f} ms on "
          f"the host clock")
    for name, ms in stages.items():
        print(f"  {name:40s} {ms:9.3f} ms  {100 * ms / request:5.1f} %")
    rest = request - sum(stages.values())
    print(f"  {'rest (glue, copies, launches)':40s} {rest:9.3f} ms  "
          f"{100 * rest / request:5.1f} %")
    trace(fn)


def trace(fn):
    """One more request under torch.profiler: its idle share and the
    busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof)
    if busy == 0:
        print(f"traced request: {traced:.3f} ms wall; the trace shows no device kernel")
        return
    print(f"traced request: {traced:.3f} ms wall, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / traced:.3f}")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    for dev_us, count, key in sorted(rows, reverse=True)[:25]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def profile_vitess(args, dev) -> None:
    from far_tpu_torch.models.vitess import ViTEssConfig

    matcher = init_model(FARConfig(dtype=args.dtype), seed=0, device=dev)
    model = pipeline_mod.init_vitess(ViTEssConfig(use_loftr_gating=True, dtype=args.dtype),
                                     seed=1, device=dev)
    batch = synthetic_batch(args.batch, *matcher.config.image_size, dev)
    images = torch.rand(args.batch, 2, 224, 224, 3,
                        generator=torch.Generator().manual_seed(11)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fn():
        with torch.inference_mode():
            return pipeline_mod.vitess_forward(model, images, matcher, batch, generator=gen)

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    timer = StageTimer()
    matcher.match = timer.wrap("gating matcher (K1, K2, K3)", matcher.match)
    for mod in (model.resnet, model.extractor_final_conv):
        mod.forward = timer.wrap("trunk + RAFT block", mod.forward)
    blocks = model.fusion_transformer.blocks
    for blk in blocks[:-1]:
        blk.forward = timer.wrap("ViT blocks", blk.forward)
    blocks[-1].forward = timer.wrap("CrossBlock (K4 x2)", blocks[-1].forward)
    model.heads = timer.wrap("heads (pose MLP, MoE, decode)", model.heads)
    saved = pipeline_mod.estimate_pose
    pipeline_mod.estimate_pose = timer.wrap("solver (8pt, no prior)", saved)
    try:
        t0 = time.perf_counter()
        timer.wrap("request", fn)()
    finally:
        pipeline_mod.estimate_pose = saved
    report(f"vitess_forward {args.dtype} B={args.batch} 224x224 (matcher 480x640)",
           timer, fn, t0)


def profile_mapfree(args, dev) -> None:
    from far_tpu_torch.models.sixdreg import SixDRegConfig

    matcher = init_model(FARConfig(image_size=(720, 544), regress_rt=False,
                                   dtype=args.dtype), seed=0, device=dev)
    reg = pipeline_mod.init_sixdreg(SixDRegConfig(dtype=args.dtype), seed=1, device=dev)
    batch = synthetic_batch(args.batch, *matcher.config.image_size, dev)
    g = torch.Generator().manual_seed(12)
    im0, im1 = (torch.rand(args.batch, *reg.config.image_hw, 3, generator=g).to(dev)
                for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(0)

    def fn():
        with torch.inference_mode():
            return pipeline_mod.mapfree_forward(matcher, reg, batch, im0, im1,
                                                generator=gen)

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    timer = StageTimer()
    matcher.match = timer.wrap("matcher (K1, K2, K3)", matcher.match)
    for mod, name in ((reg.encoder, "ResUNet x2"), (reg.aggregator, "correlation volume"),
                      (reg.head, "head"), (reg.transformer, "transformer")):
        mod.forward = timer.wrap(name, mod.forward)
    reg.fuse = timer.wrap("pose MLP and MoE", reg.fuse)
    saved = pipeline_mod.estimate_pose
    timed_solver = timer.wrap("solver", saved)
    rounds = []

    def solver_round(*a, **kw):
        timer.prefix = f"round {len(rounds)}: "
        rounds.append(kw["cfg"].solver)
        return timed_solver(*a, **kw)

    pipeline_mod.estimate_pose = solver_round
    try:
        t0 = time.perf_counter()
        timer.wrap("request", fn)()
    finally:
        pipeline_mod.estimate_pose = saved
    report(f"mapfree_forward {args.dtype} B={args.batch} 368x272 (matcher 720x544), "
           f"rounds {rounds}", timer, fn, t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="far", choices=("far", "vitess", "mapfree"))
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--solver", default=FARConfig().solver.minimal_solver,
                    choices=("5pt", "8pt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    dev = torch.device("cuda")
    # float32 means float32 in every product, as in chip_smoke.py: cuDNN
    # would otherwise run f32 convolutions in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.family != "far":
        (profile_vitess if args.family == "vitess" else profile_mapfree)(args, dev)
        return 0
    cfg = FARConfig(solver=SolverOptions(minimal_solver=args.solver), dtype=args.dtype)
    model = init_model(cfg, seed=0, device=dev)
    batch = synthetic_batch(args.batch, *cfg.image_size, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def eager():
        with torch.inference_mode():
            return pipeline_mod.far_forward(model, batch, gen)

    for _ in range(2):
        eager()
    torch.cuda.synchronize()

    # the stages, timed over the eager far_forward: a CUDA graph replay
    # calls no module method, so wrappers around them see nothing
    timer = StageTimer()
    wrapped = [(model.backbone, "forward", "backbone"),
               (model.loftr_coarse, "forward", "coarse transformer (K1)"),
               (model, "fine_stage", "fine stage (gather, K3, soft-argmax)"),
               (model, "regress_features", "EMM features (K4)"),
               (model, "regress_fuse", "MoE fusion")]
    for obj, attr, name in wrapped:
        setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))
    saved = (loftr_mod.coarse_match, pipeline_mod.estimate_pose)
    rounds = []  # each solver round's arguments, replayed alone below

    def solver_round(*a, **kw):
        rounds.append((a, kw))
        return saved[1](*a, **kw)

    loftr_mod.coarse_match = timer.wrap("coarse match (K2, top-k)", saved[0])
    pipeline_mod.estimate_pose = timer.wrap("solver round", solver_round)
    try:
        t0 = time.perf_counter()
        timer.wrap("request", eager)()
    finally:
        loftr_mod.coarse_match, pipeline_mod.estimate_pose = saved
        for obj, attr, _ in wrapped:
            delattr(obj, attr)  # the class's method again
    title = f"{args.dtype} {args.solver} B={args.batch} {cfg.image_size[0]}x{cfg.image_size[1]}"
    report(f"eager far_forward {title}", timer, eager, t0)
    for i, (a, kw) in enumerate(rounds):
        with torch.inference_mode():
            n, dev_ms, wall = round_profile(lambda: saved[1](*a, **kw))
        print(f"solver round {i} ({kw['cfg'].num_hypotheses} hypotheses, "
              f"{args.solver}) traced alone: {n} kernels, {dev_ms:.3f} ms of "
              f"device time, {wall:.3f} ms wall")
    del rounds
    torch.cuda.empty_cache()

    # the compiled request (build_inference_fn: one CUDA graph replay)
    fn = build_inference_fn(model)
    for _ in range(2):  # the first call captures
        fn(batch, generator=gen)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"compiled far_forward {title} (build_inference_fn, CUDA graph): "
          f"{statistics.median(times):.3f} ms on the host clock (median of "
          f"{[round(t, 3) for t in times]}), graph pool {fn.pool_bytes() / 2**30:.3f} GiB")
    print("compiled far_forward stages, device ms of the last replay from the graph's "
          "marks: " + ", ".join(f"{k} {v:.3f}" for k, v in fn.stage_ms().items()))
    trace(lambda: fn(batch, generator=gen))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
