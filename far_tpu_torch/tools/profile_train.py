"""Where one training step spends its time on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m far_tpu_torch.tools.profile_train [--family far|vitess|sixdreg]
        [--dtype float32] [--batch N] [--steps 3] [--cudnn-benchmark]

``--family far`` (the default): ``FARConfig`` at its defaults (480x640,
full width, the 5-point solver) with random weights from seed 0, trained
by ``far_tpu_torch.train.Trainer`` (AdamW, lr 5e-5, no warm-up) on one
batch of B=2 synthetic pairs with depth; stages: the forward's (backbone,
coarse transformer, coarse match on the dense matrix, fine stage, EMM
features, each solver round, each MoE fusion), the supervision, the
losses, the backward and the optimizer, and inside them K1's and K4's
forward launches against their backward's recompute through the plain
versions. ``--family vitess``: ``ViTEssTrainer`` with the interiornet
preset's model (gated, dim 192, depth 6) on B=6 ``SolverPoseDataset``
pairs at 384x512; stages: trunk + RAFT block, ViT blocks, CrossBlock (K4
x2 forward), heads, losses, backward (K4's plain recompute apart),
optimizer. ``--family sixdreg``: ``SixDRegTrainer`` with the mapfree
preset's ``SixDRegConfig()`` on B=6 ``GTCorrespondenceDataset`` pairs at
368x272; stages: the MAGSAC round, ResUNet x2, the correlation volume,
the head, the transformer, pose MLP and MoE, losses, backward,
optimizer. The family trainers take their preset's optimizer
(interiornet: Adam, OneCycle from 5e-4 / 25, clip 1; mapfree: Adam 1e-5,
clip 1). After ``--steps`` warm-up steps it times one step
by stage with CUDA events, then traces one more with ``torch.profiler``
and prints the share of the step's wall time in which the card ran no
kernel, the busiest kernels, and the peak memory the card reports.
"""

from __future__ import annotations

import argparse
import time

import torch

import far_tpu_torch.models.loftr as loftr_mod
import far_tpu_torch.train.trainer as trainer_mod
from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
from far_tpu_torch.ops import bilinear_attention as k4_mod
from far_tpu_torch.ops import loftr_layer as k1_mod
from far_tpu_torch.tools.profile_forward import StageTimer, busy_ms
from far_tpu_torch.train.optim import OptimConfig
from far_tpu_torch.train.trainer import Trainer
from far_tpu_torch.utils.config import FARConfig


def _wrap_function(timer: StageTimer, fn_cls, name: str):
    """Time an autograd.Function's forward and backward under ``name``."""
    saved = (fn_cls.forward, fn_cls.backward)
    fn_cls.forward = staticmethod(timer.wrap(f"{name} forward (kernel)", saved[0]))
    fn_cls.backward = staticmethod(timer.wrap(f"{name} backward (plain recompute)",
                                              saved[1]))
    return lambda: (setattr(fn_cls, "forward", staticmethod(saved[0])),
                    setattr(fn_cls, "backward", staticmethod(saved[1])))


def profile_far(args, dev) -> None:
    cfg = FARConfig(dtype=args.dtype)
    trainer = Trainer(cfg, OptimConfig(lr=5e-5, warmup_steps=0, scheduler="none"),
                      device=dev).init(seed=0)
    ds = SyntheticPairDataset(n=args.batch, hw=cfg.image_size, seed=0)
    batch, _ = collate([ds[i] for i in range(args.batch)], dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(args.steps):
        trainer.step(batch, generator=gen)
    torch.cuda.synchronize()

    timer = StageTimer()
    model = trainer.model
    undo = [_wrap_function(timer, k1_mod._LoftrLayerFn, "K1"),
            _wrap_function(timer, k4_mod._BilinearFn, "K4")]
    saved_modules = [(m, m.forward) for m in (model.backbone, model.loftr_coarse)]
    model.backbone.forward = timer.wrap("backbone", model.backbone.forward)
    model.loftr_coarse.forward = timer.wrap("coarse transformer (K1 x16)",
                                            model.loftr_coarse.forward)
    model.fine_stage = timer.wrap("fine stage (gather, layer loop, soft-argmax)",
                                  model.fine_stage)
    model.regress_features = timer.wrap("EMM features (K4 x2)", model.regress_features)
    model.regress_fuse = timer.wrap("MoE fusion", model.regress_fuse)
    globals_ = [(loftr_mod, "coarse_match", "coarse match (dense conf, top-k)"),
                (trainer_mod, "estimate_pose", "solver rounds (no grad)"),
                (trainer_mod, "coarse_supervision", "supervision"),
                (trainer_mod, "fine_supervision", "supervision"),
                (trainer_mod, "compute_losses", "losses")]
    saved_globals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in globals_]
    for mod, attr, name in globals_:
        setattr(mod, attr, timer.wrap(name, getattr(mod, attr)))
    try:
        t0 = time.perf_counter()
        step_start, step_end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        step_start.record()
        trainer.optimizer.zero_grad()
        losses, _ = timer.wrap("forward", trainer.loss)(batch, gen)
        timer.wrap("backward", losses.total.backward)()
        timer.wrap("optimizer", trainer.optimizer.step)()
        step_end.record()
        stages = timer.totals()
        step = step_start.elapsed_time(step_end)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for fn in undo:
            fn()
        for m, fwd in saved_modules:
            m.forward = fwd
        for name in ("fine_stage", "regress_features", "regress_fuse"):
            delattr(model, name)
        for mod, attr, fn in saved_globals:
            setattr(mod, attr, fn)
    print(f"train step {args.dtype} B={args.batch} {cfg.image_size[0]}x{cfg.image_size[1]}"
          f"{' (cudnn.benchmark)' if args.cudnn_benchmark else ''}: "
          f"{step:.3f} ms on the device clock, {wall:.3f} ms on the host clock")
    for name in ("forward", "backward", "optimizer"):
        ms = stages.pop(name)
        print(f"  {name:48s} {ms:9.3f} ms  {100 * ms / step:5.1f} %")
    print("inside them:")
    for name, ms in stages.items():
        print(f"  {name:48s} {ms:9.3f} ms  {100 * ms / step:5.1f} %")
    trace_step(lambda: trainer.step(batch, generator=gen))


def trace_step(run_step) -> None:
    """One more step under torch.profiler: its idle share, the peak memory
    and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof)
    print(f"traced step: {traced:.3f} ms wall, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / traced:.3f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    for dev_us, count, key in sorted(rows, reverse=True)[:20]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def _wrap_modules(timer: StageTimer, spans):
    """Time each (module, name)'s forward; returns the undo."""
    saved = [(m, m.forward) for m, _ in spans]
    for m, name in spans:
        m.forward = timer.wrap(name, m.forward)
    return lambda: [setattr(m, "forward", fwd) for m, fwd in saved]


def profile_family(args, dev) -> None:
    """One ViTEssTrainer or SixDRegTrainer step by stage (see the module note)."""
    import dataclasses

    import far_tpu_torch.train.family_trainers as fam
    from far_tpu_torch.configs import PRESETS
    from far_tpu_torch.data.synthetic import GTCorrespondenceDataset, SolverPoseDataset

    # each preset's model and optimizer, as chip_smoke.py's phase 13 trains
    preset = PRESETS["interiornet" if args.family == "vitess" else "mapfree"]()
    cfg = dataclasses.replace(preset.model, dtype=args.dtype)
    if args.family == "vitess":
        trainer = fam.ViTEssTrainer(cfg, preset.optim, device=dev).init(seed=0)
        hw = (384, 512)
        ds = SolverPoseDataset(SyntheticPairDataset(n=args.batch, hw=hw, seed=0))
        batch = fam.collate_vitess([ds[i] for i in range(args.batch)], dev)
    else:
        trainer = fam.SixDRegTrainer(cfg, preset.optim, device=dev).init(seed=0)
        hw = cfg.image_hw
        ds = GTCorrespondenceDataset(SyntheticPairDataset(n=args.batch, hw=hw, seed=0),
                                     max_matches=512)
        batch = fam.collate_sixdreg([ds[i] for i in range(args.batch)], dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    for _ in range(args.steps):
        trainer.step(batch, generator=gen())
    torch.cuda.synchronize()

    timer = StageTimer()
    model = trainer.model
    undo = [_wrap_function(timer, k4_mod._BilinearFn, "K4")]
    if args.family == "vitess":
        blocks = model.fusion_transformer.blocks
        undo.append(_wrap_modules(timer, [
            (model.resnet, "trunk + RAFT block"),
            (model.extractor_final_conv, "trunk + RAFT block"),
            *[(b, "ViT blocks") for b in blocks[:-1]],
            (blocks[-1], "CrossBlock (K4 x2 forward)")]))
        model.heads = timer.wrap("heads (pose MLP, MoE, decode)", model.heads)
        undo.append(lambda: delattr(model, "heads"))
    else:
        undo.append(_wrap_modules(timer, [
            (model.encoder, "ResUNet x2"), (model.aggregator, "correlation volume"),
            (model.head, "head"), (model.transformer, "transformer")]))
        model.fuse = timer.wrap("pose MLP and MoE", model.fuse)
        undo.append(lambda: delattr(model, "fuse"))
        saved = (fam.estimate_pose, fam.combined_loss)
        fam.estimate_pose = timer.wrap("solver round (MAGSAC, no grad)", saved[0])
        fam.combined_loss = timer.wrap("losses", saved[1])
        undo.append(lambda: (setattr(fam, "estimate_pose", saved[0]),
                             setattr(fam, "combined_loss", saved[1])))
    try:
        t0 = time.perf_counter()
        step_start, step_end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        step_start.record()
        trainer.optimizer.zero_grad()
        loss, _ = timer.wrap("forward", trainer.loss)(batch, gen())
        timer.wrap("backward", loss.backward)()
        timer.wrap("optimizer", trainer.optimizer.step)()
        step_end.record()
        stages = timer.totals()
        step = step_start.elapsed_time(step_end)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for fn in reversed(undo):
            fn()
    print(f"train step {args.family} {args.dtype} B={args.batch} {hw[0]}x{hw[1]}: "
          f"{step:.3f} ms on the device clock, {wall:.3f} ms on the host clock")
    for name in ("forward", "backward", "optimizer"):
        ms = stages.pop(name)
        print(f"  {name:48s} {ms:9.3f} ms  {100 * ms / step:5.1f} %")
    print("inside them:")
    for name, ms in stages.items():
        print(f"  {name:48s} {ms:9.3f} ms  {100 * ms / step:5.1f} %")
    trace_step(lambda: trainer.step(batch, generator=gen()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="far", choices=("far", "vitess", "sixdreg"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs a step (far 2; vitess, sixdreg 6)")
    ap.add_argument("--steps", type=int, default=3, help="warm-up steps")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its convolution algorithms (off in the trainers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    if args.batch is None:
        args.batch = 2 if args.family == "far" else 6
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    (profile_far if args.family == "far" else profile_family)(args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
