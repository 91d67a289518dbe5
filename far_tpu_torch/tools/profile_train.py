"""Where one training step spends its time on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m far_tpu_torch.tools.profile_train [--dtype float32] [--batch 2]
        [--steps 3] [--cudnn-benchmark]

The model is ``FARConfig`` at its defaults (480x640, full width, the
5-point solver) with random weights from seed 0, trained by
``far_tpu_torch.train.Trainer`` (AdamW, lr 5e-5, no warm-up) on one
batch of synthetic pairs with depth. After ``--steps`` warm-up steps it
times one step by stage with CUDA events: the forward's stages (backbone,
coarse transformer, coarse match on the dense matrix, fine stage, EMM
features, each solver round, each MoE fusion), the supervision, the
losses, the backward and the optimizer; inside them K1's and K4's
forward launches against their backward's recompute through the plain
versions. Then it traces one more step with ``torch.profiler`` and prints
the share of the step's wall time in which the card ran no kernel, the
busiest kernels, and the peak memory the card reports.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3, help="warm-up steps")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its convolution algorithms (off in the trainer)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
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

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch, generator=gen)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
