"""A/B of the coarse layers' weight casts on one far_forward request.

Run from the repository root on a machine with a CUDA card:

    python3 -m far_tpu_torch.tools.pack_cache_ab [--dtype bfloat16] [--blocks 4]

Arm ``per_call``: the model as it is, every ``LoFTREncoderLayer`` call
casts its weights to the kernels' layout (``ops.loftr_layer.pack_params``,
~10 small launches a layer). Arm ``once``: each layer's pack is built
once before the requests and passed to the kernel as it is. The model is
``FARConfig`` at its defaults (480x640, full width, 8-point solver,
random weights from seed 0) at B=4. The arms alternate in blocks (once,
per_call, per_call, once, ...) of five requests, each timed on the host
clock up to a ``torch.cuda.synchronize()``; then one request of each arm
is traced for the card's idle share. Prints the median ms per request
of each arm.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from far_tpu_torch.models.transformer import LoFTREncoderLayer
from far_tpu_torch.ops.loftr_layer import loftr_layer, pack_params
from far_tpu_torch.pipeline import build_inference_fn, init_model
from far_tpu_torch.tools.profile_forward import busy_ms, synthetic_batch
from far_tpu_torch.utils.config import FARConfig, SolverOptions

REQUESTS_PER_BLOCK = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--blocks", type=int, default=4, help="blocks of each arm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pack_cache_ab: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FARConfig(solver=SolverOptions(minimal_solver="8pt"), dtype=args.dtype)
    model = init_model(cfg, seed=0, device=dev)
    fn = build_inference_fn(model)
    batch = synthetic_batch(4, *cfg.image_size, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, args.dtype)
    packs = {id(m): pack_params(m.raw(), dtype) for m in model.modules()
             if isinstance(m, LoFTREncoderLayer)}

    def once(self, x, source):
        return loftr_layer(x, source, packs[id(self)], self.nhead)

    arms = {"once": once, "per_call": LoFTREncoderLayer.forward}

    def run(arm, n):
        LoFTREncoderLayer.forward = arms[arm]
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    times = {arm: [] for arm in arms}
    idle = {}
    try:
        for arm in arms:  # warm-up
            run(arm, 2)
        order = ["once", "per_call", "per_call", "once"]
        for i in range(2 * args.blocks):
            arm = order[i % 4]
            times[arm] += run(arm, REQUESTS_PER_BLOCK)
        from torch.profiler import ProfilerActivity, profile

        for arm in arms:
            LoFTREncoderLayer.forward = arms[arm]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(batch, generator=gen)
                torch.cuda.synchronize()
                traced = (time.perf_counter() - t0) * 1e3
            idle[arm] = 1 - busy_ms(prof) / traced
    finally:
        LoFTREncoderLayer.forward = arms["per_call"]
    for arm, ts in times.items():
        print(f"far_forward {args.dtype} B=4 weights cast {arm}: ms/request median "
              f"{statistics.median(ts):.3f} (min {min(ts):.3f}, max {max(ts):.3f}, "
              f"n {len(ts)}), traced idle share {idle[arm]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
