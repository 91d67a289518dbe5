#!/usr/bin/env python3
"""Drive far_tpu_torch, the PyTorch + CUDA port of FAR, on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports nothing
of JAX or of ``far_tpu``. It checks the port end to end on the card; the
kernels' own checks at their other shapes are the ``cuda`` tests
(``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_hopper.py tests/test_torch_mapfree_compiled.py
tests/test_torch_backbone_glue.py``), and
the inference requests' speed is the benchmark's (``h100bench/``).
Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``far_tpu_torch/csrc`` (one ``nvcc`` per source,
   all started together);
3. each kernel alone: K1-K4 at the main path's shapes (B=2 pairs), in
   float32 and bfloat16, launched next to its plain PyTorch version on the
   same inputs and held to a stated tolerance (float32: 1e-4 max|ref|
   against the plain version in strict float32, TF32 off), both timed with
   CUDA events, with a PyTorch library call timed beside it where one
   computes the same function, the bound, and the route that ran read
   from the launch counters (K1, K3 and K4 in float32 must take their
   3xTF32 tensor-core routes, ``launches_tf32``); then the fused 5-point
   kernel at the benchmark cells' rounds (B=1 and 16 pairs, 102 and 51
   samples; held to its plain version at 16 and 102) and the small-matrix
   kernels at the polish's shapes (one round at B=4, held to
   ``torch.linalg``), each timed beside its plain version with its bound;
   and the backbone's glue (``ops/backbone_glue.py``): the 17 calls of an
   offline request (B=16 pairs, 480x640) against the unfused sequence, bf16
   bit for bit, float32 within 2 ulp of the largest output, timed against
   their bytes at 3.35 TB/s.
   Float32 bounds are 3xTF32's on the tensor cores (495 / 3 = 165
   TFLOP/s), with the CUDA cores' 67 TFLOP/s beside them
   (``bound_cuda_core_ms``). This is the one source of PERF.md section
   6's table of each kernel alone;
4. the compiled request (the request captured in a CUDA graph once per
   signature and replayed): ``build_inference_fn`` at 480x640 and full
   width, B=4, for FARConfig() in float32 and bfloat16 with the 5-point
   and the 8-point solver, and ``build_mapfree_fn`` at the map-free cell's
   shapes (B=1, a 720x544 matcher, SixDRegConfig() at 368x272, bf16),
   against the eager ``far_forward`` / ``mapfree_forward`` on the same
   batches and generator states: the first call's warm-up counted one
   request's launches by the wrappers (K1/K2/K3/K4 16/1/1/2 on the dtype's
   routes, map-free 16/1/1/0; 6 small_linalg; 2 fused 5-point with the
   5-point solver; the backbone's glue bn_act/bn_add_act/up2_add 9/6/2,
   the BatchNorm glue 15 launches and the NHWC up2_add 2 in the trace),
   two replays under ``torch.cuda.set_sync_debug_mode(
   "error")``, three replays under a profiler trace with the same counts
   a request, the first call and the replays of two batches bit for bit
   against their eager requests, then B=2 captured into the same pool and
   an in-place ``load_state_dict`` of other weights, bit for bit again;
5. the matcher and the EMM features at a small width with the kernels on
   the card and with the plain versions on the CPU, compared;
6. the port's solver on 16 synthetic scenes at 0.5 px noise, 5-point and
   8-point;
7. the network guard: ``assets/tiny_guard.npz`` (trained tiny weights)
   through ``far_forward`` on 16 synthetic pairs, float32 and bfloat16,
   held to the JAX package's gate (bench.py); float32 also with the plain
   5-point solve in the fused kernel's place, each median pinned;
8. training (``far_tpu_torch.train.Trainer``): (a) the differentiable
   forms of K1, K4 and K3 at the main shapes in float32 and bfloat16
   against autograd through their plain versions on the card; (b) one
   step's losses, gradients and BatchNorm statistics at a small width, the
   card against the CPU; (c) ``FARConfig()`` at 480x640, 10 steps on one
   batch in float32 and in bfloat16, with the launch counters set to 0
   before each step and read after it (K1 16, K4 2, K2 and K3 0); (a) also
   holds that each bare wrapper (K1, K3, K4) refuses CUDA inputs that
   require grad in grad mode, where its output would carry no gradient;
9. validation (``far_tpu_torch.train.validation.validate_far``): (a) the
   network guard's weights on its 16 pairs, float32 and bfloat16, the
   table's median rotation error equal to phase 7's to 0.01 deg and under
   its gate; (b) ``FARConfig()`` in bfloat16 at 480x640 and full width, 16
   pairs at B=4 through one compiled request under a profiler trace: 16
   pairs in the table, every entry finite, K1/K2/K3/K4 launched 16/1/1/2
   times a batch;
10. Sinkhorn matching and backbone remat at 480x640 and full width: (a) a
   Sinkhorn request at B=4 in float32 and bfloat16 (from a profiler trace:
   K2 0 launches, K1/K3/K4 16/1/2); (b) one Sinkhorn training step at B=2 in bfloat16, with a
   finite nonzero gradient of the dustbin score; (c) one bfloat16 step at
   B=2 under remat False, "full" and "selective" from the same weights
   and draws: gradients and BatchNorm statistics against the step without
   remat, and each step's peak memory ("full" below False); (d) one step
   at B=8 with remat "full", its peak memory and time;
11. ViTEss (``far_tpu_torch.models.vitess``): (a) ``tests/golden/
   vitess_seed0.npz`` replayed with weights from ``far_tpu_torch.utils.
   parity.synth_state_dict``, f32 (TF32 off) with every tap under the CPU
   tests' gate, and bf16: finite, an orthonormal rotation and within
   BF16_GATE max|f32| of the f32 replay; (b) ``vitess_forward`` at full
   width, B=4: ViTEss gated by a ``FARConfig()`` matcher at 480x640 (the
   launch counters, set to 0 before each request, read K1/K2/K3/K4
   16/1/1/2) and alone (0/0/0/2), three requests each in f32 and bf16;
12. map-free 6DReg (``far_tpu_torch.models.sixdreg``): (a)
   ``tests/golden/sixdreg_seed0.npz`` as in 11 (a); (b) ``mapfree_forward``
   at full width, B=4: a 720x544 ``FARConfig(regress_rt=False)`` matcher
   and ``SixDRegConfig()`` at 368x272, three requests each in f32 and
   bf16, counters 16/1/1/0 a request, finite outputs, R orthonormal to
   1e-3, and the peak memory.
13. the families' training (``far_tpu_torch.train.family_trainers``):
   (a) the device ms of K4's forward and backward (the plain recompute)
   through its differentiable form at a ViTEss step's shape (6, 3, 576,
   64, 70); ``ViTEssTrainer`` with the
   interiornet preset's model (gated, dim 192, depth 6) on B=6 pairs at
   384x512, 10 steps on one batch in f32 and bf16 with the preset's
   optimizer (counters, set to 0 before each step: K4 2, K1/K2/K3 0), the
   loss falling, then an ``eval_step`` that changes nothing; (b)
   ``SixDRegTrainer`` with the mapfree preset's ``SixDRegConfig()`` and
   optimizer on B=6 pairs at 368x272 with 512 ground-truth matches, the
   MAGSAC round on the card inside each step, 10 steps in f32 and bf16
   (no kernel launched), then 3 with lam = 0 moving s_r and s_t; each
   run's ms per step and peak memory; (c) one step of each trainer at
   the CPU tests' small widths on the card against the CPU: in float32
   (K4 launched), and in float64 with cuDNN's convolution and PyTorch's
   own, every gradient to 1e-9;
14. the classical map-free baseline: ``FeatureMatchingModel`` behind an
   oracle ``PrecomputedMatching`` on 16 synthetic scenes at 480x640, its
   essential, essential-metric and PnP solvers on the card, held to
   tests/test_metric_solvers.py's gates;
15. the entry points: each CLI's ``main(argv)`` in-process with
   ``--device cuda``, each call's launches read from a profiler trace of
   it (eager launches and compiled requests' replays alike): (a)
   ``evaluate`` on 16 synthetic pairs, ``FARConfig()`` in bf16 at B=4
   (K1/K2/K3/K4 64/4/4/8, the tensor-core routes the same; a finite table,
   the five files); (b) ``evaluate --model vitess`` (K4 4); (c) ``evaluate
   --dataset mp3d`` on 8 Matterport-layout PNG pairs (decode, the native
   resize, the intrinsics guard; 16/1/1/2 a batch); (d) ``train`` of
   FARConfig() for 3 steps at B=2 (K1 48, K4 6), its checkpoint restored
   bit-equal by ``evaluate --ckpt_dir``, ``--resume`` taking no step, and
   the interiornet and mapfree presets for 2 steps (K4 2 and 0 a step);
   (e) ``precompute --matcher loftr`` on 4 pairs (16/1/1/0 a pair); (f) ``submission`` on a map-free fixture
   scene, 4 pairs (16/1/1/0 a pair), scored by
   ``far_tpu_torch.eval.mapfree_benchmark``; (g) ``demo --synthetic`` and
   ``demo --synthetic --mapfree``, an orthonormal R each.
16. the FARConfig options and the other matchers: (a) K1, K2 and K4 at
   the 16/4 backbone's shapes (1200 coarse tokens at 480x640, B=2)
   against their plain versions, then ``far_forward`` under
   ``BackboneConfig(resolution=(16, 4), block_dims=(128, 128, 256,
   256))``, (b) under GroupNorm (``block_dims=(128, 192, 256)``) and (c)
   with full attention in the coarse and fine stacks, each three timed
   requests of B=4 at 480x640 in f32 and bf16 and three under a profiler
   trace (16/1/1/2 a request, full attention 0/1/0/2),
   the peak memory; GroupNorm on a bf16 map, card against CPU; (d)
   SuperPoint + SuperGlue at their defaults on B=4 pairs, ms a pair, the
   first pair against the CPU; (e) SimpleTransformer on a FARConfig()
   request's matches and first-round pose, card against CPU; (f)
   ``precompute --matcher superglue`` and ``--matcher sift`` on 4 pairs
   (no FAR kernel).
17. the last single-process modules: (a) three compiled bf16 requests
   (``FARConfig()``, B=4, 480x640) inside
   ``utils.prof.InferenceProfiler.profile``: 3 regions, the first's R, t
   and gate equal to unprofiled requests' from the same generator state
   within their own spread; (b) visloc: one query and 5 reference views,
   the pairs solved by the 5-point RANSAC on the card, then
   ``eval.localize``'s pipelines with and without RANSAC on the host,
   position error < 0.5; (c) ``validate_far(fig_dir=...)`` with the guard's
   weights: without matplotlib an ImportError naming it and the pass
   without figures at phase 9's median (0.01 deg), with it two PNGs; (d)
   each 6DReg aggregator and head, f32, card against CPU within 1e-4
   max|ref|, and ``mapfree_forward`` in bf16 with the aggregator flags
   normalise_dot, cv_half_channels and position_encoder_im1 (16/1/1/0).
18. data parallelism (``far_tpu_torch.parallel.comm``, DDP in the
   trainers): (a) a process group of one over NCCL in this process,
   FARConfig() bf16 at B=2: 3 DDP steps bit-equal to 3 plain Trainer
   steps from the same weights and generator (deterministic algorithms;
   the plain run repeated to show it reproduces), K1 16 and K4 2 a step;
   (b) two ranks on the card over gloo (subprocesses of this script,
   ``--ddp-worker``): one float32 step (TF32 off) on a global batch of 4
   against one process here, and the same step with bn's moments summed
   by an all-reduce autograd does not see, which the backbone's tolerance
   must fail; then 3 bf16 steps with their ms, the
   gradient all-reduce's share (against DDP's ``no_sync``) and each
   rank's peak memory; (c) one float64 step of ViTEssTrainer (interiornet
   preset, B=6) and SixDRegTrainer (mapfree preset) on two ranks against
   one process; (d) validate_far on two ranks with the guard's weights and
   phase 7's draws (the median within 0.01 deg of phase 7's, K1/K2/K3/K4
   8/1/1/2 a batch a rank) and with FARConfig() in bf16 at 480x640
   (16/1/1/2 a batch a rank); (e) ``python -m torch.distributed.run
   --nproc_per_node 1`` of ``cli.train`` (FARConfig() bf16, 3 steps at
   B=2) and ``cli.evaluate --ckpt_dir``, the checkpoint restored bit-equal.
Prints one JSON line with phase 3's numbers of each kernel, then the card
line, and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present. ``--ddp-worker <dir>`` runs one
rank of phase 18 (b)-(d); phase 18 starts those itself.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 and TF32 tensor cores, HBM3 bandwidth. A float32-accurate
# product's least time is on the tensor cores as three TF32 passes
# (3xTF32, 165 TFLOP/s): the float32 bound_ms. The CUDA cores' 67 TFLOP/s
# is kept beside it as bound_cuda_core_ms.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32_TC = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
EX2_PER_CLOCK_SM = 16  # exponentials (MUFU.EX2) per clock per SM, sm_90

B_KERNEL = 2        # pairs at which the kernels are held to their plain versions
B_REQUEST = 4       # pairs per far_forward request
N_REQUESTS = 3
L_COARSE = 60 * 80  # coarse tokens at 480x640
C_COARSE, H_COARSE = 256, 8
K_MATCH, WW, C_FINE, H_FINE = 1024, 25, 128, 8
H_EMM, D_EMM = 4, 64
VITESS_TRAIN_K4 = (6, 3, 576, 64, 70)  # K4 in a ViTEss training step at B=6: B, H, N, D, Dv


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def exp_rate() -> float:
    """Exponentials per second at the card's maximum SM clock."""
    import torch

    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK_SM * sms * mhz * 1e6


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float):
    """The larger of the operations' time at their type's peak and the
    bytes' time at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dtype_bounds(dt, flops: float, nbytes: float) -> dict:
    """bound_ms / bound_by for a kernel's dtype (float32: 3xTF32 on the
    tensor cores; bfloat16: its tensor cores), and for float32 also
    bound_cuda_core_ms, the same work at the CUDA cores' 67 TFLOP/s."""
    import torch

    f32 = dt == torch.float32
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_TC if f32 else PEAK_BF16)
    out = dict(bound_ms=b_ms, bound_by=b_by)
    if f32:
        out["bound_cuda_core_ms"] = bound_ms(flops, nbytes, PEAK_F32)[0]
    return out


def took_route(wrapper, before) -> str:
    """The route a wrapper's last launch took, from its counters against
    ``before`` = (launches_tc, launches_tf32) read before it."""
    if wrapper.launches_tc > before[0]:
        return "tensor cores"
    if getattr(wrapper, "launches_tf32", 0) > before[1]:
        return "tensor cores, 3xTF32"
    return "cuda cores"


def route_counts(wrapper):
    return wrapper.launches_tc, getattr(wrapper, "launches_tf32", 0)


def layer_params(C: int, g, device):
    import torch

    def w(o, i):
        return (torch.randn(o, i, generator=g) / math.sqrt(i)).to(device)

    def ln():
        return torch.stack([1 + 0.05 * torch.randn(C, generator=g),
                            0.05 * torch.randn(C, generator=g)]).to(device)

    return {"wq": w(C, C), "wk": w(C, C), "wv": w(C, C), "wm": w(C, C),
            "w0": w(2 * C, 2 * C), "w1": w(C, 2 * C), "ln1": ln(), "ln2": ln()}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def k2_errors(a, b, outs):
    """K2's outputs against its plain version: (max abs error of the row
    and column maxima and of the plain confidence at the kernel's row
    index, tolerance 1e-6 + 1e-4 max|ref|, row indices that differ, mutual
    pairs of the plain version that the kernel's test drops). An index may
    differ only where the plain confidence has a near-tie."""
    import torch

    from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol_plain

    rv, ri, cm = outs
    prv, pri, pcm = dual_softmax_rowcol_plain(a, b, 10.0)
    torch.cuda.synchronize()
    sim = torch.einsum("blc,bsc->bls", a.float(), b.float()) * 10.0
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    idx_gap = float((prv - torch.gather(conf, 2, ri[..., None])[..., 0]).abs().max())
    del sim, conf
    lost = int(((torch.gather(pcm, 1, pri) <= prv)
                & ~(torch.gather(cm, 1, ri) <= rv)).sum())
    err = max(max_err(rv, prv), max_err(cm, pcm), idx_gap)
    return err, 1e-6 + 1e-4 * float(prv.abs().max()), int((ri != pri).sum()), lost


ROUTES = {  # how each kernel computes at the main path's shapes, by dtype
    "bf16": {
        "K1_loftr_layer": "cuda, tensor cores (wgmma, cp.async), 3 launches",
        "K2_dual_softmax_rowcol": "cuda, tensor cores (wgmma, cp.async), 4 launches",
        "K3_fine_transformer": "cuda, tensor cores (wgmma, cp.async), 1 launch",
        "K4_bilinear_dual_softmax": "cuda, tensor cores (wgmma, cp.async), 3 launches",
        "backbone_glue": "cuda, CUDA cores, 16-byte vectors, 1 launch a convolution output",
    },
    "f32": {
        "K1_loftr_layer": "cuda, tensor cores 3xTF32 (wgmma GEMMs, cp.async; k^T v and q KV "
                          "on the CUDA cores), 10 launches",
        "K2_dual_softmax_rowcol": "cuda, CUDA cores, 6 launches (on no path: K2 takes bf16)",
        "K3_fine_transformer": "cuda, tensor cores 3xTF32 (wgmma, weight tiles by "
                               "cp.async.bulk; window attention on the CUDA cores), 2 launches",
        "K4_bilinear_dual_softmax": "cuda, tensor cores 3xTF32 (wgmma, cp.async), 3 launches",
        "backbone_glue": "cuda, CUDA cores, 16-byte vectors, 1 launch a convolution output",
    },
}
# the route each kernel must take in float32 at the shapes phase 3 and
# phase 16 (a) hold it at (K1, K3, K4: the 3xTF32 route, read from launches_tf32)
F32_ROUTE = {"K1_loftr_layer": "tensor cores, 3xTF32", "K2_dual_softmax_rowcol": "cuda cores",
             "K3_fine_transformer": "tensor cores, 3xTF32",
             "K4_bilinear_dual_softmax": "tensor cores, 3xTF32", "backbone_glue": "cuda cores"}


def shape_entry(name, dt, shape, wrapper, call, plain, check, flops, nbytes, library=None,
                exps=None):
    """A kernel at one shape against its plain version on the same inputs:
    the route that ran (read from ``wrapper``'s ``launches_tc`` and
    ``launches_tf32``, the CUDA cores for a kernel of one route, ``wrapper``
    None; in float32 it must be ``F32_ROUTE``'s), the error against its
    tolerance (``check(outs)`` -> (error, tolerance, *notes)), CUDA-event
    ms of the kernel, its plain version and the library call (where
    given), and the bound; ``exps``, the exponentials' counts (the
    function's least, the route's own), adds their times on the
    exponential unit. Returns (entry, agrees)."""
    import torch

    before = None if wrapper is None else route_counts(wrapper)
    outs = call()
    torch.cuda.synchronize()
    took = "cuda cores" if wrapper is None else took_route(wrapper, before)
    err, tol, *notes = check(outs)
    ms, plain_ms = cuda_ms(call, 10), cuda_ms(plain, 3)
    lib_ms = None if library is None else cuda_ms(library, 3)
    bounds = dtype_bounds(dt, flops, nbytes)
    tag = "f32" if dt == torch.float32 else "bf16"
    ok = err <= tol and (tag == "bf16" or took == F32_ROUTE[name])
    e = dict(shape=shape, dtype=tag, route=ROUTES[tag][name], took=took, max_abs_err=err,
             tol=tol, ms=ms, plain_ms=plain_ms, **bounds, library_ms=lib_ms)
    if exps:
        e["exp_bound_ms"], e["exp_route_ms"] = (n / exp_rate() * 1e3 for n in exps)
        notes += [f"exp_bound_ms={e['exp_bound_ms']:.4f} exp_route_ms={e['exp_route_ms']:.4f}"]
    if "bound_cuda_core_ms" in bounds:
        notes += [f"bound_cuda_core_ms={bounds['bound_cuda_core_ms']:.4f}"]
    print(f"kernel {name} {tag} {shape}: route {took}, max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) {'ok' if ok else 'FAILED'} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bounds['bound_ms']:.4f} ({bounds['bound_by']}) "
          f"x_bound={ms / bounds['bound_ms']:.1f} library_ms={lib_ms} {' '.join(notes)}",
          flush=True)
    return e, ok


def k4_tol(dt, ref):
    """K4's tolerance. f32: both in f32 on the same inputs, summation
    order only. bf16: the kernel rounds P and H = G / csum to bf16 as the
    TPU kernel does (2^-9 relative each, of random sign, before sums over
    N)."""
    import torch

    return (1e-4 if dt == torch.float32 else 1e-2) * float(ref.abs().max())


def collector():
    """(entries by kernel and dtype, failures, add): ``add(name, ...)``
    runs ``shape_entry`` and files its entry, or its failure."""
    entries, failures = {}, []

    def add(name, *args, **kwargs):
        e, ok = shape_entry(name, *args, **kwargs)
        if not ok:
            failures.append(f"{name} {e['dtype']} {e['shape']}")
        entries.setdefault(name, {})[e["dtype"]] = e

    return entries, failures, add


def coarse_kernels(dev, L: int, seed: int, add) -> None:
    """K1, K2 and K4 at B_KERNEL pairs of L coarse tokens (C 256, 8 heads;
    K4 4 heads of 64, Dv 70) in float32 and bfloat16, each through
    ``add``."""
    import torch

    from far_tpu_torch.ops.bilinear_attention import (
        bilinear_dual_softmax, bilinear_dual_softmax_plain)
    from far_tpu_torch.ops.loftr_layer import (
        loftr_layer, loftr_layer_plain, pack_params)
    from far_tpu_torch.ops.matching_kernel import (
        dual_softmax_rowcol, dual_softmax_rowcol_plain)

    g = torch.Generator().manual_seed(seed)
    B, C = B_KERNEL, C_COARSE

    # ---- K1: one coarse LoFTR layer (cross: x attends to src) ----------
    x32 = torch.randn(B, L, C, generator=g).to(dev)
    s32 = torch.randn(B, L, C, generator=g).to(dev)
    p = layer_params(C, g, dev)
    for dt in (torch.float32, torch.bfloat16):
        x, s = x32.to(dt), s32.to(dt)
        pk = pack_params(p, dt)  # cast once, outside the timed launches
        ref = loftr_layer_plain(x.float(), s.float(), p, H_COARSE)
        # f32: summation order only; bf16: the kernel rounds k, v, KV, q,
        # msg, m, y and out to bf16 (2^-8 relative each), the reference not.
        rel = 1e-4 if dt == torch.float32 else 6e-2
        e = x.element_size()
        add("K1_loftr_layer", dt, f"B={B} L=S={L} C={C} nhead={H_COARSE}", loftr_layer,
            lambda: loftr_layer(x, s, pk, H_COARSE),
            lambda: loftr_layer_plain(x, s, p, H_COARSE),
            lambda o: (max_err(o, ref), rel * float(ref.abs().max())),
            B * (20 * L * C * C + 4 * L * C * (C // H_COARSE) + 2 * L * C),
            3 * B * L * C * e + 10 * C * C * e + 4 * C * 4)

    # ---- K2: dual-softmax row/col reductions ---------------------------
    f0 = torch.randn(B, L, C, generator=g)
    perm = torch.randperm(L, generator=g)
    f1 = f0[:, perm] + 0.5 * torch.randn(B, L, C, generator=g)
    scale = torch.tensor(1.0 / C ** 0.5).to(torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        a = (f0.to(dt) * scale.to(dt)).to(dev).contiguous()
        b = (f1.to(dt) * scale.to(dt)).to(dev).contiguous()

        def library():  # cuBLAS S + softmax + reductions, materialized
            sm = torch.bmm(a, b.transpose(1, 2)).float() * 10.0
            cf = torch.softmax(sm, 1) * torch.softmax(sm, 2)
            return cf.max(2), cf.amax(1)

        def k2_check(outs):
            err, tol, n_diff, lost = k2_errors(a, b, outs)
            return err, tol, f"row_idx_differs={n_diff} mutual_lost={lost}"

        add("K2_dual_softmax_rowcol", dt, f"B={B} L=S={L} C={C}", dual_softmax_rowcol,
            lambda: dual_softmax_rowcol(a, b, 10.0),
            lambda: dual_softmax_rowcol_plain(a, b, 10.0), k2_check, 2 * B * L * L * C,
            2 * B * L * C * a.element_size() + B * L * (4 + 8 + 4), library)

    # ---- K4: dual-softmax bilinear attention ----------------------------
    # exponentials of S's elements on the exponential unit: the function's
    # least (2 per element: E = 2^(s - cmax) feeds the column sums, and P =
    # E^2 2^cmax[m] 2^-alpha[n] needs only per-row and per-column factors
    # beside one row-sum exponential) and the route's own count (3 on both
    # tensor-core routes: 1 statistics pass, 2 main pass). Neither is a
    # hard floor, since an exponential can also run on the FMA units as a
    # polynomial, so neither enters bound_ms.
    Dv = D_EMM + 6
    q32 = torch.randn(B, H_EMM, L, D_EMM, generator=g).to(dev)
    k32 = torch.randn(B, H_EMM, L, D_EMM, generator=g).to(dev)
    v32 = torch.randn(B, H_EMM, L, Dv, generator=g).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
        ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), 0.125)
        add("K4_bilinear_dual_softmax", dt, f"B={B} H={H_EMM} N={L} D={D_EMM} Dv={Dv}",
            bilinear_dual_softmax, lambda: bilinear_dual_softmax(q, k, v, 0.125),
            lambda: bilinear_dual_softmax_plain(q, k, v, 0.125),
            lambda o: (max_err(o, ref), k4_tol(dt, ref)),
            B * H_EMM * (2 * L * L * D_EMM + 2 * L * L * Dv + 2 * L * Dv * Dv),
            B * H_EMM * L * (2 * D_EMM + Dv) * q.element_size() + B * H_EMM * Dv * Dv * 4,
            exps=(2 * B * H_EMM * L * L, 3 * B * H_EMM * L * L))


def check_kernels(dev):
    """Phase 3, K1-K4 at the main path's shapes (``shape_entry``). Returns
    the kernels' JSON entries by name and dtype."""
    import torch

    from far_tpu_torch.ops.fine_layer import (
        fine_transformer, fine_transformer_plain, pack_fine_params)

    entries, failures, add = collector()
    coarse_kernels(dev, L_COARSE, 0, add)
    g = torch.Generator().manual_seed(3)

    # ---- K3: fine transformer over 5x5 windows --------------------------
    n = B_KERNEL * K_MATCH
    w0_32 = torch.randn(n, WW, C_FINE, generator=g).to(dev)
    w1_32 = torch.randn(n, WW, C_FINE, generator=g).to(dev)
    fp = [layer_params(C_FINE, g, dev) for _ in range(2)]
    names = ("self", "cross")
    for dt in (torch.float32, torch.bfloat16):
        a, b = w0_32.to(dt), w1_32.to(dt)
        r0, r1 = fine_transformer_plain(a.float(), b.float(), fp, names, H_FINE)
        pk = pack_fine_params(fp, dt)  # cast once, outside the timed launches
        rel = 1e-4 if dt == torch.float32 else 6e-2
        e = a.element_size()
        add("K3_fine_transformer", dt, f"n={n} windows of {WW} C={C_FINE} nhead={H_FINE}",
            fine_transformer, lambda: fine_transformer(a, b, fp, names, H_FINE, pack=pk),
            lambda: fine_transformer_plain(a, b, fp, names, H_FINE),
            lambda o: (max(max_err(o[0], r0), max_err(o[1], r1)),
                       rel * float(max(r0.abs().max(), r1.abs().max()))),
            4 * n * (20 * WW * C_FINE ** 2 + 4 * WW * C_FINE * (C_FINE // H_FINE)),
            4 * n * WW * C_FINE * e + 2 * 10 * C_FINE ** 2 * e)
    glue_entry(dev, add)
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    return entries


# the backbone glue of one FARConfig() request (ResNet-FPN 8/2, 128/196/256
# channels) at the offline cell's B=16 pairs, 480x640: (entry point,
# channels, the map's stride, with the downsample branch's BatchNorm), in
# the forward's order
GLUE_PAIRS = 16
GLUE_SITES = (("bn_act", 128, 2, False),
              *(2 * (("bn_act", 128, 2, False), ("bn_add_act", 128, 2, False))),
              ("bn_act", 196, 4, False), ("bn_add_act", 196, 4, True),
              ("bn_act", 196, 4, False), ("bn_add_act", 196, 4, False),
              ("bn_act", 256, 8, False), ("bn_add_act", 256, 8, True),
              ("bn_act", 256, 8, False), ("bn_add_act", 256, 8, False),
              ("up2_add", 256, 4, False), ("bn_leaky", 256, 4, False),
              ("up2_add", 196, 2, False), ("bn_leaky", 196, 2, False))


def glue_entry(dev, add) -> None:
    """Phase 3, the backbone's glue (``ops/backbone_glue.py``): the 17 calls
    of one offline request (GLUE_SITES, 2 x 16 images of 480x640,
    channels-last) as one entry, in float32 and bfloat16, against their
    plain versions (the unfused sequence) on the same inputs: bf16 bit for
    bit, float32 within 2 ulp of the largest output (the ``cuda`` tests hold
    each element to 2 ulp of its operands), one launch a call (the entry
    points' counters). Bytes: each input and output once; the bound is the
    bytes at 3.35 TB/s."""
    import torch

    from far_tpu_torch.ops import backbone_glue as glue

    g = torch.Generator().manual_seed(7)
    n_img, (H, W) = 2 * GLUE_PAIRS, (480, 640)

    def bn(C):
        m = torch.nn.BatchNorm2d(C)
        with torch.no_grad():
            m.running_mean.copy_(0.5 * torch.randn(C, generator=g))
            m.running_var.copy_(0.05 + 2 * torch.rand(C, generator=g))
            m.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
            m.bias.copy_(0.3 * torch.randn(C, generator=g))
        return m.to(dev).eval()

    def launches():
        return glue.bn_act.launches, glue.bn_add_act.launches, glue.up2_add.launches

    sites = [kind for kind, *_ in GLUE_SITES]
    want = (sites.count("bn_act") + sites.count("bn_leaky"), sites.count("bn_add_act"),
            sites.count("up2_add"))
    for dt in (torch.float32, torch.bfloat16):
        maps = {}

        def fmap(C, stride, k=0):  # one random map a shape (k: a second one)
            key = (C, stride, k)
            if key not in maps:
                x = torch.randn(n_img, C, H // stride, W // stride, generator=g).to(dev, dt)
                maps[key] = x.contiguous(memory_format=torch.channels_last)
            return maps[key]

        calls, nbytes = [], 0
        for kind, C, stride, ds in GLUE_SITES:
            y, e = fmap(C, stride), 0
            if kind == "up2_add":
                args, fn, plain = (y, fmap(C, 2 * stride)), glue.up2_add, glue.up2_add_plain
                e = y.numel() // 4
            elif kind == "bn_add_act":
                args = (y, bn(C), fmap(C, stride, 1), bn(C) if ds else None)
                fn, plain, e = glue.bn_add_act, glue.bn_add_act_plain, y.numel()
            else:
                args = (y, bn(C), 0.01 if kind == "bn_leaky" else 0.0)
                fn, plain = glue.bn_act, glue.bn_act_plain
            calls.append((fn, plain, args))
            nbytes += (2 * y.numel() + e) * y.element_size()

        before = launches()

        def check(outs):  # after one call of the 17
            got = tuple(n - b for n, b in zip(launches(), before))
            if got != want:
                fail(f"backbone_glue: one call of the {len(calls)} sites launched (bn_act, "
                     f"bn_add_act, up2_add) {got}, expected {want}")
            worst = 0.0
            for out, (_, plain, args) in zip(outs, calls):
                ref = plain(*args)
                d = max_err(out, ref)
                worst = max(worst, d if dt == torch.bfloat16 else
                            d / (2.0 ** -23 * float(ref.abs().max())))
            return worst, 0.0 if dt == torch.bfloat16 else 2.0, \
                "(bf16: max abs error; f32: in ulp of the largest output)"

        with torch.inference_mode():
            add("backbone_glue", dt, f"{len(calls)} calls of a B={GLUE_PAIRS} request at "
                f"{H}x{W} (C 128/196/256, channels-last)", None,
                lambda: [fn(*a) for fn, _, a in calls],
                lambda: [plain(*a) for _, plain, a in calls], check, 0, nbytes)


def fivepoint_flops(n_samples: int, n_rot: int = 2) -> int:
    """Operations of far_fivepoint's fixed schedule (csrc/fivepoint.cu) for
    n_samples samples of n_rot basis rotations, a multiply-add counted 2:
    the epipolar system and five Householder steps on [A^T | Q^T] (a
    step's v, norms and beta ~68, 14 columns of 45); per rotation the
    basis mix (36 x 8), 110 + 100 constraint evaluations (187 each: E 54,
    E E^T 45, det 14, the cubic terms 74), C = q^T V^-T at the z-nodes
    and at the roots (2,100 entries of 20), the row mix (1,100 of 19), 11
    eliminations (635 each), the interpolation (~270), 64 Durand-Kerner
    steps of 10 roots (194 each: Horner 70, the product 100, the division,
    magnitudes and clamp 24), C^T C (1,000 of 20), the ridge (230),
    Gauss-Jordan (10 x 10 x 190), inverse iteration (510 + 4 x 2,320) and
    the candidates (10 x 113)."""
    nullspace = 25 + 5 * (68 + 14 * 45)
    per_rot = (36 * 8 + 210 * 187 + 2100 * 20 + 1100 * 19 + 11 * 635 + 270
               + 64 * 10 * 194 + 1000 * 20 + 230 + 10 * 10 * 190 + 510 + 4 * 2320
               + 10 * 113)
    return n_samples * (nullspace + n_rot * per_rot)


def _fivepoint_problems(B: int, n: int, seed: int, dev, N: int = 1024):
    """B rigid scenes of N exact K-normalised correspondences (a uniform
    rotation, a unit translation, depths 2-6), n samples of 5 of each
    pair's: (B, n, 5, 2) float32 on ``dev`` twice, and each pair's true E
    = [t]x R (B, 3, 3) in numpy."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    p1s, p2s, Es = [], [], []
    for _ in range(B):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        P = rng.uniform(-1, 1, (N, 3))
        P[:, 2] = rng.uniform(2, 6, N)
        P2 = P @ R.T + t
        idx = rng.integers(0, N, (n, 5))
        p1s.append((P[:, :2] / P[:, 2:])[idx])
        p2s.append((P2[:, :2] / P2[:, 2:])[idx])
        Es.append(np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R)
    f = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=dev)
    return f(p1s), f(p2s), np.stack(Es)


def _fivepoint_hits(E, valid, Egt):
    """Per problem: a valid candidate aligned with its pair's true E
    (|cos| > 0.999)."""
    import numpy as np

    E, valid = E.double().cpu().numpy(), valid.cpu().numpy()
    cos = np.abs((E * Egt[:, None, None]).sum((-2, -1))) / (
        np.linalg.norm(E, axis=(-2, -1)) * np.linalg.norm(Egt, axis=(-2, -1))[:, None, None]
        + 1e-12)
    return np.where(valid, cos, 0).max(-1) > 0.999


def fivepoint_entry(dev, card: str) -> dict:
    """Phase 3, the fused 5-point kernel (``ops/fivepoint.py``) at the
    benchmark cells' rounds: B = 1 and 16 pairs, 102 samples (the first
    round) and 51 (the second), N = 1024 exact correspondences a pair. At
    B = 16 and 102 samples it is held to the plain version on the same
    inputs with ``test_fivepoint_kernel_on_card``'s criteria (the truth
    recovered in >= 85 % of problems, the valid masks agreeing on >= 85 %
    of slots; that test holds every shape and the rest). Each shape is
    timed beside the plain version (CUDA-event means of 10 launches; the
    plain version eager, as it would run outside a graph), with its bound:
    ``fivepoint_flops`` at the CUDA cores' 67 TFLOP/s or its bytes (80 in
    and 1,480 out a sample, the tables once), the larger. Returns the JSON
    entry's numbers."""
    import torch

    from far_tpu_torch.geometry.fivepoint import run_5point_essential
    from far_tpu_torch.ops.fivepoint import fivepoint_essential, kernel_tables

    shapes, agree = [], {}
    with torch.inference_mode():
        for B, n in ((1, 102), (1, 51), (16, 102), (16, 51)):
            p1, p2, Egt = _fivepoint_problems(B, n, 100 * B + n, dev)
            if (B, n) == (16, 102):
                (Ek, vk), (Ep, vp) = fivepoint_essential(p1, p2), run_5point_essential(p1, p2)
                agree = dict(recovered=float(_fivepoint_hits(Ek, vk, Egt).mean()),
                             recovered_plain=float(_fivepoint_hits(Ep, vp, Egt).mean()),
                             masks_agree=float((vk == vp).float().mean()), tol=0.85)
                ok = min(agree["recovered"], agree["masks_agree"]) >= 0.85
                print(f"fused 5-point kernel B={B} n_samples={n}: truth recovered in "
                      f"{agree['recovered']:.3f} of problems (plain "
                      f"{agree['recovered_plain']:.3f}), valid masks agree on "
                      f"{agree['masks_agree']:.3f} (tol 0.85): {'ok' if ok else 'FAILED'}",
                      flush=True)
                if not ok:
                    fail(f"the fused 5-point kernel disagrees with its plain version: {agree}")
            ms = cuda_ms(lambda: fivepoint_essential(p1, p2), 10)
            plain_ms = cuda_ms(lambda: run_5point_essential(p1, p2), 10)
            nbytes = B * n * (80 + 1480) + 4 * kernel_tables(2).size
            b_ms, b_by = bound_ms(fivepoint_flops(B * n), nbytes, PEAK_F32)
            print(f"fused 5-point kernel B={B} n_samples={n} (N=1024): ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.3e} ({b_by}) on {card}", flush=True)
            shapes.append(dict(shape=f"B={B} n_samples={n} R=2", ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by))
    return {**agree, "shapes": shapes}


def _polish_inputs(dev, B: int, seed: int):
    """The 8-point polish's 9x9 X^T X and its DLT solution reshaped to 3x3
    (before the rank-2 projection) for B synthetic scenes of 200
    correspondences, 0.5 px noise at f = 518 px, on the card."""
    import numpy as np
    import torch

    from far_tpu_torch.geometry.solvers import normalize_points

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (B, 200, 3))
    t = rng.normal(0, 0.5, (B, 1, 3))
    proj = lambda p: p[..., :2] / p[..., 2:] + rng.normal(0, 0.5 / 518.0, p[..., :2].shape)
    x0 = torch.tensor(proj(pts), dtype=torch.float32, device=dev)
    x1 = torch.tensor(proj(pts + t), dtype=torch.float32, device=dev)
    w = torch.ones(B, 200, device=dev)
    p1n, _ = normalize_points(x0, w)
    p2n, _ = normalize_points(x1, w)
    a1, b1, a2, b2 = p1n[..., 0], p1n[..., 1], p2n[..., 0], p2n[..., 1]
    X = torch.stack([a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, torch.ones_like(a1)], -1)
    XtX = (X * w[..., None]).transpose(-1, -2) @ X
    return XtX, torch.linalg.eigh(XtX)[1][..., :, 0].reshape(B, 3, 3)


def small_linalg_entry(dev, card: str) -> dict:
    """Phase 3, the small-matrix kernels (``ops/small_linalg``) at the
    polish's shapes, one solver round's work at B=4 (an eigh of 9x9 and two
    svd3 of 3x3): held to their plain versions (``torch.linalg.eigh`` and
    ``svd``) on the same inputs, eigenvalues, singular values and the
    svd's rank-2 and essential projections each within 1e-5 of the
    reference's largest (``test_eigh_small_on_card``, ``test_svd3_on_card``
    and ``test_svd3_nearly_rank1_on_card`` hold them at other batches and
    to the eigenvectors), and timed beside them (CUDA-event means of 20
    rounds), with the bound. Returns the JSON entry's numbers."""
    import torch

    from far_tpu_torch.ops.small_linalg import EIGH_SWEEPS, SVD3_SWEEPS, eigh_small, svd3

    B = B_REQUEST
    XtX, F = _polish_inputs(dev, B, seed=1)
    (w, _), (w0, _) = eigh_small(XtX), torch.linalg.eigh(XtX)
    (U, S, Vh), (U0, S0, V0) = svd3(F), torch.linalg.svd(F)
    ess = torch.tensor([1.0, 1.0, 0.0], device=dev)
    pairs = ((w, w0), (S, S0),
             ((U * (S * ess)[:, None, :]) @ Vh, (U0 * (S0 * ess)[:, None, :]) @ V0),
             ((U * ess) @ Vh, (U0 * ess) @ V0))
    err = max(max_err(a, b) / float(b.abs().max()) for a, b in pairs)
    print(f"small_linalg at the polish's shapes (B={B}): eigenvalues, singular values, rank-2 "
          f"and essential projections against torch.linalg, max err / max|ref| {err:.3e} "
          f"(tol 1e-5): {'ok' if err <= 1e-5 else 'FAILED'}", flush=True)
    if err > 1e-5:
        fail(f"small_linalg disagrees with torch.linalg at the polish's shapes: {err:.3e}")

    def kernel_round():
        eigh_small(XtX)
        svd3(F)
        svd3(F)

    def plain_round():
        torch.linalg.eigh(XtX)
        torch.linalg.svd(F)
        torch.linalg.svd(F)

    ms, plain_ms = cuda_ms(kernel_round, 20), cuda_ms(plain_round, 20)

    # bytes in and out once; operations of the kernels' fixed schedules (a
    # Jacobi rotation of an n x n matrix and its V: 12 (n - 1) + 15 flops,
    # n (n - 1) / 2 rotations a sweep; a one-sided rotation of the 3x3's
    # columns and of its V: 65 flops, 3 a sweep; ~200 for U), float32 on
    # the CUDA cores
    def jacobi_flops(n, sweeps):
        return sweeps * n * (n - 1) // 2 * (12 * (n - 1) + 15)

    flops = B * (jacobi_flops(9, EIGH_SWEEPS) + 2 * (SVD3_SWEEPS * 3 * 65 + 200))
    nbytes = 4 * B * ((81 + 9 + 81) + 2 * (9 + 9 + 3 + 9))
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32)
    print(f"small_linalg at the polish's shapes (B={B}: eigh 9x9 + 2 svd3 a round): "
          f"ms={ms:.4f} plain_ms (torch.linalg)={plain_ms:.4f} bound_ms={b_ms:.3e} ({b_by}) "
          f"on {card}", flush=True)
    return dict(max_rel_err=err, tol=1e-5, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def counters():
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax
    from far_tpu_torch.ops.fine_layer import fine_transformer
    from far_tpu_torch.ops.loftr_layer import loftr_layer
    from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol

    return {"K1_loftr_layer": loftr_layer,
            "K2_dual_softmax_rowcol": dual_softmax_rowcol,
            "K3_fine_transformer": fine_transformer,
            "K4_bilinear_dual_softmax": bilinear_dual_softmax}


def reset_counters():
    """Every launch counter of every kernel wrapper (K1-K4 and small_linalg) to 0."""
    from far_tpu_torch.ops import launch_counts

    for fn, name in launch_counts():
        setattr(fn, name, 0)


def fivepoint_launches() -> int:
    """Launches of the fused 5-point kernel (one a 5-point solver round)."""
    from far_tpu_torch.ops.fivepoint import fivepoint_essential

    return fivepoint_essential.launches


def small_linalg_launches() -> int:
    """Launches of the polish's eigensolver and 3x3 SVD kernels."""
    from far_tpu_torch.ops.small_linalg import eigh_small, svd3

    return eigh_small.launches + svd3.launches


def glue_launches() -> tuple:
    """Launches of the backbone's glue: (bn_act, bn_add_act, up2_add)."""
    from far_tpu_torch.ops.backbone_glue import bn_act, bn_add_act, up2_add

    return bn_act.launches, bn_add_act.launches, up2_add.launches


# kernels with a tensor-core route (counted by launches_tc), and the dtypes
# of the requests that go through it (K2 takes bf16 in every request)
TC_ROUTES = {"K1_loftr_layer": ("bfloat16",),
             "K2_dual_softmax_rowcol": ("float32", "bfloat16"),
             "K3_fine_transformer": ("bfloat16",),
             "K4_bilinear_dual_softmax": ("bfloat16",)}
# kernels with a float32 tensor-core route (3xTF32, counted by
# launches_tf32) and the dtypes of the requests that go through it
TF32_ROUTES = {"K1_loftr_layer": ("float32",), "K3_fine_transformer": ("float32",),
               "K4_bilinear_dual_softmax": ("float32",)}


# K1-K4 launches of one FARConfig() request (K1 16: 8 coarse layers, 2 a
# layer; K4 2: the EMM's two cross-attentions)
PER_REQUEST = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 1,
               "K3_fine_transformer": 1, "K4_bilinear_dual_softmax": 2}

# launches of the small-matrix kernels a solver round: the polish's 9x9
# eigensolve and its two 3x3 SVDs (rank-2 and essential projections)
SMALL_LINALG_PER_ROUND = 3

# the backbone's glue launches (bn_act, bn_add_act, up2_add) of one
# request through ResNet-FPN 8/2: bn_act for the stem, each block's first
# half and the two FPN levels, bn_add_act each block's second half, up2_add
# the two FPN levels (far_forward, and mapfree_forward's matcher)
GLUE_PER_REQUEST = (9, 6, 2)

# phase 4's runs: (request, dtype, minimal solver). FARConfig()'s solver
# is 5pt; the map-free request is the cell mapfree_6dreg.reloc_b1's, whose
# rounds draw 8-point hypotheses (mapfree_solver_configs)
MAIN_RUNS = (("far", "float32", "5pt"), ("far", "bfloat16", "5pt"), ("far", "float32", "8pt"),
             ("far", "bfloat16", "8pt"), ("mapfree", "bfloat16", "8pt"))


# ---- launches read from a profiler trace ----------------------------------------
# A compiled request's replays run its kernels without their wrappers, so
# the wrappers' counters see its warm-up (an eager request) and not its
# replays. Where replays run, the launches are read from the device
# kernels of a torch.profiler trace instead. Each route's __global__
# functions (csrc/*.cu; namespace tc::, tf32::, or anon:: for an
# anonymous one) with the launches of each in one wrapper call, the
# route's own first: no other route launches it.
ROUTE_SYMBOLS = {
    ("K1_loftr_layer", "tc"): {"tc::row_pass_kernel": 1, "tc::kv_pass_kernel": 1,
                               "tc::kv_reduce_tc_kernel": 1},
    ("K1_loftr_layer", "tf32"): {"tf32::split_weights_kernel": 1, "tf32::gemm_tf32_kernel": 6,
                                 "anon::kv_partial_kernel": 1, "anon::kv_reduce_kernel": 1,
                                 "anon::msg_kernel": 1},
    ("K1_loftr_layer", "cuda"): {"anon::ln_kernel": 2, "anon::gemm_kernel": 6,
                                 "anon::kv_partial_kernel": 1, "anon::kv_reduce_kernel": 1,
                                 "anon::msg_kernel": 1},
    ("K2_dual_softmax_rowcol", "tc"): {"tc::combine_conf_kernel": 1, "tc::pass_kernel": 2,
                                       "tc::combine_stats_kernel": 1},
    ("K2_dual_softmax_rowcol", "cuda"): {"anon::row_combine_kernel": 1,
                                         "anon::conf_tile_kernel": 1,
                                         "anon::col_combine_kernel": 1},
    ("K3_fine_transformer", "tc"): {"tc::fine_tc_kernel": 1},
    ("K3_fine_transformer", "tf32"): {"tf32::fine_tf32_kernel": 1,
                                      "tf32::prep_weights_kernel": 1},
    ("K3_fine_transformer", "cuda"): {"anon::fine_kernel": 1},
    ("K4_bilinear_dual_softmax", "tc"): {"tc::main_kernel": 1, "tc::row_stats_kernel": 1,
                                         "tc::sum_partials_tc_kernel": 1},
    ("K4_bilinear_dual_softmax", "tf32"): {"tf32::main_tf32_kernel": 1,
                                           "tf32::row_stats_tf32_kernel": 1,
                                           "tc::sum_partials_tc_kernel": 1},
    ("K4_bilinear_dual_softmax", "cuda"): {"anon::bilinear_tile_kernel": 1,
                                           "anon::sum_partials_kernel": 1},
    ("small_linalg", "eigh"): {"anon::eigh_kernel": 1},
    ("small_linalg", "svd3"): {"anon::svd3_kernel": 1},
    ("fivepoint", "cuda"): {"anon::fivepoint_kernel": 1},
    ("backbone_glue", "bn"): {"anon::bn_glue_kernel": 1},
    ("backbone_glue", "up2"): {"anon::up2_add_nhwc_kernel": 1},
}


def kernel_symbol(name: str) -> str:
    """A device kernel's demangled name as ROUTE_SYMBOLS keys it: its
    innermost namespace (anon for an anonymous one) and its name, without
    return type, template arguments or parameters."""
    import re

    head = re.split(r"[<(]", name.replace("(anonymous namespace)", "anon"), maxsplit=1)[0]
    words = head.split()
    return "::".join(words[-1].split("::")[-2:]) if words else name


def traced_launches(call, what: str):
    """call() under a profiler trace (``utils.prof.TraceProfiler``) ->
    (its result, launches by kernel, launches of the bf16 tensor-core
    routes (TC_ROUTES' kernels), of the 3xTF32 routes (TF32_ROUTES'),
    small_linalg launches, fused 5-point kernel launches, the backbone
    glue's (BatchNorm glue, NHWC up2_add) launches): wrapper calls counted
    in the trace's device kernels, eager and replayed alike. Fails
    where a route's functions do not come in the numbers its calls
    launch."""
    import tempfile
    from collections import Counter

    from far_tpu_torch.utils.prof import TraceProfiler

    with tempfile.TemporaryDirectory() as tmp:
        tp = TraceProfiler(tmp)
        with tp.trace():
            out = call()
        events = json.loads(Path(tp.path).read_text())["traceEvents"]
    seen = Counter(kernel_symbol(e["name"]) for e in events
                   if str(e.get("cat", "")).lower() == "kernel")
    calls = {}
    for route, syms in ROUTE_SYMBOLS.items():
        own, per = next(iter(syms.items()))
        calls[route] = seen[own] // per
    expected = Counter()
    for route, syms in ROUTE_SYMBOLS.items():
        for sym, per in syms.items():
            expected[sym] += calls[route] * per
    odd = {sym: (seen[sym], n) for sym, n in expected.items() if seen[sym] != n}
    if odd:
        fail(f"{what}: kernel events {odd} (in the trace, from the routes' calls {calls})")
    got = {k: 0 for k in counters()}
    got_tc = {k: 0 for k in TC_ROUTES}
    got_tf32 = {k: 0 for k in TF32_ROUTES}
    small = five = 0
    for (kernel, route), n in calls.items():
        if kernel == "small_linalg":
            small += n
            continue
        if kernel == "fivepoint":
            five += n
            continue
        if kernel == "backbone_glue":  # read from calls below
            continue
        got[kernel] += n
        if route == "tc":
            got_tc[kernel] += n
        elif route == "tf32":
            got_tf32[kernel] += n
    glue = (calls["backbone_glue", "bn"], calls["backbone_glue", "up2"])
    return out, got, got_tc, got_tf32, small, five, glue


def route_launches(per_req: dict, dtype: str, n: int):
    """What n requests of ``dtype`` launch: (by kernel, on the bf16
    tensor-core routes, on the 3xTF32 routes), per_req a request's."""
    want = {k: v * n for k, v in per_req.items()}
    return (want, {k: want[k] if dtype in TC_ROUTES[k] else 0 for k in TC_ROUTES},
            {k: want[k] if dtype in TF32_ROUTES[k] else 0 for k in TF32_ROUTES})


# which op computes each FarOutput and MapfreeOutput field, for a field a
# replay does not reproduce bit for bit
FIELD_OPS = {"R": "the last MoE fusion (regress_fuse; map-free: blend)",
             "t": "the last MoE fusion", "gating": "the last MoE fusion",
             "regressed_9d": "the last MoE fusion (map-free: round 0's pose MLP)",
             "prior_rt": "denormalize_9d of the last fusion",
             "solver_rt": "the last RANSAC round", "E": "the last RANSAC round's polish",
             "num_inliers": "the last RANSAC round", "success": "the last RANSAC round",
             "num_tight": "the last RANSAC round", "num_ultra_tight": "the last RANSAC round",
             "translation_scale": "the scale head"}


def _out_fields(out, prefix=""):
    import dataclasses

    import torch

    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if dataclasses.is_dataclass(v):
            yield from _out_fields(v, f"{f.name}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


def _field_diffs(a, b) -> dict:
    """{field: max abs difference} of the FarOutput fields where a and b
    are not equal bit for bit."""
    import torch

    return {name: max_err(x, y) for (name, x), (_, y) in zip(_out_fields(a), _out_fields(b))
            if not torch.equal(x, y)}


def _held_to_eager(tag: str, pairs, floor: dict, out, kept) -> None:
    """Fails unless every (what, output, eager reference) of ``pairs``
    agrees bit for bit, a field that differs printed with the op behind it
    (``FIELD_OPS``) and held to the difference of two eager requests
    (``floor``), and unless ``out``'s fields still equal ``kept``, their
    copies taken before the next call."""
    import torch

    bad = []
    for what, got_out, ref in pairs:
        for name, d in _field_diffs(got_out, ref).items():
            ok = d <= floor.get(name, 0.0)
            print(f"{tag}: {what} field {name} differs from the eager request by {d:.3e} "
                  f"({FIELD_OPS.get(name.split('.')[-1], 'the matcher')}); two eager requests "
                  f"differ there by {floor.get(name, 0.0):.3e}: {'held' if ok else 'FAILED'}",
                  flush=True)
            if not ok:
                bad.append(f"{what} {name}")
    aliased = [name for (name, x), y in zip(_out_fields(out), kept) if not torch.equal(x, y)]
    if bad or aliased:
        fail(f"{tag}: differs from the eager request in {bad}; changed by the next call: "
             f"{aliased}")


def _main_run(request: str, dtype: str, solver: str, dev):
    """One of MAIN_RUNS: its tag; its batch B; ``make(seed)``, its modules
    with the weights of that seed; ``inputs(B, seed)``; ``eager(modules,
    inputs, generator)``, the eager request; ``build(*modules)``, the
    compiled one; and one request's launches: by kernel (K1-K4),
    small_linalg, fused 5-point and the backbone's glue."""
    from types import SimpleNamespace

    import torch

    from far_tpu_torch import pipeline as pl
    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models.sixdreg import SixDRegConfig
    from far_tpu_torch.utils.config import FARConfig, SolverOptions

    if request == "far":
        cfg = FARConfig(dtype=dtype) if solver == "5pt" \
            else FARConfig(solver=SolverOptions(minimal_solver=solver), dtype=dtype)
        rounds = cfg.solver.fine_pred_steps
        return SimpleNamespace(
            tag=f"compiled request {dtype} {solver} B={B_REQUEST} 480x640", B=B_REQUEST,
            make=lambda seed: [pl.init_model(cfg, seed=seed, device=dev)],
            inputs=lambda B, seed: (synthetic_batch(B, *cfg.image_size, dev, seed=seed),),
            eager=lambda m, inputs, gen: pl.far_forward(*m, *inputs, generator=gen),
            build=pl.build_inference_fn, per_request=PER_REQUEST,
            small=SMALL_LINALG_PER_ROUND * rounds, five=rounds if solver == "5pt" else 0,
            glue=GLUE_PER_REQUEST)
    cfg = FARConfig(image_size=(720, 544), regress_rt=False, dtype=dtype)
    reg_cfg = SixDRegConfig(dtype=dtype)

    def inputs(B, seed):
        g = torch.Generator().manual_seed(seed)
        regs = [torch.rand(B, *reg_cfg.image_hw, 3, generator=g).to(dev) for _ in range(2)]
        return (synthetic_batch(B, *cfg.image_size, dev, seed=seed), *regs)

    return SimpleNamespace(
        tag=f"compiled map-free request {dtype} B=1 720x544 / 368x272", B=1,
        make=lambda seed: [pl.init_model(cfg, seed=2 * seed, device=dev),
                           pl.init_sixdreg(reg_cfg, seed=2 * seed + 1, device=dev)],
        inputs=inputs, eager=lambda m, inputs, gen: pl.mapfree_forward(*m, *inputs, generator=gen),
        build=pl.build_mapfree_fn, per_request=MAPFREE, small=SMALL_LINALG_PER_ROUND * 2, five=0,
        glue=GLUE_PER_REQUEST)


def compiled_request(dev, card: str) -> None:
    """Phase 4 (the module's docstring) for each of MAIN_RUNS. The eager
    references come first, each from an emptied cache: an f32 graph's pool
    and an eager f32 request do not fit the card together, and cuDNN's
    plans follow the memory left free. A field of the first call or of a
    replay of the run's batch that differs from its eager request is
    printed with the op behind it and held to the difference of two eager
    requests; B=2's graph (its reference taken beside the first graph) and
    both after the in-place ``load_state_dict`` are held bit for bit, with
    no new capture."""
    import torch

    fns = counters()

    def counted():
        return ({k: f.launches for k, f in fns.items()},
                {k: fns[k].launches_tc for k in TC_ROUTES},
                {k: fns[k].launches_tf32 for k in TF32_ROUTES}, small_linalg_launches(),
                fivepoint_launches(), glue_launches())

    gc.collect()
    torch.cuda.empty_cache()
    for request, dtype, solver in MAIN_RUNS:
        run = _main_run(request, dtype, solver, dev)
        tag, B = run.tag, run.B
        modules = run.make(0)
        weights = {"own": [{k: v.clone() for k, v in m.state_dict().items()} for m in modules],
                   "other": [m.state_dict() for m in run.make(1)]}
        batches = {"first": (run.inputs(B, 0), 3), "second": (run.inputs(B, 5), 4),
                   "B=2": (run.inputs(2, 6), 7)}
        gen = torch.Generator(device=dev)

        def eager(what, loaded="own"):
            with torch.no_grad():
                for m, w in zip(modules, weights[loaded]):
                    m.load_state_dict(w)
            inputs, seed = batches[what]
            with torch.inference_mode():
                out = run.eager(modules, inputs, gen.manual_seed(seed))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return out

        def replay(what):
            inputs, seed = batches[what]
            return fn(*inputs, generator=gen.manual_seed(seed))

        other = eager("first", "other")
        ref = {what: eager(what) for what in ("first", "second")}
        floor = _field_diffs(eager("first"), ref["first"])
        fn = run.build(*modules)
        reset_counters()
        first = replay("first")
        torch.cuda.synchronize()
        warm = counted()
        if warm != (*route_launches(run.per_request, dtype, 1), run.small, run.five, run.glue):
            fail(f"{tag}: the first call (eager warm-up, then the capture) counted {warm}, "
                 f"expected one request's {run.per_request}, small_linalg {run.small}, "
                 f"fused 5-point {run.five} and glue (bn_act, bn_add_act, up2_add) {run.glue}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            out1 = replay("first")
            kept = [x.clone() for _, x in _out_fields(out1)]
            out2 = replay("second")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        _, *got = traced_launches(lambda: [replay("first") for _ in range(N_REQUESTS)],
                                  f"{tag} replays")
        want = [*route_launches(run.per_request, dtype, N_REQUESTS), N_REQUESTS * run.small,
                N_REQUESTS * run.five,
                (N_REQUESTS * (run.glue[0] + run.glue[1]), N_REQUESTS * run.glue[2])]
        if got != want or counted() != warm:
            fail(f"{tag}: {N_REQUESTS} replays launched {got} (by kernel, tensor cores, "
                 f"3xTF32, small_linalg, fused 5-point, BatchNorm glue and up2_add) in the "
                 f"trace, expected {want}; "
                 f"counters {counted()} after the replays, {warm} before")
        max_matches = modules[0].config.match.max_matches
        for out in (first, out1, out2):
            for name in ("R", "t", "regressed_9d", "gating", "num_inliers", "E"):
                if not bool(torch.isfinite(getattr(out, name)).all()):
                    fail(f"{tag}: non-finite {name}")
            if tuple(out.R.shape) != (B, 3, 3) or \
                    tuple(out.matches.mkpts1_f.shape) != (B, max_matches, 2):
                fail(f"{tag}: unexpected output shapes")
        _held_to_eager(tag, (("first call (warm-up)", first, ref["first"]),
                             ("replay", out1, ref["first"]),
                             ("second batch", out2, ref["second"])), floor, out1, kept)
        pool1 = fn.pool_bytes()

        def held(what, r, loaded):
            diffs = _field_diffs(replay(what), r)
            if diffs or len(fn.graphs) != 2:
                free = torch.cuda.mem_get_info()[0]
                fail(f"{tag} {what} ({loaded} weights): differs from the eager request in "
                     f"{diffs}, {len(fn.graphs)} graphs ({free / 2**30:.2f} GiB free, graph "
                     f"pool {fn.pool_bytes() / 2**30:.3f} GiB)")

        own2 = eager("B=2")  # beside the first graph
        replay("B=2")  # the capture
        held("B=2", own2, "own")
        held("B=2", eager("B=2", "other"), "other")  # leaves the other weights loaded
        held("first", other, "other")
        print(f"{tag}: the first call and replays equal the eager request bit for bit (floor "
              f"between two eager requests: {floor or 'none'}), no host sync under "
              f"set_sync_debug_mode('error'), two batches unaliased; launches counted in the "
              f"first call's warm-up {warm}, in {N_REQUESTS} replays' profiler trace {got} (by "
              f"kernel, tensor cores, 3xTF32, small_linalg, fused 5-point, glue); B={B} and "
              f"B=2 two graphs in one pool ({pool1 / 2**30:.3f} GiB after B={B}'s capture, "
              f"{fn.pool_bytes() / 2**30:.3f} GiB after B=2's), each equal to the eager request "
              f"bit for bit after an in-place load_state_dict of other weights; valid matches "
              f"{out1.matches.valid.sum(-1).tolist()}, inliers {out1.num_inliers.tolist()} on "
              f"{card}", flush=True)
        del modules, weights, fn, first, out1, out2, ref, own2, other, kept
        torch.cuda.empty_cache()


def small_agreement(dev):
    """Phase 5: the matcher and the EMM features at a small width, all four
    kernels on the card against the plain versions on the CPU, with the
    same weights and images. (The solver is held to ground truth in
    phase 6: on a random-weight model's matches RANSAC chooses among
    degenerate near-ties, where f32 summation order decides.)"""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.pipeline import init_model
    from far_tpu_torch.types import PairBatch
    from far_tpu_torch.utils.config import (
        AttentionStackConfig, BackboneConfig, FARConfig, FineConfig,
        MatchConfig, RegressConfig, SolverOptions)

    cfg = FARConfig(
        image_size=(96, 128),
        backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=AttentionStackConfig(d_model=32, nhead=4),
        match=MatchConfig(max_matches=32, thr=0.0),
        fine=FineConfig(d_model=16, nhead=4),
        regress=RegressConfig(d_model=32, emm_heads=4, hidden=64),
        solver=SolverOptions(num_hypotheses=64, refine_num_hypotheses=64,
                             minimal_solver="8pt"))
    batch = synthetic_batch(2, *cfg.image_size, dev, seed=3)
    cpu_batch = PairBatch(**{k: getattr(batch, k).cpu()
                             for k in ("image0", "image1", "K0", "K1")})
    outs = []
    with torch.inference_mode():
        for device, b in ((dev, batch), ("cpu", cpu_batch)):
            model = init_model(cfg, seed=1, device=device)
            mo = model.match(b)
            outs.append((mo, model.regress_features(mo.feat_c0, mo.feat_c1)))
    (mk, fk), (mp, fp) = outs
    same = (mk.matches.i_ids.cpu() == mp.matches.i_ids) \
        & (mk.matches.j_ids.cpu() == mp.matches.j_ids) \
        & (mk.matches.valid.cpu() == mp.matches.valid)
    both = same & mp.matches.valid
    rel = {name: max_err(a.cpu(), b) / max(float(b.abs().max()), 1e-30)
           for name, a, b in (("feat_c0", mk.feat_c0, mp.feat_c0),
                              ("feat_c1", mk.feat_c1, mp.feat_c1),
                              ("emm_features", fk, fp))}
    expec_err = max_err(mk.matches.expec_f.cpu()[both], mp.matches.expec_f[both]) \
        if bool(both.any()) else 0.0
    print(f"small width, kernels on the card vs plain on the CPU: slots equal "
          f"{float(same.float().mean()):.3f}, valid slots {int(both.sum())}, "
          f"relative errors {rel}, expec_f max abs err {expec_err:.2e}",
          flush=True)
    if float(same.float().mean()) < 0.9:
        fail("kernel path selects other matches than the plain path")
    # f32 on both sides, TF32 off in cuBLAS and cuDNN: summation order, and
    # K4's 3xTF32 route (~1e-6 relative)
    bad = {k: v for k, v in rel.items() if v > 1e-3}
    if bad or expec_err > 5e-2:
        fail(f"kernel path disagrees with the plain path: {bad}, "
             f"expec_f {expec_err}")


def solver_guard(dev, minimal_solver: str):
    """Phase 6: 16 synthetic scenes, 0.5 px noise, the port's first-round
    solver. Returns the median rotation error in degrees."""
    import numpy as np
    import torch

    from far_tpu_torch.pipeline import make_solver_configs
    from far_tpu_torch.solvers.pose_estimation import estimate_pose
    from far_tpu_torch.utils.config import FARConfig, SolverOptions

    cfg = FARConfig(solver=SolverOptions(minimal_solver=minimal_solver))
    B, Npts = 16, 512
    rng = np.random.default_rng(0)
    pts3 = rng.uniform([-2, -2, 3], [2, 2, 8], (B, Npts, 3)).astype(np.float32)
    aa = rng.normal(0, 0.15, (B, 3)).astype(np.float32)
    th = np.linalg.norm(aa, axis=-1, keepdims=True)
    ax = aa / np.maximum(th, 1e-9)
    kx = np.zeros((B, 3, 3), np.float32)
    kx[:, 0, 1], kx[:, 0, 2] = -ax[:, 2], ax[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = ax[:, 2], -ax[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -ax[:, 1], ax[:, 0]
    c, s = np.cos(th)[..., None], np.sin(th)[..., None]
    R_gt = np.eye(3, dtype=np.float32) + s * kx + (1 - c) * (kx @ kx)
    t_gt = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    p1 = np.einsum("bij,bnj->bni", R_gt, pts3) + t_gt[:, None]
    K = np.array([[517.97, 0, 320.0], [0, 517.97, 240.0], [0, 0, 1]], np.float32)

    def proj(p):
        uv = p[..., :2] / p[..., 2:3]
        return uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])

    kp0 = proj(pts3) + rng.normal(0, 0.5, (B, Npts, 2))
    kp1 = proj(p1) + rng.normal(0, 0.5, (B, Npts, 2))
    ok = (pts3[..., 2] > 0.1) & (p1[..., 2] > 0.1)
    first_cfg, _ = make_solver_configs(cfg)
    Kd = torch.from_numpy(K).expand(B, 3, 3).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.inference_mode():
        est = estimate_pose(
            torch.tensor(kp0, dtype=torch.float32, device=dev),
            torch.tensor(kp1, dtype=torch.float32, device=dev), Kd, Kd,
            torch.from_numpy(ok).to(dev), cfg=first_cfg, generator=gen)
    R_est = est.R.double().cpu().numpy()
    cosang = (np.einsum("bij,bij->b", R_est, R_gt.astype(np.float64)) - 1.0) / 2.0
    r_err = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
    med = float(np.median(r_err))
    print(f"solver guard: 16 scenes, 0.5 px noise, {minimal_solver}: median "
          f"rotation error {med:.4f} deg (max {float(r_err.max()):.4f})", flush=True)
    if not med < 1.0:
        fail(f"{minimal_solver} solver median rotation error {med} deg >= 1 deg")
    return med


# deg: the network guard's float32 median on the card with the plain
# 5-point solve (PERF.md section 2). The 3xTF32 routes keep float32
# accuracy, so the median must not move by more than the table's rounding
# (the guard's fine stack, C = 16, keeps K3 on the CUDA cores). The
# backbone's glue kernels round eval BatchNorm as PyTorch's own kernels
# do, where cuDNN's float32 channels-last BatchNorm, which the unfused
# sequence takes, rounds otherwise by an ulp or two: RANSAC then picks
# other hypotheses on a few of the 16 pairs (with the unfused glue the
# median reads 8.5490, bfloat16's is the same either way).
GUARD_F32_MEDIAN_PLAIN_SOLVE = 8.4393
# deg: the same with the fused 5-point kernel, the main path's solve. It
# is another float32 implementation of the solve, so RANSAC picks other
# hypotheses on some of the 16 pairs (the JAX package trained to 8.353
# deg; with the unfused glue the median reads 8.3428); it must not move
# either.
GUARD_F32_MEDIAN = 8.5896


def network_guard(dev) -> dict:
    """Phase 7: the trained tiny checkpoint through far_forward on the
    card, float32 and bfloat16; each median must stay under the JAX
    package's gate max(3 x the trained median, 5 deg) (bench.py), and
    the float32 one within 0.01 deg of GUARD_F32_MEDIAN, and within 0.01
    deg of GUARD_F32_MEDIAN_PLAIN_SOLVE with the plain 5-point solve in
    the fused kernel's place."""
    import torch

    import far_tpu_torch.solvers.ransac as ransac
    from far_tpu_torch.geometry.fivepoint import run_5point_essential
    from far_tpu_torch.tools.guard import gate_deg, guard_eval, load_guard

    def plain_solve(p1, p2, n_basis_rotations, det_tol):
        return run_5point_essential(p1, p2, n_basis_rotations=n_basis_rotations,
                                    det_tol=det_tol)

    out = {}
    for dtype, solve in (("float32", None), ("float32", plain_solve), ("bfloat16", None)):
        model, meta = load_guard(dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        kernel = ransac.fivepoint_essential
        ransac.fivepoint_essential = solve or kernel
        try:
            errs, med = guard_eval(model, seed=meta["eval_seed"], generator=gen)
        finally:
            ransac.fivepoint_essential = kernel
        gate = gate_deg(meta)
        what = f"{dtype}{', plain 5-point solve' if solve else ''}"
        print(f"network guard {what}: median rotation error {med:.4f} deg over "
              f"{len(errs)} pairs (max {float(errs.max()):.4f}; trained "
              f"{meta['eval_rot_err_med_deg']} deg, gate {gate:.2f} deg)", flush=True)
        if not med < gate:
            fail(f"network guard {what}: median {med} deg >= gate {gate} deg")
        want = GUARD_F32_MEDIAN_PLAIN_SOLVE if solve else GUARD_F32_MEDIAN
        if dtype == "float32" and abs(med - want) > 0.01:
            fail(f"network guard {what}: median {med:.4f} deg, not within 0.01 deg of {want}")
        if not solve:
            out[dtype] = med
    return out


# ---- phase 8: training -------------------------------------------------


def train_functions(dev):
    """Phase 8 (a): the differentiable forms of K1, K4 and K3 at the main
    shapes, float32 and bfloat16. Each Function's output equals its
    wrapper's bit for bit; the gradients of every input and weight equal
    autograd through the plain function its backward recomputes (K4 from
    N = 1024: the streaming twin), run on the card, within 1e-5 max|ref|
    per tensor; the launch counters grow by exactly the forward launches.
    In float32 K4's gradients are also held to autograd through the
    full-matrix plain version (summation order: 1e-4 max|ref|)."""
    import torch

    from far_tpu_torch.ops.bilinear_attention import (
        bilinear_dual_softmax, bilinear_dual_softmax_auto, bilinear_dual_softmax_plain,
        bilinear_dual_softmax_streaming, pick_block)
    from far_tpu_torch.ops.fine_layer import (
        fine_transformer, fine_transformer_auto, fine_transformer_plain)
    from far_tpu_torch.ops.loftr_layer import (
        PARAM_KEYS, loftr_layer, loftr_layer_auto, loftr_layer_plain)

    g = torch.Generator().manual_seed(8)
    fns = counters()
    failures = []

    def grads(fn, inputs, cots):
        leaves = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(outs, cots)
        return [o.detach() for o in outs], [x.grad for x in leaves]

    def check(name, dt, fn, wrapper, plain, inputs, launches, tc, extra_plain=None):
        cots = None
        before = {k: (f.launches, *route_counts(f)) for k, f in fns.items()}
        outs_w = wrapper(*inputs)
        outs_w = outs_w if isinstance(outs_w, tuple) else (outs_w,)
        cots = [torch.randn(o.shape, generator=g).to(dev, o.dtype) for o in outs_w]
        outs_f, g_f = grads(fn, inputs, cots)
        torch.cuda.synchronize()
        grew = {k: tuple(a - b for a, b in zip((f.launches, *route_counts(f)), before[k]))
                for k, f in fns.items()}
        want = {k: (0, 0, 0) for k in fns}
        # the wrapper's launch + the Function's, on the dtype's tensor-core route
        tf32 = not tc and launches in TF32_ROUTES
        want[launches] = (2, 2 if tc else 0, 2 if tf32 else 0)
        _, g_p = grads(plain, inputs, cots)
        same = all(torch.equal(a, b) for a, b in zip(outs_f, outs_w))
        err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(g_f, g_p) if b is not None)
        msg = (f"train fn {name} {dt}: output equal to the wrapper's {same}, grads "
               f"max rel err {err:.3e} (tol 1e-5), launches {grew[launches]}")
        ok = same and err <= 1e-5 and grew == want
        if extra_plain is not None:
            _, g_x = grads(extra_plain, inputs, cots)
            err_x = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(g_f, g_x) if b is not None)
            msg += f", vs the full-matrix plain version {err_x:.3e} (tol 1e-4)"
            ok = ok and err_x <= 1e-4
        print(msg + (" ok" if ok else " FAILED"), flush=True)
        if not ok:
            failures.append(f"{name} {dt}: {grew} vs {want}")
        del outs_w, outs_f, g_f, g_p
        torch.cuda.empty_cache()

    B, L, C, H = B_KERNEL, L_COARSE, C_COARSE, H_COARSE
    p = layer_params(C, g, dev)
    x32 = torch.randn(B, L, C, generator=g).to(dev)
    s32 = torch.randn(B, L, C, generator=g).to(dev)
    Dv = D_EMM + 6
    q32, k32 = (torch.randn(B, H_EMM, L, D_EMM, generator=g).to(dev) for _ in range(2))
    v32 = torch.randn(B, H_EMM, L, Dv, generator=g).to(dev)
    n = B * K_MATCH
    fp = [layer_params(C_FINE, g, dev) for _ in range(2)]
    w0, w1 = (torch.randn(n, WW, C_FINE, generator=g).to(dev) for _ in range(2))
    names = ("self", "cross")
    nk = len(PARAM_KEYS)
    block = pick_block(L)
    # a bare wrapper on inputs that require grad, in grad mode, raises
    # before it launches (its output would carry no grad_fn); the *_auto
    # Functions are checked below
    before = {k: f.launches for k, f in fns.items()}
    leaf = lambda x: x.detach().clone().requires_grad_(True)
    bare = {"K1_loftr_layer": lambda: loftr_layer(leaf(x32), s32, p, H),
            "K4_bilinear_dual_softmax": lambda: bilinear_dual_softmax(
                q32, leaf(k32), v32, 0.125),
            "K3_fine_transformer": lambda: fine_transformer(
                w0, w1, [{**fp[0], "wq": leaf(fp[0]["wq"])}, fp[1]], names, H_FINE)}
    for name, call in bare.items():
        try:
            call()
            refused = False
        except RuntimeError as e:
            refused = "_auto" in str(e)
        print(f"train fn {name}: the bare wrapper refuses inputs that require grad "
              f"{refused}", flush=True)
        if not refused:
            failures.append(f"{name}: the bare wrapper ran on inputs that require grad")
    if {k: f.launches for k, f in fns.items()} != before:
        failures.append("a refused bare wrapper launched its kernel")
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        tc = dt == torch.bfloat16
        wts = [p[k] for k in PARAM_KEYS]
        check("K1_loftr_layer", tag,
              lambda x, s, *w: loftr_layer_auto(x, s, dict(zip(PARAM_KEYS, w)), H),
              lambda x, s, *w: loftr_layer(x, s, dict(zip(PARAM_KEYS, w)), H),
              lambda x, s, *w: loftr_layer_plain(x, s, dict(zip(PARAM_KEYS, w)), H),
              [x32.to(dt), s32.to(dt)] + wts, "K1_loftr_layer", tc)
        check("K4_bilinear_dual_softmax", tag,
              lambda a, b, c: bilinear_dual_softmax_auto(a, b, c, 0.125),
              lambda a, b, c: bilinear_dual_softmax(a, b, c, 0.125),
              lambda a, b, c: bilinear_dual_softmax_streaming(a, b, c, 0.125, block),
              [q32.to(dt), k32.to(dt), v32.to(dt)], "K4_bilinear_dual_softmax", tc,
              extra_plain=(lambda a, b, c: bilinear_dual_softmax_plain(a, b, c, 0.125))
              if dt == torch.float32 else None)
        fw = [lp[k] for lp in fp for k in PARAM_KEYS]
        dicts = lambda w: [dict(zip(PARAM_KEYS, w[:nk])), dict(zip(PARAM_KEYS, w[nk:]))]
        check("K3_fine_transformer", tag,
              lambda a, b, *w: fine_transformer_auto(a, b, dicts(w), names, H_FINE),
              lambda a, b, *w: fine_transformer(a, b, dicts(w), names, H_FINE),
              lambda a, b, *w: fine_transformer_plain(a, b, dicts(w), names, H_FINE),
              [w0.to(dt), w1.to(dt)] + fw, "K3_fine_transformer", tc)
    if failures:
        fail(f"training Functions: {failures}")


def _train_cfg(image_size=(480, 640), small=False, dtype="float32"):
    from far_tpu_torch.utils.config import (
        AttentionStackConfig, BackboneConfig, FARConfig, FineConfig, MatchConfig,
        RegressConfig, SolverOptions)

    if not small:
        return FARConfig(dtype=dtype)
    # tests/test_torch_modules.py:small_config's widths
    return FARConfig(
        image_size=image_size,
        backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=AttentionStackConfig(d_model=32, nhead=4),
        match=MatchConfig(max_matches=32, thr=0.0),
        fine=FineConfig(d_model=16, nhead=4),
        regress=RegressConfig(d_model=32, emm_heads=4, hidden=64),
        solver=SolverOptions(num_hypotheses=64, minimal_solver="8pt"), dtype=dtype)


def _fixed_estimate(B, dev):
    """A solver result independent of the matches, for comparing two
    devices' steps (RANSAC on a random model's matches picks among
    near-ties, where summation order decides)."""
    import types

    import torch

    c, s = math.cos(0.2), math.sin(0.2)
    rt = torch.tensor([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.9]]).expand(B, 3, 4)
    fields = dict(rt34=rt.contiguous(), R=rt[..., :3].contiguous(),
                  t=rt[..., 3].contiguous(), num_inliers=torch.full((B,), 17.0),
                  num_tight=torch.full((B,), 3.0), num_ultra_tight=torch.zeros(B),
                  success=torch.ones(B, dtype=torch.bool))
    est = types.SimpleNamespace(**{k: v.to(dev) for k, v in fields.items()})
    return lambda *a, **kw: est


def train_small_agreement(dev):
    """Phase 8 (b): one train step's forward and backward at the small
    widths (96x128, f32, TF32 off), K1 and K4 on the card against the
    plain versions on the CPU, with the same weights, batch and a stubbed
    solver: every loss within 1e-4 relative, every parameter's gradient
    within 1e-3 max|g_cpu| of its tensor, the BatchNorm running statistics
    within 1e-5 relative, and the card's K1 and K4 counters read."""
    import torch

    import far_tpu_torch.train.trainer as trainer_mod
    from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
    from far_tpu_torch.train.trainer import Trainer

    cfg = _train_cfg((96, 128), small=True)
    ds = SyntheticPairDataset(n=2, hw=cfg.image_size, seed=1)
    samples = [ds[i] for i in range(2)]
    fns = counters()
    saved = trainer_mod.estimate_pose
    res = {}
    try:
        for device in (dev, "cpu"):
            trainer_mod.estimate_pose = _fixed_estimate(2, device)
            tr = Trainer(cfg, device=device).init(seed=2)
            batch, _ = collate(samples, device)
            before = {k: f.launches for k, f in fns.items()}
            losses, _ = tr.loss(batch)
            losses.total.backward()
            launched = {k: f.launches - before[k] for k, f in fns.items()}
            sd = tr.model.state_dict()
            res[str(device)] = dict(
                losses={k: float(v.detach()) for k, v in losses.scalars().items()},
                grads={n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
                       if p.grad is not None},
                stats={n: v.cpu() for n, v in sd.items()
                       if n.endswith(("running_mean", "running_var"))},
                launched=launched)
    finally:
        trainer_mod.estimate_pose = saved
    card, cpu = res[str(dev)], res["cpu"]
    loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-30)
                   for k, v in cpu["losses"].items() if v != 0.0)
    grad_err = max(max_err(card["grads"][n], g) / max(float(g.abs().max()), 1e-30)
                   for n, g in cpu["grads"].items() if float(g.abs().max()) > 0)
    stat_err = max(max_err(card["stats"][n], s) / max(float(s.abs().max()), 1e-30)
                   for n, s in cpu["stats"].items())
    same_keys = set(card["grads"]) == set(cpu["grads"])
    print(f"train step small width, card vs CPU: losses {card['losses']}, max rel err "
          f"{loss_err:.3e} (tol 1e-4); grads of {len(cpu['grads'])} tensors, max err "
          f"{grad_err:.3e} of max|g_cpu| (tol 1e-3); BatchNorm statistics {stat_err:.3e} "
          f"(tol 1e-5); card launches {card['launched']}", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-3 and stat_err <= 1e-5 and same_keys):
        fail("the small train step on the card disagrees with the CPU's")
    if card["launched"]["K1_loftr_layer"] != 16 or card["launched"]["K4_bilinear_dual_softmax"] != 2:
        fail(f"small train step: K1/K4 launches {card['launched']}, expected 16 and 2")


TRAIN_STEPS = 10
TRAIN_LR = 5e-5
B_TRAIN = 2


def train_full(dev, card: str):
    """Phase 8 (c): Trainer(FARConfig()).step at 480x640, B=2 synthetic
    pairs with depth, the 5-point solver and fine_pred_steps 2, 10 steps
    on one fixed batch with the same sampler draws in float32 and in
    bfloat16, AdamW at lr 5e-5 with no warm-up and no schedule. Fails unless every metric and gradient is
    finite, the parameters moved, step 10's loss is below step 1's, and
    every step launched K1 16 times, K4 twice, K2 and K3 never (the
    tensor-core routes in bf16, and the 3xTF32 routes in f32: K1 16, K4
    2)."""
    import torch

    from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
    from far_tpu_torch.train.optim import OptimConfig
    from far_tpu_torch.train.trainer import Trainer

    fns = counters()
    for dtype in ("float32", "bfloat16"):
        cfg = _train_cfg(dtype=dtype)
        ds = SyntheticPairDataset(n=B_TRAIN, hw=cfg.image_size, seed=0)
        batch, _ = collate([ds[i] for i in range(B_TRAIN)], dev)
        tr = Trainer(cfg, OptimConfig(lr=TRAIN_LR, warmup_steps=0, scheduler="none"),
                     device=dev).init(seed=0)
        start = [p.detach().clone() for p in tr.model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times = [], []
        for step in range(TRAIN_STEPS):
            reset_counters()
            t0 = time.perf_counter()
            # the same sampler draws every step: the loss moves with the
            # parameters only
            m = tr.step(batch, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
            got = {k: (f.launches, f.launches_tc, getattr(f, "launches_tf32", 0))
                   for k, f in fns.items()}
            tc = int(dtype == "bfloat16")
            want = {"K1_loftr_layer": (16, 16 * tc, 16 * (1 - tc)),
                    "K2_dual_softmax_rowcol": (0, 0, 0), "K3_fine_transformer": (0, 0, 0),
                    "K4_bilinear_dual_softmax": (2, 2 * tc, 2 * (1 - tc))}
            if got != want:
                fail(f"train {dtype} step {step}: launches {got}, expected {want}")
            finite = all(math.isfinite(v) for v in m.values()) and all(
                bool(torch.isfinite(p.grad).all()) for p in tr.model.parameters()
                if p.grad is not None)
            if not finite:
                fail(f"train {dtype} step {step}: non-finite metrics or gradients {m}")
        moved = sum(not torch.equal(a, p.detach()) for a, p in zip(start, tr.model.parameters()))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = statistics.median(times[1:])
        losses = [round(x["loss"], 6) for x in metrics]
        matches = [x["num_matches"] for x in metrics]
        print(f"train {dtype} FARConfig() B={B_TRAIN} 480x640: ms/step median {ms:.2f} "
              f"(steps 2-{TRAIN_STEPS}; first {times[0]:.2f}), peak memory {peak:.3f} GiB, "
              f"loss by step {losses}, loss_c {metrics[-1]['loss_c']:.6f}, num_matches by "
              f"step {matches}, grad_norm {metrics[0]['grad_norm']:.4f} -> "
              f"{metrics[-1]['grad_norm']:.4f}, {moved}/{len(start)} parameter tensors "
              f"moved, lr {TRAIN_LR}, on {card}", flush=True)
        if moved == 0:
            fail(f"train {dtype}: no parameter moved")
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            fail(f"train {dtype}: loss did not fall ({losses[0]} -> {losses[-1]})")
        del tr, start, batch
        torch.cuda.empty_cache()


# ---- phase 9: validation -------------------------------------------------


def validation(dev, card: str, guard_medians: dict):
    """Phase 9. (a) validate_far with the network guard's weights on its
    16 pairs (seed 4242, 16 scenes, rotations up to 12 deg, B=8) in float32
    and bfloat16, the sampler's generator seeded as phase 7's: the table's
    'rot median err' within 0.01 deg of phase 7's median and under the
    gate. (b) FARConfig() in bfloat16, init_model(seed=0), 16 synthetic
    pairs at 480x640 and B=4, through one build_inference_fn that a
    warm-up pass on a batch of its own captured, under a profiler trace:
    dset size 16, every entry of the table finite, K1/K2/K3/K4 launched
    16/1/1/2 times a batch in its device kernels. Returns (a)'s medians by
    dtype."""
    import torch

    from far_tpu_torch.data.synthetic import SyntheticPairDataset
    from far_tpu_torch.pipeline import build_inference_fn, init_model
    from far_tpu_torch.tools.guard import gate_deg, load_guard
    from far_tpu_torch.train.validation import validate_far
    from far_tpu_torch.utils.config import FARConfig

    medians = {}
    for dtype in ("float32", "bfloat16"):
        model, meta = load_guard(dtype=dtype, device=dev)
        ds = SyntheticPairDataset(n=16, hw=model.config.image_size, seed=meta["eval_seed"],
                                  n_scenes=16, max_angle_deg=12.0)
        table = validate_far(model, ds, 8, generator=torch.Generator(device=dev).manual_seed(7))
        med, gate = table["rot median err"], gate_deg(meta)
        medians[dtype] = med
        gap = abs(med - guard_medians[dtype])
        print(f"validation guard {dtype}: {json.dumps(table)}; rot median err {med} against "
              f"phase 7's {guard_medians[dtype]:.4f} (gap {gap:.4f}, tol 0.01), gate "
              f"{gate:.2f} deg", flush=True)
        if not (gap <= 0.01 and med < gate and table["dset size"] == 16):
            fail(f"validation guard {dtype}: table {table} against phase 7's median "
                 f"{guard_medians[dtype]}")

    cfg = FARConfig(dtype="bfloat16")
    model = init_model(cfg, seed=0, device=dev)
    fn = build_inference_fn(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    # warm-up on one batch of its own (the capture, cuDNN plans, the allocator)
    validate_far(model, SyntheticPairDataset(n=B_REQUEST, hw=cfg.image_size, seed=1),
                 B_REQUEST, generator=gen, fn=fn)
    ds = SyntheticPairDataset(n=16, hw=cfg.image_size, seed=0)
    table, got, *_ = traced_launches(
        lambda: validate_far(model, ds, B_REQUEST, generator=gen, fn=fn), "validation")
    n_batches = 16 // B_REQUEST
    want = {"K1_loftr_layer": 16 * n_batches, "K2_dual_softmax_rowcol": n_batches,
            "K3_fine_transformer": n_batches, "K4_bilinear_dual_softmax": 2 * n_batches}
    print(f"validation FARConfig() bfloat16 480x640, 16 pairs at B={B_REQUEST}: "
          f"{json.dumps(table)}; {len(fn.graphs)} CUDA graph replayed, launches from a "
          f"profiler trace {got} on {card}", flush=True)
    if got != want:
        fail(f"validation: launches {got}, expected {want}")
    if table["dset size"] != 16 or not all(math.isfinite(v) for v in table.values()):
        fail(f"validation: table {table}")
    del model, fn
    torch.cuda.empty_cache()
    return medians


# ---- phase 10: Sinkhorn and remat --------------------------------------------


def sinkhorn_requests(dev, card: str):
    """Phase 10 (a): far_forward with match_type='sinkhorn' at B=4,
    480x640, FARConfig() otherwise, in float32 and bfloat16: two timed
    requests after a warm-up, finite outputs; two more under a profiler
    trace, K1/K3/K4 launched 16/1/2 times a request and K2 never."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.pipeline import build_inference_fn, init_model
    from far_tpu_torch.utils.config import FARConfig, MatchConfig

    for dtype in ("float32", "bfloat16"):
        cfg = FARConfig(match=MatchConfig(match_type="sinkhorn"), dtype=dtype)
        model = init_model(cfg, seed=0, device=dev)
        fn = build_inference_fn(model)
        batch = synthetic_batch(B_REQUEST, *cfg.image_size, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        fn(batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        _, got, *_ = traced_launches(lambda: [fn(batch, generator=gen) for _ in range(2)],
                                     f"sinkhorn request {dtype}")
        want = {"K1_loftr_layer": 32, "K2_dual_softmax_rowcol": 0,
                "K3_fine_transformer": 2, "K4_bilinear_dual_softmax": 4}
        finite = all(bool(torch.isfinite(getattr(out, k)).all())
                     for k in ("R", "t", "regressed_9d", "gating", "num_inliers", "E"))
        print(f"sinkhorn request {dtype} B={B_REQUEST} 480x640: ms/request {times} "
              f"(host clock), peak memory {peak / 2 ** 30:.3f} GiB beside the graph pool's "
              f"{fn.pool_bytes() / 2 ** 30:.3f} GiB, launches in 2 more requests (profiler "
              f"trace) {got}, outputs finite {finite}, valid matches "
              f"{out.matches.valid.sum(-1).tolist()} on {card}", flush=True)
        if got != want or not finite:
            fail(f"sinkhorn request {dtype}: launches {got} (expected {want}), finite {finite}")
        del model, fn, out
        torch.cuda.empty_cache()


def _train_batch(dev, n: int):
    from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate

    ds = SyntheticPairDataset(n=n, hw=(480, 640), seed=0)
    return collate([ds[i] for i in range(n)], dev)[0]


def _timed_step(tr, batch, dev):
    """(metrics, ms on the host clock, peak GiB) of one Trainer.step with
    the sampler seeded at 0."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = tr.step(batch, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    return m, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30


def sinkhorn_train(dev, card: str):
    """Phase 10 (b): one Trainer.step with match_type='sinkhorn' at B=2,
    480x640, bfloat16: every loss finite and the dustbin score's gradient
    finite and nonzero."""
    import torch

    from far_tpu_torch.train.trainer import Trainer
    from far_tpu_torch.utils.config import FARConfig, MatchConfig

    cfg = FARConfig(match=MatchConfig(match_type="sinkhorn"), dtype="bfloat16")
    tr = Trainer(cfg, device=dev).init(seed=0)
    m, ms, peak = _timed_step(tr, _train_batch(dev, B_TRAIN), dev)
    g = tr.model.bin_score.grad
    ok = g is not None and bool(torch.isfinite(g)) and float(g) != 0.0 \
        and all(math.isfinite(v) for v in m.values())
    print(f"sinkhorn train step bfloat16 B={B_TRAIN} 480x640: {m}, bin_score grad "
          f"{None if g is None else float(g)}, {ms:.1f} ms (first step, host clock), peak "
          f"memory {peak:.3f} GiB on {card}", flush=True)
    if not ok:
        fail("sinkhorn train step: non-finite losses or no dustbin gradient")
    del tr
    torch.cuda.empty_cache()


def remat_steps(dev, card: str):
    """Phase 10 (c), (d). (c) Two bfloat16 Trainer.steps at B=2, 480x640,
    FARConfig() with remat False, then False again, "full" and
    "selective", each from init_weights(seed=0) with the same batch and
    sampler draws. The second step's gradients, losses and running
    statistics are compared: the no-remat run twice gives their
    run-to-run floor (cuDNN's backward and the fine gather's scatter need
    not be bit-reproducible), and per tensor a remat step must be within
    1e-5 max|g| + 2 x that floor. The second step's time is reported (the
    first allocates AdamW's state), the peak is over both; "full" must
    peak below False. (d) The same at B=8 with remat "full"."""
    import torch

    from far_tpu_torch.train.trainer import Trainer
    from far_tpu_torch.utils.config import FARConfig

    batch = _train_batch(dev, B_TRAIN)
    runs = {}
    for key, remat in (("plain", False), ("plain again", False), ("full", "full"),
                       ("selective", "selective")):
        tr = Trainer(FARConfig(dtype="bfloat16", remat=remat), device=dev).init(seed=0)
        _, _, peak1 = _timed_step(tr, batch, dev)
        m, ms, peak = _timed_step(tr, batch, dev)
        peak = max(peak, peak1)
        runs[key] = dict(
            losses={k: v for k, v in m.items() if k.startswith("loss")}, ms=ms, peak=peak,
            grads={n: p.grad.detach().float() for n, p in tr.model.named_parameters()
                   if p.grad is not None},
            stats={n: v.detach().clone() for n, v in tr.model.state_dict().items()
                   if n.endswith(("running_mean", "running_var"))})
        del tr
        torch.cuda.empty_cache()

    def errs(a, b):
        out = {n: max_err(a["grads"][n], b["grads"][n]) for n in b["grads"]}
        out.update({n: max_err(a["stats"][n], b["stats"][n]) for n in b["stats"]})
        out.update({k: abs(a["losses"][k] - v) for k, v in b["losses"].items()})
        return out

    plain = runs["plain"]
    scale = {n: float(g.abs().max()) for n, g in plain["grads"].items()}
    scale.update({n: float(s.abs().max()) for n, s in plain["stats"].items()})
    scale.update({k: abs(v) for k, v in plain["losses"].items()})
    floor = errs(runs["plain again"], plain)
    failures = []
    for key in ("full", "selective"):
        e = errs(runs[key], plain)
        if e.keys() != floor.keys():
            failures.append(f"{key}: other tensors have gradients")
            continue
        bad = [n for n in e if e[n] > 1e-5 * scale[n] + 2 * floor[n]]
        worst = max(e, key=lambda n: e[n] / max(scale[n], 1e-30))
        print(f"remat {key} bf16 B={B_TRAIN}: losses {runs[key]['losses']}, worst relative "
              f"error {e[worst] / max(scale[worst], 1e-30):.3e} ({worst}; no-remat floor "
              f"{floor[worst] / max(scale[worst], 1e-30):.3e}), {len(bad)} tensors over "
              f"1e-5 max|g| + 2 x floor", flush=True)
        if bad:
            failures.append(f"{key}: {bad[:5]}")
    floor_max = max(floor[n] / max(scale[n], 1e-30) for n in floor)
    print(f"remat bf16 B={B_TRAIN} 480x640: peak memory GiB / ms of step 2 (host "
          f"clock): "
          + ", ".join(f"{k} {r['peak']:.3f} / {r['ms']:.1f}" for k, r in runs.items())
          + f"; no-remat run-to-run max relative difference {floor_max:.3e} on {card}",
          flush=True)
    if not runs["full"]["peak"] < runs["plain"]["peak"]:
        failures.append("remat 'full' does not lower the peak memory")
    if failures:
        fail(f"remat: {failures}")

    tr = Trainer(FARConfig(dtype="bfloat16", remat="full"), device=dev).init(seed=0)
    big = _train_batch(dev, 8)
    _, ms1, peak1 = _timed_step(tr, big, dev)
    m, ms2, peak2 = _timed_step(tr, big, dev)
    print(f"remat full bf16 B=8 480x640: step 2 {ms2:.1f} ms (step 1 {ms1:.1f} ms, host "
          f"clock), peak memory {max(peak1, peak2):.3f} GiB, losses finite "
          f"{all(math.isfinite(v) for v in m.values())} on {card}", flush=True)
    if not all(math.isfinite(v) for v in m.values()):
        fail(f"remat full B=8: non-finite metrics {m}")
    del tr, big
    torch.cuda.empty_cache()


GOLDEN = Path(__file__).resolve().parent / "tests" / "golden"
# the bf16 golden replays against the f32 ones on the card, relative to
# max|f32 output|
BF16_GATE = 1e-1
# launches a request: ViTEss gated by a FARConfig() matcher (K4 twice in
# its CrossBlock), ViTEss alone, map-free (matcher with regress_rt=False)
VITESS_GATED = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 1,
                "K3_fine_transformer": 1, "K4_bilinear_dual_softmax": 2}
VITESS_UNGATED = {"K1_loftr_layer": 0, "K2_dual_softmax_rowcol": 0,
                  "K3_fine_transformer": 0, "K4_bilinear_dual_softmax": 2}
MAPFREE = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 1,
           "K3_fine_transformer": 1, "K4_bilinear_dual_softmax": 0}


def hooked(model, names):
    """{tap: [outputs]} filled by forward hooks on the named modules."""
    got = {}
    mods = dict(model.named_modules())
    for tap, mod in names.items():
        mods[mod].register_forward_hook(
            lambda m, a, o, tap=tap: got.setdefault(tap, []).append(o))
    return got


def orth_err(R) -> float:
    import torch

    eye = torch.eye(3, device=R.device)
    return float((R.float().transpose(-1, -2) @ R.float() - eye).abs().max())


def tap_errors(family: str, taps, ours) -> dict:
    """{tap: (max abs error, the CPU tests' gate)}."""
    import numpy as np

    from far_tpu_torch.utils.parity import tap_tolerance

    out = {}
    for name, tap in sorted(taps.items()):
        ref = np.asarray(tap, np.float32)
        got = ours[name].float().cpu().numpy().reshape(ref.shape)
        out[name] = (float(np.abs(got - ref).max()), tap_tolerance(family, name, ref))
    return out


def close_to(what: str, got: dict, ref: dict, names, bad: list) -> None:
    """Each of ``names`` finite and within BF16_GATE max|ref| of ``ref``."""
    for name in names:
        err = max_err(got[name], ref[name])
        gate = BF16_GATE * float(ref[name].abs().max())
        finite = bool(got[name].float().isfinite().all())
        print(f"{what} {name}: max_abs_err={err:.3e} (gate {gate:.3e}) finite {finite}",
              flush=True)
        if not (finite and err <= gate):
            bad.append(f"{what} {name}")


def golden_replays(family: str, fixture: str, run, outputs, rot: str, staged=None):
    """Phases 11 (a), 12 (a). ``run(meta, inputs, dtype, cudnn,
    encoder_out=None)`` replays the fixture and returns its taps and
    outputs. The f32 replay runs PyTorch's own (GEMM) convolution, cuDNN
    off, and holds every tap to the CPU tests' gate: cuDNN's f32 algorithms
    round differently, and the map-free correlation volume's near-tied
    softmax rows carry that past the f16 taps' gate. The replay with cuDNN
    and its distance from the GEMM one are printed beside it. bf16 (cuDNN
    on, as requests run): finite, ``rot`` orthonormal to 1e-3, ``outputs``
    within BF16_GATE max|f32|. With ``staged`` (the map-free encoder's
    maps) the bf16 replay is held in two stages instead: the maps to the
    f32 replay's, and the outputs to an f32 replay fed the bf16 maps. The
    end-to-end difference is printed, not gated, beside what one bf16
    rounding of the f32 maps alone does to the outputs and the correlation
    logits' largest value and top-2 gap quantiles, which show why."""
    import torch

    from far_tpu_torch.utils.parity import load_fixture

    meta, inputs, _, taps = load_fixture(GOLDEN / fixture)
    f32 = run(meta, inputs, "float32", cudnn=False)
    f32_cudnn = run(meta, inputs, "float32", cudnn=True)
    bf16 = run(meta, inputs, "bfloat16", cudnn=True)
    bad = []
    errs, errs_cudnn = tap_errors(family, taps, f32), tap_errors(family, taps, f32_cudnn)
    for name, (err, tol) in errs.items():
        print(f"golden {family} f32 {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"{'ok' if err <= tol else 'DISAGREES'}; with cuDNN {errs_cudnn[name][0]:.3e}, "
              f"cuDNN vs GEMM {max_err(f32_cudnn[name], f32[name]):.3e}", flush=True)
        if not err <= tol:
            bad.append(name)
    if staged is None:
        close_to(f"golden {family} bf16 vs f32", bf16, f32, outputs, bad)
    else:
        close_to(f"golden {family} bf16 vs f32", bf16, f32, staged, bad)
        fed = run(meta, inputs, "float32", cudnn=False,
                  encoder_out=[t.float() for t in (bf16[n] for n in staged)])
        close_to(f"golden {family} bf16 vs f32 fed the bf16 {'/'.join(staged)}", bf16, fed,
                 outputs, bad)
        rounded = run(meta, inputs, "float32", cudnn=False,
                      encoder_out=[f32[n].bfloat16().float() for n in staged])
        for name in outputs:
            print(f"golden {family} bf16 vs f32 end to end {name}: max_abs_err="
                  f"{max_err(bf16[name], f32[name]):.3e}; f32 fed its own maps rounded "
                  f"to bf16: {max_err(rounded[name], f32[name]):.3e} (not gated)", flush=True)
        f0, f1 = (f32[n].flatten(2).transpose(1, 2).float() for n in staged)
        sim = f0 @ f1.transpose(1, 2)
        top = sim.topk(2, dim=2).values
        q = torch.quantile((top[..., 0] - top[..., 1]).flatten().cpu(),
                           torch.tensor([0.01, 0.1, 0.5]))
        print(f"golden {family} correlation logits: max {float(sim.max()):.1f}, top-2 gap "
              f"quantiles 1/10/50 % {[round(float(v), 3) for v in q]}", flush=True)
    if not orth_err(bf16[rot]) <= 1e-3:
        bad.append(f"bf16 {rot} not orthonormal")
    if bad:
        fail(f"golden {family} replay on the card: {bad}")


def vitess_golden(dev):
    """Phase 11 (a): tests/golden/vitess_seed0.npz (gated ViTEss, 224x224)."""
    import numpy as np
    import torch

    from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
    from far_tpu_torch.utils.convert_weights import load_reference_state_dict
    from far_tpu_torch.utils.parity import synth_state_dict

    def run(meta, inputs, dtype, cudnn, encoder_out=None):
        # reference input (B, 2, 3, H, W) BGR in [0, 255] -> RGB [0, 1] NHWC
        im = inputs["images"][:, :, ::-1].transpose(0, 1, 3, 4, 2) / 255.0
        model = ViTEss(ViTEssConfig(use_loftr_gating=True, dtype=dtype)).eval()
        load_reference_state_dict(model, synth_state_dict(meta["sd_spec"], meta["sd_seed"]))
        model = model.to(dev)
        got = hooked(model, {"resnet": "resnet", "extractor": "extractor_final_conv",
                             "features": "fusion_transformer"})
        torch.backends.cudnn.enabled = cudnn
        try:
            with torch.inference_mode():
                tran, R, p9, _ = model(
                    torch.from_numpy(np.ascontiguousarray(im, np.float32)).to(dev),
                    torch.from_numpy(inputs["solver_pose"]).to(dev),
                    torch.from_numpy(inputs["solver_num_corr"]).to(dev))
        finally:
            torch.backends.cudnn.enabled = True
        return {"resnet": got["resnet"][0], "extractor": got["extractor"][0],
                "features": got["features"][0], "pred_t": tran, "pred_rmtx": R,
                "pred_r6": p9[..., 3:]}

    golden_replays("vitess", "vitess_seed0.npz", run, ("pred_t", "pred_rmtx", "pred_r6"),
                   "pred_rmtx")


def sixdreg_golden(dev):
    """Phase 12 (a): tests/golden/sixdreg_seed0.npz (MapfreeRegression,
    360x270)."""
    import torch

    from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
    from far_tpu_torch.utils.convert_weights import load_reference_state_dict
    from far_tpu_torch.utils.parity import synth_state_dict

    def run(meta, inputs, dtype, cudnn, encoder_out=None):
        img = lambda k: torch.from_numpy(inputs[k].transpose(0, 2, 3, 1).copy()).to(dev)
        model = MapfreeRegression(SixDRegConfig(dtype=dtype)).eval()
        load_reference_state_dict(model, synth_state_dict(meta["sd_spec"], meta["sd_seed"]))
        model = model.to(dev)
        if encoder_out is not None:
            maps = iter(encoder_out)
            model.encoder.forward = lambda x: next(maps)
        got = hooked(model, {"vol": "encoder", "gvol": "aggregator", "feats": "head",
                             "feats_tr": "transformer"})
        torch.backends.cudnn.enabled = cudnn
        try:
            with torch.inference_mode():
                R, tr, p9, _ = model(img("image0_reg"), img("image1_reg"),
                                     torch.from_numpy(inputs["solver_rt"]).to(dev),
                                     torch.from_numpy(inputs["solver_inliers"]).to(dev))
        finally:
            torch.backends.cudnn.enabled = True
        return {"vol0": got["vol"][0], "vol1": got["vol"][1], "gvol": got["gvol"][0],
                "feats": got["feats"][0], "feats_tr": got["feats_tr"][0].transpose(1, 2),
                "pred_r6": p9[..., 3:], "pred_t": tr, "R": R}

    golden_replays("sixdreg", "sixdreg_seed0.npz", run, ("pred_t", "pred_r6"), "R",
                   staged=("vol0", "vol1"))


def timed_requests(name: str, dtype: str, fn, want: dict, check, card: str) -> None:
    """One warm-up request, then N_REQUESTS, each with the launch counters
    set to 0 just before it and read just after; fails unless every
    request launches ``want`` (and the tensor-core routes theirs, per
    TC_ROUTES and TF32_ROUTES)."""
    import torch

    fns = counters()
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(N_REQUESTS):
            reset_counters()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = {k: f.launches for k, f in fns.items()}
            got_tc = {k: fns[k].launches_tc for k in TC_ROUTES}
            got_tf32 = {k: fns[k].launches_tf32 for k in TF32_ROUTES}
            _, want_tc, want_tf32 = route_launches(want, dtype, 1)
            if got != want or got_tc != want_tc or got_tf32 != want_tf32:
                fail(f"{name} {dtype}: launches {got} (tensor cores {got_tc}, 3xTF32 "
                     f"{got_tf32}), expected {want} ({want_tc}, {want_tf32}) a request")
            check(out)
    ms = statistics.median(times)
    print(f"{name} {dtype} B={B_REQUEST}: ms/request median {ms:.2f} (runs "
          f"{[round(t, 2) for t in times]}), pairs/s {B_REQUEST * 1e3 / ms:.2f}, launches "
          f"a request {got}, tensor-core route {got_tc}, 3xTF32 route {got_tf32} on {card}",
          flush=True)


def vitess_requests(dev, card: str):
    """Phase 11 (b): vitess_forward at full width, B=4: ViTEssConfig()
    with use_loftr_gating=True at 224x224 gated by a FARConfig() matcher
    at 480x640, and ViTEssConfig() alone, three requests each in f32 and
    bf16."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models.vitess import ViTEssConfig
    from far_tpu_torch.pipeline import init_model, init_vitess, vitess_forward
    from far_tpu_torch.utils.config import FARConfig

    images = torch.rand(B_REQUEST, 2, 224, 224, 3,
                        generator=torch.Generator().manual_seed(11)).to(dev)
    batch = synthetic_batch(B_REQUEST, 480, 640, dev)

    def check(out):
        tran, R, p9, gate = out
        for v in (tran, R, p9) + (() if gate is None else (gate,)):
            if not bool(v.isfinite().all()):
                fail("vitess_forward: non-finite output")
        if tuple(R.shape) != (B_REQUEST, 3, 3) or orth_err(R) > 1e-3:
            fail(f"vitess_forward: R of shape {tuple(R.shape)}, orthonormal to "
                 f"{orth_err(R):.2e}")

    for dtype in ("float32", "bfloat16"):
        matcher = init_model(FARConfig(dtype=dtype), seed=0, device=dev)
        gated = init_vitess(ViTEssConfig(use_loftr_gating=True, dtype=dtype), seed=1,
                            device=dev)
        ungated = init_vitess(ViTEssConfig(dtype=dtype), seed=1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        timed_requests("vitess_forward gated 224x224 (matcher 480x640)", dtype,
                       lambda: vitess_forward(gated, images, matcher, batch, generator=gen),
                       VITESS_GATED, check, card)
        timed_requests("vitess_forward ungated 224x224", dtype,
                       lambda: vitess_forward(ungated, images), VITESS_UNGATED, check, card)
        del matcher, gated, ungated
        torch.cuda.empty_cache()


def mapfree_requests(dev, card: str):
    """Phase 12 (b): mapfree_forward at full width, B=4: a 720x544
    FARConfig(regress_rt=False) matcher and SixDRegConfig() at 368x272,
    three requests each in f32 and bf16, with the peak memory."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models.sixdreg import SixDRegConfig
    from far_tpu_torch.pipeline import init_model, init_sixdreg, mapfree_forward
    from far_tpu_torch.utils.config import FARConfig

    cfg = SixDRegConfig()
    g = torch.Generator().manual_seed(12)
    im0, im1 = (torch.rand(B_REQUEST, *cfg.image_hw, 3, generator=g).to(dev)
                for _ in range(2))
    batch = synthetic_batch(B_REQUEST, 720, 544, dev)

    def check(out):
        R = out.R
        for v in (R, out.t, out.gating, out.solver_rt, out.num_inliers):
            if not bool(v.isfinite().all()):
                fail("mapfree_forward: non-finite output")
        if tuple(R.shape) != (B_REQUEST, 3, 3) or orth_err(R) > 1e-3:
            fail(f"mapfree_forward: R of shape {tuple(R.shape)}, orthonormal to "
                 f"{orth_err(R):.2e}")

    for dtype in ("float32", "bfloat16"):
        matcher = init_model(FARConfig(image_size=(720, 544), regress_rt=False,
                                       dtype=dtype), seed=0, device=dev)
        reg = init_sixdreg(SixDRegConfig(dtype=dtype), seed=1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        timed_requests("mapfree_forward 368x272 (matcher 720x544)", dtype,
                       lambda: mapfree_forward(matcher, reg, batch, im0, im1, generator=gen),
                       MAPFREE, check, card)
        print(f"mapfree_forward {dtype} B={B_REQUEST}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB on {card}", flush=True)
        del matcher, reg
        torch.cuda.empty_cache()


# ---- phase 13: the families' training ------------------------------------------

FAMILY_STEPS = 10
KC_STEPS = 3              # map-free steps with lam = 0 (Kendall-Cipolla weights)
B_FAMILY = 6              # the interiornet preset's batch; map-free's 24 over 4 cards
VITESS_TRAIN_HW = (384, 512)   # the JAX ViTEss trainer's default image size
# launches a step: ViTEss's CrossBlock runs K4 twice; map-free runs no kernel
VITESS_STEP = {"K1_loftr_layer": 0, "K2_dual_softmax_rowcol": 0,
               "K3_fine_transformer": 0, "K4_bilinear_dual_softmax": 2}
SIXDREG_STEP = {k: 0 for k in VITESS_STEP}
# tests/test_torch_family_train.py's small widths
SMALL_VITESS = dict(dim=48, depth=2, num_heads=3, fc_hidden=64)
SMALL_SIXDREG = dict(image_hw=(64, 64), hidden=64, transformer_heads=2,
                     encoder_blocks=(1, 1, 1), encoder_out_layers=8, transformer_layers=1)
# 13 (c): a float64 step's gradients, card against CPU, relative to
# max|g_cpu|. The float32 step's read up to 4.1e-2 in the ResUNet's stem
# (the card's own float32 runs differ by 2.4e-2 there: a small batch's
# train-mode BatchNorm amplifies rounding ~4e5 times); float64's unit
# roundoff is 2**-29 times float32's, which predicts <= 8e-11
F64_TOL = 1e-9
# 13 (c): the float32 step's gradients past the CNN fronts (whose float32
# gradient the float64 step holds)
F32_TOL = 1e-3
FRONTS = {"vitess": ("resnet.", "extractor_final_conv."), "sixdreg": ("encoder.",)}


def k4_vitess_train(dev, card: str):
    """Phase 13 (a), first: the device ms of K4's forward (the kernel) and
    backward (the plain recompute, below N = 1024) through
    bilinear_dual_softmax_auto at a ViTEss step's (6, 3, 576, 64, 70), in
    float32 and bfloat16. tests/test_torch_hopper.py holds its values at
    this shape (``test_bilinear_auto_at_vitess_train_shape``)."""
    import torch

    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_auto

    B, H, N, D, Dv = VITESS_TRAIN_K4
    g = torch.Generator().manual_seed(13)
    q32, k32 = (torch.randn(B, H, N, D, generator=g).to(dev) for _ in range(2))
    v32 = torch.randn(B, H, N, Dv, generator=g).to(dev)
    cot = torch.randn(B, H, Dv, Dv, generator=g).to(dev)
    scale = D ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        leaves = [x.to(dt).requires_grad_() for x in (q32, k32, v32)]
        fwd = cuda_ms(lambda: bilinear_dual_softmax_auto(*leaves, scale), 10)
        both = cuda_ms(lambda: torch.autograd.grad(
            bilinear_dual_softmax_auto(*leaves, scale), leaves, cot), 10)
        print(f"train fn K4 {tag} {VITESS_TRAIN_K4} (a ViTEss step): forward (kernel) "
              f"{fwd:.4f} ms, backward (plain recompute) {both - fwd:.4f} ms on {card}",
              flush=True)


def _family_steps(name: str, tr, batch, n: int, want: dict, dtype: str, dev,
                  card: str, seeded: bool):
    """``n`` steps of a family trainer on one batch, the launch counters set
    to 0 before each and read after it (``want`` a step; the tensor-core
    routes' per TC_ROUTES); with ``seeded`` the solver gets the same draws
    every step. Fails unless every metric and gradient is finite and each
    step launched ``want``. Returns (metrics, host ms) of each step."""
    import torch

    fns = counters()
    metrics, times = [], []
    for step in range(n):
        reset_counters()
        gen = torch.Generator(device=dev).manual_seed(0) if seeded else None
        t0 = time.perf_counter()
        m = tr.step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        got = {k: (f.launches, f.launches_tc) for k, f in fns.items()}
        exp = {k: (v, v if dtype in TC_ROUTES[k] else 0) for k, v in want.items()}
        if got != exp:
            fail(f"{name} step {step}: launches {got}, expected {exp}")
        finite = all(math.isfinite(v) for v in m.values()) and all(
            bool(torch.isfinite(p.grad).all()) for p in tr.parameters() if p.grad is not None)
        if not finite:
            fail(f"{name} step {step}: non-finite metrics or gradients {m}")
    return metrics, times


def _report_steps(name: str, metrics, times, card: str, extra: str = "") -> None:
    """Print the steps' ms (median of steps 2-n), peak memory and losses;
    fails unless the last loss is below the first."""
    import torch

    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times[1:])
    losses = [round(m["loss"], 6) for m in metrics]
    print(f"{name}: ms/step median {ms:.2f} (steps 2-{len(times)}; first {times[0]:.2f}), "
          f"peak memory {peak:.3f} GiB, loss by step {losses}, grad_norm "
          f"{metrics[0]['grad_norm']:.4f} -> {metrics[-1]['grad_norm']:.4f}{extra} on {card}",
          flush=True)
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"{name}: the loss did not fall ({losses[0]} -> {losses[-1]})")


def family_train(dev, card: str):
    """Phase 13 (a), (b): ViTEssTrainer with the interiornet preset's model
    (ViTEssConfig(use_loftr_gating=True): dim 192, depth 6, 3 heads) on B=6
    SolverPoseDataset pairs at 384x512, and SixDRegTrainer with the mapfree
    preset's SixDRegConfig() on B=6 GTCorrespondenceDataset pairs (512
    matches) at 368x272, the MAGSAC round on the card inside each step; 10
    steps on one batch in float32 and in bfloat16 (map-free: then 3 with
    lam = 0 from the same weights, s_r and s_t moving), each preset's own
    optimizer (interiornet: Adam, OneCycle from 5e-4 / 25, clip 1; mapfree:
    Adam 1e-5, clip 1), the loss falling. Launches a step: ViTEss K4 2
    (the tensor-core route in bf16), K1-K3 0; map-free none. Then
    ViTEss's eval_step, which must leave every parameter and statistic as
    it was."""
    import dataclasses

    import torch

    from far_tpu_torch.configs import PRESETS
    from far_tpu_torch.data.synthetic import (
        GTCorrespondenceDataset, SolverPoseDataset, SyntheticPairDataset)
    from far_tpu_torch.train.family_trainers import (
        SixDRegTrainer, ViTEssTrainer, collate_sixdreg, collate_vitess)

    vit_preset, mf_preset = PRESETS["interiornet"](), PRESETS["mapfree"]()
    vit_model, mf_model = vit_preset.model, mf_preset.model
    ds = SolverPoseDataset(SyntheticPairDataset(n=B_FAMILY, hw=VITESS_TRAIN_HW, seed=0))
    vit_batch = collate_vitess([ds[i] for i in range(B_FAMILY)], dev)
    ds = GTCorrespondenceDataset(SyntheticPairDataset(n=B_FAMILY, hw=mf_model.image_hw,
                                                      seed=0), max_matches=512)
    mf_batch = collate_sixdreg([ds[i] for i in range(B_FAMILY)], dev)
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        tr = ViTEssTrainer(dataclasses.replace(vit_model, dtype=dtype), vit_preset.optim,
                           device=dev).init(seed=0)
        name = (f"train vitess {dtype} (interiornet, gated) B={B_FAMILY} "
                f"{VITESS_TRAIN_HW[0]}x{VITESS_TRAIN_HW[1]}")
        metrics, times = _family_steps(
            name, tr, vit_batch, FAMILY_STEPS, VITESS_STEP, dtype, dev, card, seeded=False)
        _report_steps(name, metrics, times, card)
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        reset_counters()
        ev = tr.eval_step(vit_batch)
        torch.cuda.synchronize()
        kept = all(torch.equal(v, before[k]) for k, v in tr.model.state_dict().items())
        k4 = counters()["K4_bilinear_dual_softmax"].launches
        print(f"eval_step vitess {dtype}: {ev}, parameters and statistics unchanged {kept}, "
              f"K4 launches {k4}", flush=True)
        if not (kept and k4 == VITESS_STEP["K4_bilinear_dual_softmax"]
                and all(math.isfinite(v) for v in ev.values())):
            fail(f"eval_step vitess {dtype}")
        del tr, before
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(mf_model, dtype=dtype)
        tr = SixDRegTrainer(cfg, mf_preset.optim, device=dev).init(seed=0)
        name = (f"train sixdreg {dtype} (mapfree) B={B_FAMILY} "
                f"{cfg.image_hw[0]}x{cfg.image_hw[1]}")
        metrics, times = _family_steps(
            name, tr, mf_batch, FAMILY_STEPS, SIXDREG_STEP, dtype, dev, card, seeded=True)
        inl = [m["solver_inliers"] for m in metrics]
        _report_steps(name, metrics, times, card, f", MAGSAC inliers by step {inl}")
        if not min(inl) > 100:
            fail(f"{name}: the solver kept {inl} inliers of 512 GT matches")
        kc = SixDRegTrainer(cfg, mf_preset.optim, lam=0.0, device=dev)
        kc.model.load_state_dict(tr.model.state_dict())
        kc_metrics, _ = _family_steps(f"{name} lam=0", kc, mf_batch, KC_STEPS,
                                         SIXDREG_STEP, dtype, dev, card, seeded=True)
        s = {k: float(p.detach()) for k, p in kc.extra.items()}
        print(f"{name} lam=0: {KC_STEPS} steps, loss by step "
              f"{[round(m['loss'], 6) for m in kc_metrics]}, s_r / s_t {s}", flush=True)
        if not all(v != 0.0 and math.isfinite(v) for v in s.values()):
            fail(f"{name} lam=0: s_r / s_t did not move: {s}")
        del tr, kc
        torch.cuda.empty_cache()


def family_small_agreement(dev):
    """Phase 13 (c): one step's forward and backward of each trainer at the
    CPU tests' small widths (64x64, B=2, TF32 off) on the card against the
    CPU, the same weights and batch, the map-free solver stubbed to a
    fixed estimate. In float32, as the trainers run (cuDNN on): the
    metrics within 1e-4 relative, the BatchNorm statistics within 1e-5,
    every gradient past the CNN fronts (FRONTS) within F32_TOL max|g_cpu|,
    and on the card ViTEss launches K4 twice, map-free nothing. In
    float64 (``float64_compute``, the models made float64, K4's Function
    swapped for its plain version, which has the float64 route the kernel
    lacks), twice on the card, with cuDNN's convolution and with
    PyTorch's own: every metric, statistic and gradient within F64_TOL
    relative, each model's BIAS_BEFORE_BN (exact gradient 0) against its
    convolution weight's max|g_cpu|."""
    import contextlib

    import torch

    import far_tpu_torch.models.regressor as regressor
    import far_tpu_torch.train.family_trainers as fam
    from far_tpu_torch.data.synthetic import (
        GTCorrespondenceDataset, SolverPoseDataset, SyntheticPairDataset)
    from far_tpu_torch.models.sixdreg import SixDRegConfig
    from far_tpu_torch.models.vitess import ViTEssConfig
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_plain
    from far_tpu_torch.utils.float64 import float64_compute

    pairs = SyntheticPairDataset(n=2, hw=(64, 64), seed=1)
    runs = {
        "vitess": (lambda device: fam.ViTEssTrainer(
            ViTEssConfig(use_loftr_gating=True, dtype="float32", **SMALL_VITESS),
            device=device), fam.collate_vitess, SolverPoseDataset(pairs), VITESS_STEP),
        "sixdreg": (lambda device: fam.SixDRegTrainer(
            SixDRegConfig(dtype="float32", **SMALL_SIXDREG), device=device),
            fam.collate_sixdreg, GTCorrespondenceDataset(pairs, max_matches=128),
            SIXDREG_STEP)}
    saved = fam.estimate_pose, regressor.bilinear_dual_softmax_auto
    fns = counters()

    def one_step(make, collate, ds, device, f64=False, cudnn=True):
        tr = make(device).init(seed=2)
        reset_counters()
        torch.backends.cudnn.enabled = cudnn
        mode = float64_compute() if f64 else contextlib.nullcontext()
        if f64:
            tr.model.double()
        try:
            with mode:
                fam.estimate_pose = _fixed_estimate(2, device)
                loss, metrics = tr.loss(collate([ds[i] for i in range(2)], device))
                loss.backward()
        finally:
            torch.backends.cudnn.enabled = True
        return dict(
            metrics={k: float(v.detach()) for k, v in metrics.items()},
            grads={n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
                   if p.grad is not None},
            stats={n: v.cpu() for n, v in tr.model.state_dict().items()
                   if n.endswith(("running_mean", "running_var"))},
            launched={k: f.launches for k, f in fns.items()},
            biases=type(tr.model).BIAS_BEFORE_BN)

    def rel(a, b, scale=None):
        # in float64: max_err rounds to float32 first
        err = float((a.double() - b.double()).abs().max())
        return err / max(float((b if scale is None else scale).abs().max()), 1e-30)

    def compare(got, ref, names):
        """Largest relative errors of the metrics, the statistics and the
        gradients of ``names`` (each (error, name))."""
        m = max((abs(got["metrics"][k] - v) / max(abs(v), 1e-30), k)
                for k, v in ref["metrics"].items() if v != 0.0)
        st = max((rel(got["stats"][n], v), n) for n, v in ref["stats"].items())
        g = max((rel(got["grads"][n], ref["grads"][n],
                     ref["grads"][n[:-4] + "weight"] if n in ref["biases"] else None), n)
                for n in names)
        return m, st, g

    try:
        for family, (make, collate, ds, want) in runs.items():
            cpu = one_step(make, collate, ds, "cpu")
            card = one_step(make, collate, ds, dev)
            past = [n for n in cpu["grads"] if not n.startswith(FRONTS[family])]
            front = [n for n in cpu["grads"] if n.startswith(FRONTS[family])]
            m, st, g = compare(card, cpu, past)
            g_front = compare(card, cpu, front)[2]
            ok = (m[0] <= 1e-4 and st[0] <= 1e-5 and g[0] <= F32_TOL
                  and set(card["grads"]) == set(cpu["grads"]) and card["launched"] == want)
            print(f"train {family} small width float32, card vs CPU: metrics {card['metrics']}"
                  f", max rel err {m[0]:.3e} (tol 1e-4); BatchNorm statistics {st[0]:.3e} "
                  f"(tol 1e-5); grads of {len(past)} tensors past {FRONTS[family]} within "
                  f"{g[0]:.3e} of max|g_cpu| ({g[1]}; tol {F32_TOL}), of the {len(front)} in "
                  f"them {g_front[0]:.3e} ({g_front[1]}; held in float64 below); card "
                  f"launches {card['launched']}" + (" ok" if ok else " FAILED"), flush=True)
            if not ok:
                fail(f"the small float32 {family} step on the card disagrees with the CPU's")
            # K4 has no float64 route: its plain version (what its backward
            # recomputes) stands in, on both devices
            regressor.bilinear_dual_softmax_auto = bilinear_dual_softmax_plain
            try:
                cpu = one_step(make, collate, ds, "cpu", f64=True)
                for cudnn in (True, False):
                    card = one_step(make, collate, ds, dev, f64=True, cudnn=cudnn)
                    m, st, g = compare(card, cpu, list(cpu["grads"]))
                    dtypes = {v.dtype for v in card["grads"].values()}
                    ok = (max(m[0], st[0], g[0]) <= F64_TOL and dtypes == {torch.float64}
                          and set(card["grads"]) == set(cpu["grads"])
                          and not any(card["launched"].values()))
                    print(f"train {family} small width float64, card (cuDNN "
                          f"{'on' if cudnn else 'off'}) vs CPU: metrics max rel err {m[0]:.3e}, "
                          f"BatchNorm statistics {st[0]:.3e}, grads of {len(cpu['grads'])} "
                          f"tensors {g[0]:.3e} of max|g_cpu| ({g[1]}); tol {F64_TOL}"
                          + (" ok" if ok else " FAILED"), flush=True)
                    if not ok:
                        fail(f"the small float64 {family} step on the card disagrees with "
                             f"the CPU's (cuDNN {cudnn})")
            finally:
                regressor.bilinear_dual_softmax_auto = saved[1]
    finally:
        fam.estimate_pose = saved[0]


# ---- phase 14: the classical map-free baseline ------------------------------------

BASELINE_SCENES = 16
# median rotation error (deg) and median |t - t_gt| gates, tests/test_metric_solvers.py
BASELINE_GATES = {"essential": (1.0, None), "essential_metric": (1.0, 0.15),
                  "pnp": (3.0, 0.15)}


def classical_baseline(dev, card: str):
    """Phase 14: FeatureMatchingModel behind an oracle PrecomputedMatching
    (GTCorrespondenceDataset, 0.5 px noise, a quarter outliers, 512
    matches) on 16 synthetic scenes at 480x640, each solver on the card:
    the median rotation error under 1 deg (essential, essential_metric) and
    3 deg (pnp), the median metric |t - t_gt| under 0.15 (essential_metric,
    pnp)."""
    import tempfile

    import numpy as np
    import torch

    from far_tpu_torch.data.synthetic import GTCorrespondenceDataset, SyntheticPairDataset
    from far_tpu_torch.geometry.rotations import geodesic_distance
    from far_tpu_torch.models.feature_matching import PrecomputedMatching
    from far_tpu_torch.models.sixdreg import FeatureMatchingModel

    ds = GTCorrespondenceDataset(SyntheticPairDataset(n=BASELINE_SCENES, hw=(480, 640), seed=0),
                                 max_matches=512, noise_pix=0.5, outlier_pct=0.25)
    samples = [ds[i] for i in range(BASELINE_SCENES)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "correspondences.npz"
        np.savez(path, **{"-".join(s["pair_names"]):
                          s["correspondences"][s["corr_valid"]].reshape(-1, 4)
                          for s in samples})
        matcher = PrecomputedMatching(path, 512)
        for solver, (rot_gate, t_gate) in BASELINE_GATES.items():
            model = FeatureMatchingModel(matcher, solver, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            rot, terr, times = [], [], []
            for s in samples:
                t0 = time.perf_counter()
                R, t, _ = model.estimate(*s["pair_names"], s["K0"], s["K1"], s["depth0"],
                                         s["depth1"], generator=gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if R.device.type != "cuda":
                    fail(f"baseline {solver}: solved on {R.device}")
                T = torch.from_numpy(s["T_0to1"]).to(dev)
                rot.append(math.degrees(float(geodesic_distance(R, T[:3, :3]))))
                terr.append(float(torch.linalg.norm(t - T[:3, 3])))
            med_r, med_t = statistics.median(rot), statistics.median(terr)
            ok = med_r < rot_gate and (t_gate is None or med_t < t_gate)
            print(f"baseline {solver} on {BASELINE_SCENES} scenes 480x640: median rotation "
                  f"error {med_r:.4f} deg (gate {rot_gate}), median |t - t_gt| {med_t:.4f}"
                  f" (gate {t_gate}), ms per pair median {statistics.median(times):.2f} on "
                  f"{card}" + (" ok" if ok else " FAILED"), flush=True)
            if not ok:
                fail(f"classical baseline {solver}")


# ---- phase 15: the entry points ---------------------------------------------------


def _per_batch(k1: int, k2: int, k3: int, k4: int, n: int = 1) -> dict:
    return dict(zip(counters(), (k1 * n, k2 * n, k3 * n, k4 * n)))


def _cli_call(name: str, fn, argv, want: dict, card: str, tc: bool = False):
    """One CLI's ``main(argv)`` in-process on the card under a profiler
    trace: the launches in its device kernels (eager ones and a compiled
    request's replays alike) must read ``want`` (and the tensor-core routes
    the same where ``tc``). Returns its result."""
    out, got, got_tc, *_ = traced_launches(lambda: fn(argv), f"entry points {name}")
    print(f"entry points {name}: launches (profiler trace) {got}, tensor-core route "
          f"launches {got_tc} on {card}", flush=True)
    if got != want:
        fail(f"entry points {name}: launches {got}, expected {want}")
    if tc and got_tc != {k: want[k] for k in TC_ROUTES}:
        fail(f"entry points {name}: tensor-core route launches {got_tc}, expected {want}")
    return out


def _finite_table(name: str, table: dict, n: int) -> None:
    if table["dset size"] != n or not all(math.isfinite(v) for v in table.values()):
        fail(f"entry points {name}: table {table}")


def _write_mp3d_fixture(root: Path, n: int) -> Path:
    """The Matterport layout: n pairs of 480x640 grayscale PNGs (smooth
    random images) under <root>/imgs/<scene>/, and the json pair list."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(15)
    scene = root / "imgs" / "scene0"
    scene.mkdir(parents=True)
    data = []
    for i in range(n):
        for side in "ab":
            low = rng.uniform(0, 255, (61, 81))
            img = np.kron(low, np.ones((8, 8)))[:480, :640].astype(np.uint8)
            Image.fromarray(img).save(scene / f"{i}{side}.png")
        q = rng.normal(size=4)
        data.append({"0": {"file_name": f"x/imgs/scene0/{i}a.png"},
                     "1": {"file_name": f"x/imgs/scene0/{i}b.png"},
                     "rel_pose": {"position": rng.normal(size=3).tolist(),
                                  "rotation": (q / np.linalg.norm(q)).tolist()}})
    path = root / "pairs.json"
    path.write_text(json.dumps({"data": data}))
    return path


def _write_mapfree_fixture(root: Path, n_query: int) -> None:
    """One map-free val scene: the map frame seq0/frame_00000.jpg and
    ``n_query`` frames seq1/frame_*.jpg as 540x720 JPEGs, intrinsics.txt
    and poses.txt (world-to-cam)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(16)
    scene = root / "val" / "s00000"
    frames = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(n_query)]
    for d in ("seq0", "seq1"):
        (scene / d).mkdir(parents=True)
    intr, poses = ["# frame fx fy cx cy W H"], ["# frame qw qx qy qz tx ty tz"]
    for f in frames:
        low = rng.uniform(0, 255, (91, 69, 3))
        img = np.kron(low, np.ones((8, 8, 1)))[:720, :540].astype(np.uint8)
        Image.fromarray(img).save(scene / f, quality=90)
        intr.append(f"{f} 590.0 590.0 270.0 360.0 540 720")
        q, t = rng.normal(size=4), rng.normal(size=3)
        if f.startswith("seq0"):
            q, t = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
        poses.append(f"{f} " + " ".join(str(v) for v in (*(q / np.linalg.norm(q)), *t)))
    (scene / "intrinsics.txt").write_text("\n".join(intr))
    (scene / "poses.txt").write_text("\n".join(poses))


def entry_points(dev, card: str) -> None:
    """Phase 15: every CLI's main(argv) in-process with --device cuda,
    each call's launches read from a profiler trace of it."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from far_tpu_torch.cli import demo, evaluate, precompute, submission, train
    from far_tpu_torch.eval import mapfree_benchmark
    from far_tpu_torch.pipeline import init_model

    cuda = ["--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) evaluate, FARConfig() in bf16 on 16 synthetic pairs at B=4
        argv = ["--dataset", "synthetic", "--image_size", "480x640", "--dtype", "bfloat16",
                "--batch_size", "4", "--n_synthetic", "16", "--max_batches", "4"] + cuda
        table = _cli_call("evaluate far", evaluate.main, argv + ["--out_dir", str(tmp / "a")],
                          _per_batch(16, 1, 1, 2, 4), card, tc=True)
        _finite_table("evaluate far", table, 16)
        files = sorted(p.name for p in (tmp / "a").iterdir())
        want_files = sorted(["results_prior_ransac.txt", "results_prior_ransac_solverpose.txt",
                             "error_cdf.npy", "pred_R.npy", "pred_t.npy"])
        if files != want_files or np.load(tmp / "a" / "pred_R.npy").shape != (16, 3, 3):
            fail(f"entry points evaluate far: files {files}")

        # (b) evaluate --model vitess, ViTEssConfig() in bf16, 2 batches of 4
        table = _cli_call(
            "evaluate vitess", evaluate.main,
            ["--model", "vitess", "--dataset", "synthetic", "--image_size", "480x640",
             "--dtype", "bfloat16", "--batch_size", "4", "--n_synthetic", "8",
             "--out_dir", str(tmp / "b")] + cuda, _per_batch(0, 0, 0, 2, 2), card)
        # the synthetic pairs rotate at most 20 deg: all in the large-overlap rows
        if np.load(tmp / "b" / "pred_R.npy").shape != (8, 3, 3) or \
                not math.isfinite(table["large overlap, rot mean err"]):
            fail(f"entry points evaluate vitess: table {table}")

        # (c) evaluate on Matterport-layout files: PNG decode, the native
        # resize and the intrinsics guard against the config's basis
        pairs = _write_mp3d_fixture(tmp / "mp3d", 8)
        table = _cli_call(
            "evaluate mp3d", evaluate.main,
            ["--dataset", "mp3d", "--data_json", str(pairs), "--data_dir", str(tmp / "mp3d"),
             "--dtype", "bfloat16", "--batch_size", "4", "--out_dir", str(tmp / "c")] + cuda,
            _per_batch(16, 1, 1, 2, 2), card)
        _finite_table("evaluate mp3d", table, 8)

        # (d) train FAR 3 steps, restore the checkpoint, resume; the presets
        common = ["--dataset", "synthetic", "--image_size", "480x640", "--n_synthetic", "8",
                  "--batch_size", "2", "--sampler", "sequential", "--log_every", "1"] + cuda
        dirs = lambda d: ["--ckpt_dir", str(tmp / d / "ckpt"), "--log_dir", str(tmp / d / "logs")]
        trainer = _cli_call("train far", train.main,
                            common + ["--model", "far", "--dtype", "bfloat16", "--steps", "3"]
                            + dirs("d"), _per_batch(16, 0, 0, 2, 3), card)
        logs = [json.loads(x) for x in (tmp / "d" / "logs" / "train_metrics.jsonl")
                .read_text().splitlines()]
        if len(logs) != 3 or not all(math.isfinite(r["loss"]) for r in logs):
            fail(f"entry points train far: log {logs}")
        args = evaluate.parse_args(["--image_size", "480x640", "--dtype", "bfloat16",
                                    "--ckpt_dir", str(tmp / "d" / "ckpt")] + cuda)
        restored = evaluate._restore_variables(
            args.ckpt_dir, init_model(evaluate.far_config(args), seed=1, device=dev))
        trained = trainer.model.state_dict()
        bad = [k for k, v in restored.state_dict().items() if not torch.equal(v, trained[k])]
        if bad:
            fail(f"entry points: evaluate --ckpt_dir restored {bad[:4]} unlike the trainer's")
        _cli_call("evaluate ckpt", evaluate.main,
                  ["--dataset", "synthetic", "--image_size", "480x640", "--dtype", "bfloat16",
                   "--batch_size", "4", "--n_synthetic", "4", "--ckpt_dir",
                   str(tmp / "d" / "ckpt"), "--out_dir", str(tmp / "d2")] + cuda,
                  _per_batch(16, 1, 1, 2), card)
        again = _cli_call("train resume", train.main,
                          common + ["--dtype", "bfloat16", "--steps", "3", "--resume"]
                          + dirs("d"), _per_batch(0, 0, 0, 0), card)
        if again.step_count != 3:
            fail(f"entry points train --resume: step {again.step_count}")
        for preset, size, k4 in (("interiornet", "480x640", 2), ("mapfree", "368x272", 0)):
            argv = common + ["--preset", preset, "--image_size", size, "--steps", "2"] + \
                dirs(preset)
            _cli_call(f"train {preset}", train.main, argv, _per_batch(0, 0, 0, k4, 2), card)
            logs = [json.loads(x) for x in (tmp / preset / "logs" / "train_metrics.jsonl")
                    .read_text().splitlines()]
            if len(logs) != 2 or not all(math.isfinite(r["loss"]) for r in logs):
                fail(f"entry points train {preset}: log {logs}")

        # (e) precompute with the LoFTR matcher on 4 pairs
        _cli_call(
            "precompute loftr", precompute.main,
            ["--dataset", "synthetic", "--image_size", "480x640", "--n_synthetic", "4",
             "--matcher", "loftr", "--dtype", "bfloat16", "--out", str(tmp / "corr.npz")]
            + cuda, _per_batch(16, 1, 1, 0, 4), card)
        z = np.load(tmp / "corr.npz")
        if len(z.files) != 4 or not all(z[k].ndim == 2 and z[k].shape[1] == 4 and
                                        np.isfinite(z[k]).all() for k in z.files):
            fail(f"entry points precompute: {[z[k].shape for k in z.files]}")

        # (f) the map-free submission over 4 pairs of a fixture scene, scored
        _write_mapfree_fixture(tmp / "mapfree", 16)
        writer = _cli_call(
            "submission", submission.main,
            ["--data_dir", str(tmp / "mapfree"), "--out", str(tmp / "sub.zip"),
             "--max_pairs", "4"] + cuda, _per_batch(16, 1, 1, 0, 4), card)
        lines = writer._scenes["s00000"]
        if len(lines) != 4 or not all(math.isfinite(float(x)) for ln in lines
                                      for x in ln.split()[1:]):
            fail(f"entry points submission: {lines}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mapfree_benchmark.main([str(tmp / "sub.zip"), "--dataset_path",
                                    str(tmp / "mapfree")])
        scores = json.loads(buf.getvalue())
        if scores["Estimates for % of frames"] != 1.0:
            fail(f"entry points: scorer {scores}")
        print(f"entry points mapfree_benchmark: {json.dumps(scores)}", flush=True)

        # (g) the demos at their defaults
        for name, extra, want in (("demo", [], _per_batch(16, 1, 1, 2)),
                                  ("demo mapfree", ["--mapfree"], _per_batch(16, 1, 1, 0))):
            rt = _cli_call(name, demo.main, ["--synthetic"] + extra + cuda, want, card)
            R = rt[:, :3].astype(np.float64)
            if rt.shape != (3, 4) or not np.isfinite(rt).all() or \
                    np.abs(R @ R.T - np.eye(3)).max() > 1e-3:
                fail(f"entry points {name}: [R|t] {rt}")


# ---- phase 16: the FARConfig options and the other matchers ------------------------

L_16_4 = 30 * 40   # coarse tokens of the 16/4 backbone at 480x640
# each option's FARConfig at full width (the 16/4
# coarse map has block_dims[3] = coarse.d_model channels and the fine map
# block_dims[1] = fine.d_model; GroupNorm needs channels divisible by 8)
OPTIONS = ("16_4", "group", "full")


def option_config(option: str, dtype: str):
    from far_tpu_torch.utils.config import (
        AttentionStackConfig, BackboneConfig, FARConfig, FineConfig)

    if option == "16_4":
        return FARConfig(backbone=BackboneConfig(resolution=(16, 4),
                                                 block_dims=(128, 128, 256, 256)), dtype=dtype)
    if option == "group":
        return FARConfig(backbone=BackboneConfig(norm="group", block_dims=(128, 192, 256)),
                         dtype=dtype)
    return FARConfig(coarse=AttentionStackConfig(attention="full"),
                     fine=FineConfig(attention="full"), dtype=dtype)


def kernels_16_4(dev) -> None:
    """16 (a), first part: K1, K2 and K4 at the 16/4 shapes (B=2, L = S =
    N = 1200, not a multiple of 64 or 128), each against its plain version
    with phase 3's tolerances, in f32 and bf16. K3's 16/4 windows are
    phase 3's shape (K x B windows of 5x5 at C=128)."""
    _, failures, add = collector()
    coarse_kernels(dev, L_16_4, 16, add)
    if failures:
        fail(f"kernels at the 16/4 shapes disagree with their plain versions: {failures}")


def option_requests(dev, card: str) -> None:
    """16 (a)-(c): far_forward under each option at 480x640, full width,
    B=4, three timed requests in f32 and three in bf16 after a warm-up,
    then three more under a profiler trace, whose device kernels give
    K1/K2/K3/K4 16/1/1/2 a request for 16/4 and GroupNorm, 0/1/0/2 for
    full attention, the tensor-core routes the same in bf16 (K2's in f32
    too). Finite outputs of the expected shapes; ms/request (median) of
    the compiled request, the peak memory of its replays and its graph
    pool (which holds the request's intermediates)."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.pipeline import build_inference_fn, init_model

    for option in OPTIONS:
        for dtype in ("float32", "bfloat16"):
            cfg = option_config(option, dtype)
            full = option == "full"
            per_req = {"K1_loftr_layer": 0 if full else 2 * len(cfg.coarse.layer_names),
                       "K2_dual_softmax_rowcol": 1,
                       "K3_fine_transformer": 0 if full else 1,
                       "K4_bilinear_dual_softmax": 2}
            model = init_model(cfg, seed=0, device=dev)
            fn = build_inference_fn(model)
            batch = synthetic_batch(B_REQUEST, *cfg.image_size, dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            fn(batch, generator=gen)  # warm-up and capture of the compiled request
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, outs = [], []
            for _ in range(N_REQUESTS):
                t0 = time.perf_counter()
                outs.append(fn(batch, generator=gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            traced, got, got_tc, got_tf32, *_ = traced_launches(
                lambda: [fn(batch, generator=gen) for _ in range(N_REQUESTS)],
                f"option {option} {dtype}")
            outs += traced
            want, want_tc, want_tf32 = route_launches(per_req, dtype, N_REQUESTS)
            if got != want or got_tc != want_tc or got_tf32 != want_tf32:
                fail(f"option {option} {dtype}: launches {got}, tensor-core routes {got_tc}, "
                     f"3xTF32 {got_tf32}; expected {want}, {want_tc}, {want_tf32}")
            for out in outs:
                for name in ("R", "t", "regressed_9d", "gating", "E"):
                    if not bool(torch.isfinite(getattr(out, name)).all()):
                        fail(f"option {option} {dtype}: non-finite {name}")
                if tuple(out.R.shape) != (B_REQUEST, 3, 3):
                    fail(f"option {option} {dtype}: R of shape {tuple(out.R.shape)}")
            ms = statistics.median(times)
            print(f"option {option} far_forward {dtype} B={B_REQUEST} 480x640 (coarse "
                  f"{cfg.coarse_hw[0]}x{cfg.coarse_hw[1]}): ms/request median {ms:.2f} (runs "
                  f"{[round(t, 2) for t in times]}), pairs/s {B_REQUEST * 1e3 / ms:.2f}, "
                  f"peak {peak:.3f} GiB beside the graph pool's {fn.pool_bytes() / 2 ** 30:.3f} "
                  f"GiB, launches of {N_REQUESTS} more (profiler trace) {got}, tensor-core "
                  f"route launches {got_tc}, 3xTF32 {got_tf32}, valid matches {outs[-1].matches.valid.sum(-1).tolist()} on {card}",
                  flush=True)
            del model, fn, outs
            torch.cuda.empty_cache()


def groupnorm_card_vs_cpu(dev) -> None:
    """16 (b): GroupNorm on a bf16 map of the backbone's 1/2 level at
    480x640 (B=8, 128 channels), the card against the CPU. Both take
    float32 statistics, summed in other orders, so the float32 results
    before the one rounding differ by ~1e-7 max|ref|: at most 1 in 1000
    outputs may differ, each by at most one bf16 rounding of its value
    plus 1e-5 max|ref| (near 0, where the rounding step is small)."""
    import torch

    from far_tpu_torch.models.backbone import gn

    g = torch.Generator().manual_seed(161)
    x = (torch.randn(8, 128, 240, 320, generator=g) * 2 + 0.5).to(torch.bfloat16)
    m = torch.nn.GroupNorm(8, 128, eps=1e-6)
    with torch.no_grad():
        m.weight.copy_(1 + 0.2 * torch.randn(128, generator=g))
        m.bias.copy_(0.2 * torch.randn(128, generator=g))
        ref = gn(x, m).float()
        out = gn(x.to(dev), m.to(dev)).float().cpu()
    differ = out != ref
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    over = ((out - ref).abs() - ulp - 1e-5 * float(ref.abs().max())).max()
    share = float(differ.float().mean())
    print(f"GroupNorm bf16 (8, 128, 240, 320), card vs CPU: {share:.2e} of the outputs "
          f"differ (tol 1e-3), max abs err {max_err(out, ref):.3e}, the largest beyond one "
          f"rounding + 1e-5 max|ref|: {float(over):.3e} (tol 0)", flush=True)
    if share > 1e-3 or float(over) > 0:
        fail(f"GroupNorm bf16 card vs CPU: {share:.2e} differ, {float(over):.3e} over")


def _same_topk(name, idx_a, sc_a, idx_b, sc_b, tol):
    """Two top-k results (indices, scores sorted descending) agree: the
    scores slot by slot within ``tol``, and the indices equal but where
    the slot's score ties another slot's within ``tol``. Returns the
    number of slots whose indices differ."""
    import torch

    if float((sc_a - sc_b).abs().max()) > tol:
        fail(f"{name}: top-k scores differ by {float((sc_a - sc_b).abs().max()):.3e} > {tol:.3e}")
    differ = (idx_a != idx_b).nonzero().tolist()
    for b, k in differ:
        gaps = (sc_b[b] - sc_b[b, k]).abs()
        gaps[k] = float("inf")
        if float(gaps.min()) > tol:
            fail(f"{name}: slot {k} of image {b} holds {int(idx_a[b, k])} against "
                 f"{int(idx_b[b, k])} and its score ties no other slot")
    return len(differ)


def superglue_requests(dev, card: str) -> None:
    """16 (d): SuperPoint (channels 64, 64, 128, 128, 1024 keypoints) and
    SuperGlue (256-d, 9 layers, 4 heads, 20 Sinkhorn iterations) at their
    default configs on 480x640 pairs, B=4, f32, seeded random weights:
    ms a pair (median of 3, host clock). The first pair on the card
    against the CPU, the same weights: keypoints equal but where scores
    tie, scores and descriptors within 1e-4 max|ref|; SuperGlue on the
    CPU's keypoints: the assignment within 1e-4 max|ref|, matches0 equal
    but where the CPU's assignment has a near-tie (its two largest entries
    in the row, or in the matched column, within 1e-4 max|P|). With one
    final projection for both images (magicleap's weights share it) and
    threshold 0, an identical-image pair matches at least 10 % of its
    valid keypoints to themselves: random weights do not match them all
    (281 of 929 at 240x320 on the CPU), a layout fault matches next to
    none (chance 1 in 1024)."""
    import copy
    import dataclasses

    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models.superglue import (
        SuperGlue, SuperGlueConfig, match_pair_superglue, select_matches)
    from far_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
    from far_tpu_torch.utils.convert_weights import init_weights

    sp_c = init_weights(SuperPoint(SuperPointConfig()), seed=0).eval()
    sg_c = init_weights(SuperGlue(SuperGlueConfig()), seed=1).eval()
    sp_d, sg_d = copy.deepcopy(sp_c).to(dev), copy.deepcopy(sg_c).to(dev)
    batch = synthetic_batch(B_REQUEST, 480, 640, "cpu")
    im0, im1 = batch.image0.to(dev), batch.image1.to(dev)
    with torch.inference_mode():
        match_pair_superglue(sp_d, sg_d, im0, im1)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        times = []
        for _ in range(N_REQUESTS):
            t0 = time.perf_counter()
            pts0, pts1, ok = match_pair_superglue(sp_d, sg_d, im0, im1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if any(f.launches for f in counters().values()):
            fail("SuperPoint + SuperGlue launched a FAR kernel")
        ms = statistics.median(times)
        print(f"SuperPoint + SuperGlue f32 B={B_REQUEST} 480x640: {ms / B_REQUEST:.2f} ms a "
              f"pair (median request {ms:.2f} ms, runs {[round(t, 2) for t in times]}), "
              f"matches {ok.sum(-1).tolist()} on {card}", flush=True)
        if not bool(torch.isfinite(pts1).all()):
            fail("SuperGlue: non-finite points")

        # the first pair, card against CPU
        kc = [t.cpu() for t in sp_d(im0[:1])] + [t.cpu() for t in sp_d(im1[:1])]
        kr = list(sp_c(batch.image0[:1])) + list(sp_c(batch.image1[:1]))
        tol = lambda r: 1e-4 * float(r.abs().max())
        n_swap = 0
        for o in (0, 4):
            idx = lambda k: (k[..., 1] * 640 + k[..., 0]).long()
            n_swap += _same_topk("SuperPoint", idx(kc[o]), kc[o + 1], idx(kr[o]), kr[o + 1],
                                 tol(kr[o + 1]))
            if not torch.equal(kc[o + 2], kr[o + 2]):
                fail("SuperPoint: valid differs")
            same = (kc[o] == kr[o]).all(-1)
            err = max_err(kc[o + 3][same], kr[o + 3][same])
            if err > tol(kr[o + 3]):
                fail(f"SuperPoint descriptors: card vs CPU {err:.3e}")
        args = [t.to(dev) for t in kr[:4]] + [t.to(dev) for t in kr[4:]]
        P_card = sg_d.assignment(*args, image_hw=(480, 640)).cpu()
        P_cpu = sg_c.assignment(*kr[:4], *kr[4:], image_hw=(480, 640))
        err_p = max_err(P_card, P_cpu)
        if err_p > tol(P_cpu):
            fail(f"SuperGlue assignment: card vs CPU {err_p:.3e}")
        m_card, _ = select_matches(P_card, kr[2], sg_c.cfg.match_threshold)
        m_cpu, _ = select_matches(P_cpu, kr[2], sg_c.cfg.match_threshold)
        near = 1e-4 * float(P_cpu.max())
        top2 = P_cpu[0].topk(2, dim=1).values
        col_top2 = P_cpu[0].topk(2, dim=0).values
        for n in (m_card[0] != m_cpu[0]).nonzero()[:, 0].tolist():
            j = int(max(m_card[0, n], m_cpu[0, n]))
            if float(top2[n, 0] - top2[n, 1]) > near and float(col_top2[0, j] - col_top2[1, j]) > near:
                fail(f"SuperGlue: match {n} differs (card {int(m_card[0, n])}, CPU "
                     f"{int(m_cpu[0, n])}) without a near-tie")
        n_diff = int((m_card != m_cpu).sum())
        print(f"SuperPoint + SuperGlue card vs CPU (pair 0): keypoint slots swapped at score "
              f"ties {n_swap}, assignment max_abs_err {err_p:.3e} (tol {tol(P_cpu):.3e}), "
              f"matches0 differing {n_diff} (near-ties only), valid keypoints "
              f"{int(kr[2].sum())}/{int(kr[6].sum())}", flush=True)

        # an identical pair, one final projection, threshold 0
        sg_d.final_proj2.load_state_dict(sg_d.final_proj.state_dict())
        sg_d.cfg = dataclasses.replace(sg_d.cfg, match_threshold=0.0)
        k, s, v, d = sp_d(im0)
        m0, _ = sg_d(k, s, v, d, k, s, v, d, image_hw=(480, 640))
        self_matched = (m0 == torch.arange(m0.shape[1], device=dev)[None]) & v
        share = float(self_matched.sum() / v.sum())
        print(f"SuperGlue identical pairs, threshold 0: {share:.4f} of the valid keypoints "
              f"matched to themselves (gate 0.1; chance 1/1024)", flush=True)
        if share < 0.1:
            fail(f"SuperGlue identical pairs: only {share:.4f} matched to themselves")


def simple_transformer_request(dev, card: str) -> None:
    """16 (e): SimpleTransformer at its default config (256 wide, 8
    heads, 6 layers) on the 1024 match slots of a FARConfig() matcher
    (threshold 0) and its first-round solver pose, B=4, f32: ms (median of 3, host clock), and
    the card against the CPU on the same inputs and weights within 1e-4
    max|ref|."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models.simple_transformer import (
        SimpleTransformer, SimpleTransformerConfig)
    from far_tpu_torch.pipeline import init_model, make_solver_configs
    from far_tpu_torch.solvers.pose_estimation import estimate_pose
    from far_tpu_torch.utils.config import FARConfig, MatchConfig
    from far_tpu_torch.utils.convert_weights import init_weights

    # the confidence threshold at 0: the random model's matches all fall
    # under FARConfig()'s 0.2 (phase 4 keeps none)
    model = init_model(FARConfig(match=MatchConfig(thr=0.0)), seed=0, device=dev)
    batch = synthetic_batch(B_REQUEST, 480, 640, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        m = model.match(batch).matches
        est = estimate_pose(m.mkpts0_f, m.mkpts1_f, batch.K0, batch.K1, m.valid,
                            cfg=make_solver_configs(model.config)[0], generator=gen)
    del model
    inputs = (torch.stack([m.mkpts0_f, m.mkpts1_f], 2).float(), m.valid, est.rt34.float(),
              est.num_inliers.float())
    st = init_weights(SimpleTransformer(SimpleTransformerConfig()), seed=2).eval()
    with torch.inference_mode():
        ref = st(*[t.cpu() for t in inputs])
        st_d = st.to(dev)
        st_d(*inputs)
        times = []
        for _ in range(N_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = st_d(*inputs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    errs = [(max_err(o.cpu(), r), 1e-4 * float(r.abs().max())) for o, r in zip(out, ref)]
    print(f"SimpleTransformer f32 B={B_REQUEST} K={inputs[0].shape[1]}: "
          f"{statistics.median(times):.3f} ms a request (runs {[round(t, 3) for t in times]}), "
          f"valid {m.valid.sum(-1).tolist()}, card vs CPU pose {errs[0][0]:.3e} (tol "
          f"{errs[0][1]:.3e}), gate {errs[1][0]:.3e} (tol {errs[1][1]:.3e}) on {card}",
          flush=True)
    if any(e > t for e, t in errs):
        fail(f"SimpleTransformer card vs CPU: {errs}")


def matcher_clis(dev, card: str) -> None:
    """16 (f): ``precompute --matcher superglue`` (on the card) and
    ``--matcher sift`` (OpenCV on the host) on 4 synthetic pairs at
    480x640: four finite (n, 4) entries each, K1-K4 launched 0 times."""
    import tempfile

    import numpy as np

    from far_tpu_torch.cli import precompute

    with tempfile.TemporaryDirectory() as tmp:
        for matcher in ("superglue", "sift"):
            out = Path(tmp) / f"{matcher}.npz"
            _cli_call(f"precompute {matcher}", precompute.main,
                      ["--dataset", "synthetic", "--image_size", "480x640", "--n_synthetic",
                       "4", "--matcher", matcher, "--out", str(out), "--device", "cuda"],
                      _per_batch(0, 0, 0, 0), card)
            z = np.load(out)
            if len(z.files) != 4 or not all(z[k].ndim == 2 and z[k].shape[1] == 4 and
                                            np.isfinite(z[k]).all() for k in z.files):
                fail(f"precompute {matcher}: {[z[k].shape for k in z.files]}")
            print(f"precompute {matcher}: matches a pair {[len(z[k]) for k in z.files]}",
                  flush=True)


# ---- phase 17: profiler, trace, visloc, figures, the 6DReg variants -----------------

REG_HW = (368, 272)  # SixDRegConfig().image_hw


def _pose_diff(a, b) -> float:
    return max(max_err(getattr(a, k).float(), getattr(b, k).float())
               for k in ("R", "t", "gating"))


def profiled_requests(dev, card: str) -> None:
    """Phase 17 (a): FARConfig() bf16 at B=4, 480x640, compiled
    (build_inference_fn). Three unprofiled requests from one generator
    state (their spread is the run-to-run difference), then three inside
    ``InferenceProfiler.profile("far_forward")`` from the same state:
    counts 3, the first profiled request's R, t and gate within the
    unprofiled spread. (``utils.prof.TraceProfiler``'s trace is read in
    phases 4, 9, 10, 15 and 16, ``traced_launches``.)"""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.pipeline import build_inference_fn, init_model
    from far_tpu_torch.utils.config import FARConfig
    from far_tpu_torch.utils.prof import InferenceProfiler

    model = init_model(FARConfig(dtype="bfloat16"), seed=0, device=dev)
    fn = build_inference_fn(model)
    batch = synthetic_batch(B_REQUEST, 480, 640, dev)
    gen = torch.Generator(device=dev)
    fn(batch, generator=gen.manual_seed(5))   # warm-up and capture
    torch.cuda.synchronize()

    def request(prof=None):
        gen.manual_seed(5)
        if prof is None:
            return fn(batch, generator=gen)
        with prof.profile("far_forward"):
            return fn(batch, generator=gen)

    plain = [request() for _ in range(N_REQUESTS)]
    spread = max(_pose_diff(a, b) for a in plain for b in plain)
    prof = InferenceProfiler()
    profiled = [request(prof) for _ in range(N_REQUESTS)]
    diff = _pose_diff(profiled[0], plain[0])
    print(f"profiled far_forward bfloat16 B={B_REQUEST} 480x640: {prof.counts['far_forward']} "
          f"regions; R, t, gate profiled vs unprofiled max abs {diff:.3e}, unprofiled spread "
          f"{spread:.3e} on {card}", flush=True)
    if prof.counts["far_forward"] != N_REQUESTS or not diff <= spread:
        fail(f"profiled requests: counts {dict(prof.counts)}, difference {diff} against "
             f"the unprofiled spread {spread}")
    del model, fn
    torch.cuda.empty_cache()


def _look_at(c, target, roll):
    """World-to-camera rotation of a camera at c looking at target (its +z
    axis), rolled by ``roll`` radians about that axis."""
    import numpy as np

    z = (target - c) / np.linalg.norm(target - c)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    cr, sr = np.cos(roll), np.sin(roll)
    x, y = cr * x + sr * y, -sr * x + cr * y
    return np.stack([x, y, z])


def visloc(dev, card: str) -> None:
    """Phase 17 (b): one query and k=5 reference views with known absolute
    poses (as tests/test_localize.py:make_scene: R_gt = r_q r_tr^T, t_gt =
    r_q (c_tr - c_q)), each camera looking at a shared cloud of 512 points
    projected with 0.5 px noise (f = 517.97 px, 640x480, points outside an
    image masked); the 5 pairs solved on the
    card by FARConfig()'s first-round 5-point RANSAC; then the port's
    ``eval_pipeline_with_ransac`` and ``eval_pipeline_without_ransac`` on
    the host, the solved t scaled to the true baseline's length (the scale
    a metric-depth solver gives). Both position errors < 0.5 scene units,
    tests/test_localize.py::test_ransac_pipeline_smoke's bar."""
    import numpy as np
    import torch

    from far_tpu_torch.eval import localize as loc
    from far_tpu_torch.pipeline import make_solver_configs
    from far_tpu_torch.solvers.pose_estimation import estimate_pose
    from far_tpu_torch.utils.config import FARConfig

    rng = np.random.default_rng(30)
    k, n = 5, 512
    c_q = rng.normal(size=3)
    target = c_q + 6.0 * rng.normal(size=3) / np.sqrt(3.0)
    r_q = _look_at(c_q, target, rng.uniform(-np.pi, np.pi))
    cams = [(_look_at(c, target, rng.uniform(-np.pi, np.pi)), c)
            for c in c_q + rng.normal(size=(k, 3))]
    X = target + rng.normal(size=(n, 3)) * 1.5
    K = np.array([[517.97, 0, 320.0], [0, 517.97, 240.0], [0, 0, 1]])

    def project(r, c):
        p = (X - c) @ r.T
        uv = p[:, :2] / p[:, 2:] * 517.97 + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
        return uv, (p[:, 2] > 0.5) & (uv >= 0).all(-1) & (uv < [640, 480]).all(-1)

    kp0, kp1, valid, R_gt, t_gt = [], [], [], [], []
    for r_tr, c_tr in cams:
        (a, va), (b, vb) = project(r_tr, c_tr), project(r_q, c_q)
        kp0.append(a)
        kp1.append(b)
        valid.append(va & vb)
        R_gt.append(r_q @ r_tr.T)
        t_gt.append(r_q @ (c_tr - c_q))
    first_cfg, _ = make_solver_configs(FARConfig())
    f32 = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=dev)
    Kd = torch.tensor(K, dtype=torch.float32, device=dev).expand(k, 3, 3)
    t0 = time.perf_counter()
    with torch.inference_mode():
        est = estimate_pose(f32(kp0), f32(kp1), Kd, Kd, torch.tensor(np.stack(valid), device=dev),
                            cfg=first_cfg, generator=torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
    ms_solve = (time.perf_counter() - t0) * 1e3
    R_est, t_est = est.R.double().cpu().numpy(), est.t.double().cpu().numpy()
    inl = est.num_inliers.cpu().numpy()
    m2q = loc.matrices_to_quats
    pairs = []
    for i, (r_tr, c_tr) in enumerate(cams):
        t_m = t_est[i] / np.linalg.norm(t_est[i]) * np.linalg.norm(t_gt[i])
        pairs.append(loc.RelaPosePair("q0", loc.AbsPose(m2q(r_tr), c_tr),
                                      loc.RelaPose(m2q(R_gt[i]), t_gt[i]),
                                      loc.RelaPose(m2q(R_est[i]), t_m), 0.5,
                                      inliers=float(inl[i])))
    rot_err = loc.quat_angle_error(m2q(np.stack(R_gt)), m2q(R_est)).ravel()
    result = {"scene": {"pair_data": {"q0": {"test_abs_pose": loc.AbsPose(m2q(r_q), c_q),
                                             "test_pairs": pairs}}, "no_pt_pairs": []}}
    t0 = time.perf_counter()
    best, rates = loc.eval_pipeline_with_ransac(
        result, ransac_thres=[10.0], ransac_iter=2, ransac_miu=1.414, pair_type="relapose",
        err_thres=[(0.25, 2), (0.5, 5)])
    direct, passed = loc.eval_pipeline_without_ransac(result, err_thres=((0.25, 2), (0.5, 5)))
    ms_host = (time.perf_counter() - t0) * 1e3
    print(f"visloc: {k} pairs solved on the card in {ms_solve:.2f} ms (5pt RANSAC, inliers "
          f"{inl.tolist()} of {[int(v.sum()) for v in valid]}, relative rotation errors "
          f"{np.round(rot_err, 4).tolist()} deg); host pipelines {ms_host:.2f} ms: with "
          f"RANSAC position {best[0]:.4f}, rotation {best[1]:.4f} deg, pass rates "
          f"{[float(r) for r in rates]}; "
          f"without RANSAC position {direct[2]:.4f}, rotation {direct[4]:.4f} deg, pass rates "
          f"{passed.tolist()} on {card}", flush=True)
    if not (best[0] < 0.5 and direct[2] < 0.5):
        fail(f"visloc: position errors {best[0]} (RANSAC), {direct[2]} (direct), bar 0.5")


def figure_dump(dev, phase9_median: float) -> None:
    """Phase 17 (c): validate_far with the network guard's float32 weights
    and a ``fig_dir``. Without matplotlib it must raise ImportError naming
    it, and the pass without figures must give phase 9's 'rot median err'
    (to 0.01 deg); with matplotlib, two PNGs."""
    import tempfile

    import torch

    from far_tpu_torch.data.synthetic import SyntheticPairDataset
    from far_tpu_torch.tools.guard import load_guard
    from far_tpu_torch.train.validation import validate_far

    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    model, meta = load_guard(dtype="float32", device=dev)
    ds = SyntheticPairDataset(n=16, hw=model.config.image_size, seed=meta["eval_seed"],
                              n_scenes=16, max_angle_deg=12.0)
    run = lambda fig_dir: validate_far(model, ds, 8, fig_dir=fig_dir,
                                       generator=torch.Generator(device=dev).manual_seed(7))
    with tempfile.TemporaryDirectory() as tmp:
        if have:
            table = run(tmp)
            figs = sorted(p.name for p in Path(tmp).iterdir())
            if figs != ["val_step0000000_pair0.png", "val_step0000000_pair1.png"]:
                fail(f"figure dump: wrote {figs}")
            what = f"matplotlib present: wrote {figs}"
        else:
            try:
                run(tmp)
            except ImportError as e:
                if "matplotlib" not in str(e):
                    fail(f"figure dump: ImportError not naming matplotlib: {e}")
                what = f"no matplotlib: ImportError '{e}'"
            else:
                fail("figure dump: no matplotlib, and validate_far(fig_dir=...) did not raise")
            table = run(None)
    med = table["rot median err"]
    print(f"figure dump: {what}; rot median err {med} against phase 9's {phase9_median} "
          f"(tol 0.01)", flush=True)
    if not abs(med - phase9_median) <= 0.01:
        fail(f"figure dump: rot median err {med}, phase 9's {phase9_median}")


def _variant_close(name: str, got, ref, tol_rel: float = 1e-4) -> float:
    """The card's error relative to max|ref|, held to ``tol_rel``."""
    rel = max_err(got.cpu(), ref) / max(float(ref.abs().max()), 1e-30)
    if not rel <= tol_rel:
        fail(f"6DReg variant {name}: card vs CPU {rel:.3e} max|ref| > {tol_rel}")
    return rel


def sixdreg_variants(dev, card: str) -> None:
    """Phase 17 (d): each aggregator on the regressor's encoder maps (B=2,
    32 channels at 92x68, SixDRegConfig()'s 368x272) and each head on the
    aggregator's output, float32, init_weights(seed 1): card against CPU
    within 1e-4 max|ref| (AngularBinsHead's R and t where the card's argmax
    bins are the CPU's; elsewhere the two bins must be a near-tie), CUDA-
    event ms each. Then mapfree_forward at B=4 in bf16 with normalise_dot,
    cv_half_channels and position_encoder_im1 (launches 16/1/1/0)."""
    import torch

    from far_tpu_torch.data.synthetic import synthetic_batch
    from far_tpu_torch.models import sixdreg as S
    from far_tpu_torch.pipeline import init_model, init_sixdreg, mapfree_forward
    from far_tpu_torch.utils.config import FARConfig
    from far_tpu_torch.utils.convert_weights import init_weights

    cfg = S.SixDRegConfig(dtype="float32")
    g = torch.Generator().manual_seed(17)
    vols = [torch.randn(2, cfg.encoder_out_layers, REG_HW[0] // 4, REG_HW[1] // 4, generator=g)
            for _ in range(2)]
    flags = S.SixDRegConfig(dtype="float32", normalise_dot=True, cv_half_channels=True,
                            position_encoder_im1=True)
    aggs = {"CorrelationVolumeWarping": S.CorrelationVolumeWarping(cfg),
            "CorrelationVolumeWarping (normalise_dot, cv_half_channels, "
            "position_encoder_im1)": S.CorrelationVolumeWarping(flags),
            "CorrelationVolumeWarpingQKV": S.CorrelationVolumeWarpingQKV(cfg),
            "CorrelationVolumeWarpingQKV (residual)": S.CorrelationVolumeWarpingQKV(cfg, True),
            "ConcatAggregator": S.ConcatAggregator(cfg)}
    report = {}
    gvol = None
    with torch.inference_mode():
        for name, mod in aggs.items():
            init_weights(mod, 1)
            ref = mod(*vols)
            m = mod.to(dev)
            dv = [v.to(dev) for v in vols]
            err = _variant_close(name, m(*dv), ref)
            report[name] = (err, cuda_ms(lambda: m(*dv), 5))
            if name == "CorrelationVolumeWarping":
                gvol = ref
        cin = gvol.shape[1]
        heads = {"DeepResBlockHead (full_forward_pass)": S.DeepResBlockHead(cin, True),
                 "ProcrustesHead": S.ProcrustesHead(cin),
                 "AngularBinsHead": S.AngularBinsHead(cin),
                 "QuaternionHead": S.QuaternionHead(cin)}
        for name, mod in heads.items():
            init_weights(mod, 1).eval()
            ref = mod(gvol)
            m = mod.to(dev)
            x = gvol.to(dev)
            out = m(x)
            if name == "AngularBinsHead":
                logits = ref[2]
                errs = [_variant_close(f"{name} logits", out[2], logits)]
                same = out[2].cpu().argmax(-1) == logits.argmax(-1)
                gap = (logits.gather(-1, out[2].cpu().argmax(-1, keepdim=True))[:, 0]
                       - logits.amax(-1)).abs()
                tie = 2e-4 * float(logits.abs().max())
                if not bool((same | (gap <= tie)).all()):
                    fail(f"{name}: argmax bins differ beyond a near-tie ({gap.tolist()})")
                if bool(same.all()):
                    errs += [_variant_close(name, o, r) for o, r in zip(out[:2], ref[:2])]
            else:
                errs = [_variant_close(name, o, r) for o, r in zip(out, ref)]
            report[name] = (max(errs), cuda_ms(lambda: m(x), 5))
    print("6DReg variants, float32, B=2, card vs CPU error / max|ref| and card ms: " + "; ".join(
        f"{k} {e:.3e} / {ms:.3f} ms" for k, (e, ms) in report.items()) + f" on {card}",
        flush=True)

    reg_cfg = S.SixDRegConfig(dtype="bfloat16", normalise_dot=True, cv_half_channels=True,
                              position_encoder_im1=True)
    batch = synthetic_batch(B_REQUEST, 720, 544, dev)
    matcher = init_model(FARConfig(image_size=(720, 544), regress_rt=False, dtype="bfloat16"),
                         seed=0, device=dev)
    reg = init_sixdreg(reg_cfg, seed=1, device=dev)
    gi = torch.Generator().manual_seed(12)
    im0, im1 = (torch.rand(B_REQUEST, *reg.config.image_hw, 3, generator=gi).to(dev)
                for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(out):
        R = out.R
        for v in (R, out.t, out.gating, out.solver_rt):
            if not bool(v.isfinite().all()):
                fail("mapfree_forward with the aggregator flags: non-finite output")
        if orth_err(R) > 1e-3:
            fail(f"mapfree_forward with the aggregator flags: R orthonormal to "
                 f"{orth_err(R):.2e}")

    timed_requests("mapfree_forward 368x272 (normalise_dot, cv_half_channels, "
                   "position_encoder_im1; matcher 720x544)", "bfloat16",
                   lambda: mapfree_forward(matcher, reg, batch, im0, im1, generator=gen),
                   MAPFREE, check, card)
    del matcher, reg
    torch.cuda.empty_cache()


# ---- phase 18: data parallelism ------------------------------------------------------

DDP_STEPS = 3            # timed steps of each DDP run
B_DDP = 4                # the two-rank runs' global batch (2 pairs a rank)
DDP_RANKS = 2
DDP_TIMEOUT_S = 600      # each subprocess of this phase
# 18 (b): the float32 2-rank step against one process on the card (TF32
# off), SGD(lr=1) so a parameter's change is its gradient. The two differ
# in summation order only (the ranks' BatchNorm sums, cuDNN's algorithms
# at 2 pairs against 4); the backbone's train-mode BatchNorms amplify that
# through every stage, as they do the JAX package's own float32 error (5e-2
# of max|g| against float64, tests/test_torch_train.py): on an H100 the
# backbone's largest read 6.4e-3 (layer2.1.conv1) and its layer3 1.44e-3.
# So the whole backbone is held to 5e-2, and every run also plants the
# fault that lives there, bn's moments summed by an all-reduce autograd
# does not see (``_planted_bn_fault``), which must read above that limit.
# Every tensor past the backbone is held to 1e-3, a float32 sum's rounding
# after that amplification
DDP_F32_TOL = {"metrics": 1e-4, "stats": 1e-5, "front": 5e-2, "rest": 1e-3}
DDP_FRONT = ("backbone.",)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fixed_solver(kpts0, kpts1, K0, K1, valid, *args, **kwargs):
    """A solver result that depends on each pair alone (its count of valid
    matches), not on the batch it sits in, for comparing two runs that
    split a batch differently: RANSAC on a random model's matches picks
    among near-ties."""
    import torch

    from far_tpu_torch.solvers.types import PoseEstimate

    B, dev = kpts0.shape[0], kpts0.device
    c, s = math.cos(0.2), math.sin(0.2)
    R = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], device=dev).expand(B, 3, 3)
    t = torch.tensor([0.3, -0.1, 0.9], device=dev).expand(B, 3)
    n = valid.float().sum(-1)
    return PoseEstimate(E=torch.zeros(B, 3, 3, device=dev), R=R, t=t, inliers=valid,
                        num_inliers=torch.floor(0.5 * n) + 17, num_tight=torch.floor(0.1 * n) + 3,
                        num_ultra_tight=torch.zeros(B, device=dev),
                        success=torch.ones(B, dtype=torch.bool, device=dev))


def _stub_solvers():
    """``_fixed_solver`` in place of the trainers' ``estimate_pose``; returns
    the function that puts the real one back."""
    import far_tpu_torch.train.family_trainers as fam
    import far_tpu_torch.train.trainer as trainer

    real = trainer.estimate_pose
    trainer.estimate_pose = fam.estimate_pose = _fixed_solver

    def restore():
        trainer.estimate_pose = fam.estimate_pose = real
    return restore


def _ddp_batches(dev):
    """The two-rank runs' global batches: FAR (B_DDP pairs at 480x640 with
    depth), ViTEss (B_FAMILY gated pairs at 384x512) and map-free (B_FAMILY
    pairs at 368x272, 512 ground-truth matches)."""
    from far_tpu_torch.configs import PRESETS
    from far_tpu_torch.data.synthetic import (
        GTCorrespondenceDataset, SolverPoseDataset, SyntheticPairDataset, collate)
    from far_tpu_torch.train.family_trainers import collate_sixdreg, collate_vitess

    ds = SyntheticPairDataset(n=B_DDP, hw=(480, 640), seed=0)
    far = collate([ds[i] for i in range(B_DDP)], dev)[0]
    ds = SolverPoseDataset(SyntheticPairDataset(n=B_FAMILY, hw=VITESS_TRAIN_HW, seed=0))
    vit = collate_vitess([ds[i] for i in range(B_FAMILY)], dev)
    hw = PRESETS["mapfree"]().model.image_hw
    ds = GTCorrespondenceDataset(SyntheticPairDataset(n=B_FAMILY, hw=hw, seed=0),
                                 max_matches=512)
    return far, vit, collate_sixdreg([ds[i] for i in range(B_FAMILY)], dev)


def _sgd_step(tr, batch, f64: bool = False) -> dict:
    """One SGD(lr=1) step on this rank's rows of the global batch: its
    metrics, each parameter's change (minus its gradient) and the
    BatchNorm statistics on the CPU. With ``f64`` the model is made float64 and the step runs
    under ``float64_compute`` with K4's plain version (no float64 kernel)."""
    import contextlib
    import dataclasses

    import torch

    import far_tpu_torch.models.regressor as regressor
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax_plain
    from far_tpu_torch.parallel import comm
    from far_tpu_torch.utils.float64 import float64_compute

    k4 = regressor.bilinear_dual_softmax_auto
    if f64:
        tr.model.double()
        batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)
            and getattr(batch, f.name).is_floating_point()})
        regressor.bilinear_dual_softmax_auto = bilinear_dual_softmax_plain
    params = tr.parameters() if callable(getattr(tr, "parameters", None)) \
        else list(tr.model.parameters())
    tr.optimizer = torch.optim.SGD(params, lr=1.0)
    start = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    try:
        with float64_compute() if f64 else contextlib.nullcontext():
            metrics = tr.step(comm.shard_rows(batch))
    finally:
        regressor.bilinear_dual_softmax_auto = k4
    state = tr.model.state_dict()
    stats = ("running_mean", "running_var")
    return {"metrics": metrics,
            "delta": {k: (v - start[k]).cpu() for k, v in state.items()
                      if v.is_floating_point() and not k.endswith(stats)},
            "stats": {k: v.cpu() for k, v in state.items() if k.endswith(stats)},
            "extra": {k: p.detach().cpu() for k, p in getattr(tr, "extra", {}).items()}}


def _step_errors(got: dict, ref: dict, front=(), zero_grad=()) -> dict:
    """The largest relative errors of a step against a reference: metrics
    (of |ref|), BatchNorm statistics and parameter changes (of max|ref|)
    in ``front`` and past it; a ``zero_grad`` bias (exact gradient 0)
    against its convolution weight's max|ref change|. Each (error, name)."""
    def rel(a, b, scale):
        return float((a.double() - b.double()).abs().max()) / max(float(scale), 1e-30)

    out = {"metrics": max((abs(got["metrics"][k] - v) / max(abs(v), 1e-30), k)
                          for k, v in ref["metrics"].items() if v != 0.0),
           "stats": max(((rel(got["stats"][k], v, v.abs().max()), k)
                         for k, v in ref["stats"].items()), default=(0.0, "")),
           "front": (0.0, ""), "rest": (0.0, "")}
    for k, v in ref["delta"].items():
        scale = ref["delta"][k[:-4] + "weight"].abs().max() if k in zero_grad \
            else v.abs().max()
        where = "front" if k.startswith(front) else "rest"
        out[where] = max(out[where], (rel(got["delta"][k], v, scale), k))
    for k, v in ref["extra"].items():
        out["rest"] = max(out["rest"], (rel(got["extra"][k], v, v.abs().max()), k))
    return out


def _ddp_reference_steps(dev, far, vit, mf) -> dict:
    """One SGD(1) step, the solver stubbed, of FARConfig() in float32 on
    ``far`` and, in float64, of ViTEssTrainer (the interiornet preset's
    model) on ``vit`` and SixDRegTrainer (the mapfree preset's) on ``mf``:
    the same calls in one process and on each rank."""
    import dataclasses

    from far_tpu_torch.configs import PRESETS
    from far_tpu_torch.train.family_trainers import SixDRegTrainer, ViTEssTrainer
    from far_tpu_torch.train.trainer import Trainer

    model = lambda preset: dataclasses.replace(PRESETS[preset]().model, dtype="float32")
    restore = _stub_solvers()
    try:
        return {"far_f32": _sgd_step(Trainer(_train_cfg(), device=dev).init(seed=0), far),
                "vitess": _sgd_step(ViTEssTrainer(model("interiornet"),
                                                  device=dev).init(seed=0), vit, f64=True),
                "sixdreg": _sgd_step(SixDRegTrainer(model("mapfree"),
                                                    device=dev).init(seed=0), mf, f64=True)}
    finally:
        restore()


def _planted_bn_fault(dev, far) -> dict:
    """``_sgd_step`` of the float32 FAR step with bn's moments summed over
    ranks by a plain all-reduce, one that autograd does not see: the
    forward is right, x's gradient lacks the other ranks' terms. Phase 18
    (b)'s backbone tolerance must fail it."""
    import torch.distributed as dist

    import far_tpu_torch.models.backbone as backbone
    from far_tpu_torch.train.trainer import Trainer

    def plain_all_reduce(x):
        total = x.detach().clone()
        dist.all_reduce(total)
        return x + (total - x.detach())

    real, backbone.all_reduce_sum = backbone.all_reduce_sum, plain_all_reduce
    restore = _stub_solvers()
    try:
        return _sgd_step(Trainer(_train_cfg(), device=dev).init(seed=0), far)
    finally:
        backbone.all_reduce_sum = real
        restore()


def ddp_nccl_world1(dev, card: str) -> None:
    """Phase 18 (a): a process group of one over NCCL in this process.
    FARConfig() in bfloat16 at 480x640, B=2 synthetic pairs with depth,
    AdamW as phase 8 (c): 3 steps of the plain Trainer (no group), then
    3 DDP steps from the same weights and generator in the group. cuDNN
    and PyTorch's scatters run their deterministic algorithms, so the
    plain run is repeated to show it is bit-reproducible; the DDP run's
    metrics and every parameter and statistic must then be bit-equal to
    it, and each DDP step launch K1 16 and K4 twice (K2, K3 none), read
    from the counters set to 0 before it."""
    import torch
    import torch.distributed as dist

    from far_tpu_torch.data.synthetic import SyntheticPairDataset, collate
    from far_tpu_torch.parallel import comm
    from far_tpu_torch.train.optim import OptimConfig
    from far_tpu_torch.train.trainer import Trainer

    cfg = _train_cfg(dtype="bfloat16")
    ds = SyntheticPairDataset(n=B_TRAIN, hw=cfg.image_size, seed=0)
    batch, _ = collate([ds[i] for i in range(B_TRAIN)], dev)
    fns = counters()

    def run():
        tr = Trainer(cfg, OptimConfig(lr=TRAIN_LR, warmup_steps=0, scheduler="none"),
                     device=dev).init(seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        metrics, times, launched = [], [], []
        for _ in range(DDP_STEPS):
            reset_counters()
            t0 = time.perf_counter()
            metrics.append(tr.step(batch, generator=gen))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launched.append({k: f.launches for k, f in fns.items()})
        state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        return metrics, times, launched, state, type(tr._ddp).__name__

    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plain = run()
            again = run()
        nondet = sorted({str(w.message).split(" does not have")[0] for w in caught
                         if "deterministic" in str(w.message)})
        comm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
        backend = dist.get_backend()
        ddp = run()
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
        if dist.is_initialized():
            dist.destroy_process_group()
    same = lambda a, b: a[0] == b[0] and all(torch.equal(v, b[3][k]) for k, v in a[3].items())
    want = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 0, "K3_fine_transformer": 0,
            "K4_bilinear_dual_softmax": 2}
    ms = lambda r: statistics.median(r[1][1:])
    print(f"ddp (a) NCCL world of 1, FARConfig() bf16 B={B_TRAIN} 480x640: backend {backend}, "
          f"wrapper {ddp[4]}; plain run bit-reproducible {same(again, plain)}, DDP run "
          f"bit-equal to it {same(ddp, plain)}; loss by step "
          f"{[m['loss'] for m in ddp[0]]}; ms/step median (steps 2-{DDP_STEPS}) DDP "
          f"{ms(ddp):.2f}, plain {ms(plain):.2f}, {ms(again):.2f} (deterministic "
          f"algorithms; ops without a deterministic one: {nondet}); launches a DDP step "
          f"{ddp[2]} on {card}", flush=True)
    if backend != "nccl" or ddp[4] != "DistributedDataParallel" or plain[4] != "FarStep":
        fail(f"ddp (a): backend {backend}, wrapper {ddp[4]} / {plain[4]}")
    if not same(again, plain):
        fail("ddp (a): two plain runs under deterministic algorithms differ")
    if not same(ddp, plain):
        fail("ddp (a): the DDP run in a world of one differs from the plain run")
    if any(got != want for got in ddp[2]):
        fail(f"ddp (a): launches {ddp[2]}, expected {want} a step")
    del plain, again, ddp
    torch.cuda.empty_cache()


def _guard_draws(dev) -> list:
    """Phase 7's sampler draws for the guard's 16 pairs, one list of round
    tensors a pair: guard_eval's two batches of 8 draw each round's (8,
    n_samples, S) uniforms from a generator seeded 7, as
    ``train.trainer.solver_draws`` does in one process."""
    import torch

    from far_tpu_torch.tools.guard import tiny_config
    from far_tpu_torch.train.trainer import solver_draws

    gen = torch.Generator(device=dev).manual_seed(7)
    rounds = [solver_draws(tiny_config("float32"), 8, gen, dev) for _ in range(2)]
    return [[u[i % 8].cpu() for u in rounds[i // 8]] for i in range(16)]


def _guard_per_batch() -> dict:
    from far_tpu_torch.tools.guard import tiny_config

    cfg = tiny_config("float32")
    return {"K1_loftr_layer": 2 * len(cfg.coarse.layer_names)
            + 4 * cfg.regress.num_loftr_layers, "K2_dual_softmax_rowcol": 1,
            "K3_fine_transformer": 1, "K4_bilinear_dual_softmax": 2}


def ddp_worker(work: Path) -> int:
    """One rank of phase 18 (b)-(d), started by ``ddp_two_ranks`` with the
    environment torch.distributed.run sets: both ranks on card 0, joined
    over gloo (NCCL refuses two ranks on one card). Saves what it
    measured to ``<work>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from far_tpu_torch.data.sampler import sequential_indices
    from far_tpu_torch.data.synthetic import SyntheticPairDataset
    from far_tpu_torch.parallel import comm
    from far_tpu_torch.pipeline import init_model
    from far_tpu_torch.tools.guard import load_guard
    from far_tpu_torch.train.optim import OptimConfig
    from far_tpu_torch.train.trainer import Trainer
    from far_tpu_torch.train.validation import validate_far
    from far_tpu_torch.utils.config import FARConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo")
    rank = comm.process_index()
    inp = torch.load(work / "inputs.pt", weights_only=False)
    far, vit, mf = _ddp_batches(dev)
    fns = counters()

    out = _ddp_reference_steps(dev, far, vit, mf)
    out["far_f32_fault"] = _planted_bn_fault(dev, far)
    far = comm.shard_rows(far)

    # bf16 with the real solver: DDP steps, then steps without the gradient
    # all-reduce (DDP's no_sync), the ms of each and the peak memory
    tr = Trainer(_train_cfg(dtype="bfloat16"), OptimConfig(lr=TRAIN_LR, warmup_steps=0,
                                                           scheduler="none"),
                 device=dev).init(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    runs = {"synced": [], "no_sync": []}
    for mode in runs:
        for _ in range(DDP_STEPS + 1):
            reset_counters()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "synced":
                m = tr.step(far, generator=gen)
            else:
                with tr._ddp.no_sync():
                    m = tr.step(far, generator=gen)
            torch.cuda.synchronize()
            runs[mode].append(((time.perf_counter() - t0) * 1e3, m,
                               {k: f.launches for k, f in fns.items()}))
    out["bf16"] = {"runs": runs, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del tr
    torch.cuda.empty_cache()

    # validation with the guard's weights on this rank's shard of its 16
    # pairs, with phase 7's draws for those pairs
    mine = sequential_indices(16, rank=rank, world_size=comm.process_count())
    uniforms = [torch.stack([inp["guard_draws"][i][r] for i in mine]).to(dev)
                for r in range(len(inp["guard_draws"][0]))]
    out["validation"] = {}
    for dtype in ("float32", "bfloat16"):
        model, meta = load_guard(dtype=dtype, device=dev)
        ds = SyntheticPairDataset(n=16, hw=model.config.image_size, seed=meta["eval_seed"],
                                  n_scenes=16, max_angle_deg=12.0)
        reset_counters()
        table = validate_far(model, ds, len(mine), uniforms=[uniforms])
        torch.cuda.synchronize()
        out["validation"][dtype] = {"table": table,
                                    "launches": {k: f.launches for k, f in fns.items()}}
    # FARConfig() in bf16 at full width: 8 synthetic pairs, one batch of 4 a rank
    model = init_model(FARConfig(dtype="bfloat16"), seed=0, device=dev)
    ds = SyntheticPairDataset(n=DDP_RANKS * B_REQUEST, hw=(480, 640), seed=0)
    reset_counters()
    table = validate_far(model, ds, B_REQUEST,
                         generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    out["validation"]["FARConfig() bfloat16"] = {
        "table": table, "launches": {k: f.launches for k, f in fns.items()}}
    torch.save(out, work / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ddp_two_ranks(dev, card: str, guard_medians: dict) -> None:
    """Phase 18 (b)-(d): two ranks (``ddp_worker``) on this card over gloo,
    each a subprocess under a timeout. (b) FARConfig() in float32 (TF32
    off), one SGD(1) step on a global batch of 4 with the solver stubbed,
    against the one-process step on the 4 pairs here, within DDP_F32_TOL,
    and the planted fault (``_planted_bn_fault``) outside the backbone's
    tolerance; then in bfloat16 with the real solver, 3 DDP steps (after one
    warm-up), finite, K1 16 and K4 2 a step on each rank, their ms, the
    same steps without the gradient all-reduce (``no_sync``), whose gap
    is the all-reduce's share, and the peak memory of each rank. (c) one
    float64 step of ViTEssTrainer (interiornet preset, global B=6) and of
    SixDRegTrainer (mapfree preset, B=6), solver stubbed, against one
    process within F64_TOL. (d) validate_far with the guard's weights, 8
    of its 16 pairs a rank with phase 7's draws, float32 and bfloat16: the
    table's median within 0.01 deg of phase 7's, 16 pairs, and the guard
    config's launches (K1/K2/K3/K4 8/1/1/2: 4 coarse layers, no regressor
    LoFTR) for the one batch of each rank; then FARConfig() in bf16, 8
    pairs at 480x640, one batch of 4 a rank: 8 finite pairs, K1/K2/K3/K4
    16/1/1/2. Both ranks' metrics, states and tables must agree."""
    import os
    import subprocess
    import tempfile

    import torch

    from far_tpu_torch.models.sixdreg import MapfreeRegression
    from far_tpu_torch.models.vitess import ViTEss

    far, vit, mf = _ddp_batches(dev)
    ref = _ddp_reference_steps(dev, far, vit, mf)
    del far, vit, mf
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        torch.save({"guard_draws": _guard_draws(dev)}, work / "inputs.pt")
        port = _free_port()
        procs, logs = [], []
        t0 = time.perf_counter()
        for rank in range(DDP_RANKS):
            # both ranks share this card beside this process: a rank's f32 and
            # float64 steps leave large cached blocks that small live tensors
            # keep from being released; expandable segments let empty_cache
            # hand their unused pages back
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "WORLD_SIZE": str(DDP_RANKS), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port),
                   "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
            log = open(work / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--ddp-worker", str(work)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(DDP_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if codes != [0] * DDP_RANKS:
            logs = [(work / f"rank{r}.log").read_text() for r in range(DDP_RANKS)]
            # each log from its first traceback on (its end where there is none)
            tails = "\n".join(text[text.find("Traceback"):][:6000] if "Traceback" in text
                              else text[-3000:] for text in logs)
            fail(f"ddp: the rank processes exited with {codes} (killed after "
                 f"{DDP_TIMEOUT_S} s if still running):\n{tails}")
        print(f"ddp: two ranks on the card over gloo ran (b)-(d) in "
              f"{time.perf_counter() - t0:.1f} s (each process's start included)", flush=True)
        out = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DDP_RANKS)]

    failures = []
    for key in ("far_f32", "vitess", "sixdreg"):
        a, b = out[0][key], out[1][key]
        agree = a["metrics"] == b["metrics"] and all(
            torch.equal(v, b[part][k]) for part in ("delta", "stats", "extra")
            for k, v in a[part].items())
        if not agree:
            failures.append(f"ddp {key}: the two ranks' metrics or states differ")

    err = _step_errors(out[0]["far_f32"], ref["far_f32"], DDP_FRONT)
    ok = all(err[k][0] <= DDP_F32_TOL[k] for k in DDP_F32_TOL)
    print(f"ddp (b) FARConfig() f32 2 ranks x {B_DDP // DDP_RANKS} pairs vs one process "
          f"x {B_DDP}, SGD(1): metrics {out[0]['far_f32']['metrics']}; max rel err metrics "
          f"{err['metrics']}, BatchNorm statistics {err['stats']}, parameter changes in "
          f"the backbone {err['front']} and past it {err['rest']}; tolerances "
          f"{DDP_F32_TOL}" + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        failures.append("ddp (b): the float32 two-rank step disagrees with one process")
    fault = _step_errors(out[0]["far_f32_fault"], ref["far_f32"], DDP_FRONT)
    caught = fault["front"][0] > DDP_F32_TOL["front"]
    print(f"ddp (b) planted fault, bn's moments by an all-reduce autograd does not see: "
          f"parameter changes in the backbone {fault['front']} and past it {fault['rest']}; "
          + ("over the backbone's tolerance, caught" if caught else "NOT caught"), flush=True)
    if not caught:
        failures.append("ddp (b): the backbone's tolerance passes bn without the other "
                        "rank's gradient terms")

    for key, preset in (("vitess", "interiornet"), ("sixdreg", "mapfree")):
        biases = (ViTEss if key == "vitess" else MapfreeRegression).BIAS_BEFORE_BN
        err = _step_errors(out[0][key], ref[key], zero_grad=biases)
        worst = max(err["metrics"], err["stats"], err["rest"])
        print(f"ddp (c) {key} ({preset} preset) f64 2 ranks x {B_FAMILY // DDP_RANKS} vs one "
              f"process x {B_FAMILY}, SGD(1): metrics {out[0][key]['metrics']}; max rel err "
              f"{worst} (tol {F64_TOL})" + (" ok" if worst[0] <= F64_TOL else " FAILED"),
              flush=True)
        if not worst[0] <= F64_TOL:
            failures.append(f"ddp (c): the {key} two-rank step disagrees with one process")

    want_step = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 0, "K3_fine_transformer": 0,
                 "K4_bilinear_dual_softmax": 2}
    want_batch = {"K1_loftr_layer": 16, "K2_dual_softmax_rowcol": 1, "K3_fine_transformer": 1,
                  "K4_bilinear_dual_softmax": 2}
    for r, o in enumerate(out):
        runs = o["bf16"]["runs"]
        for mode, steps in runs.items():
            if any(launched != want_step for _, _, launched in steps):
                failures.append(f"ddp (b) rank {r} {mode}: launches {[s[2] for s in steps]}")
            if not all(math.isfinite(v) for _, m, _ in steps for v in m.values()):
                failures.append(f"ddp (b) rank {r} {mode}: non-finite metrics")
        synced = statistics.median(t for t, _, _ in runs["synced"][1:])
        alone = statistics.median(t for t, _, _ in runs["no_sync"][1:])
        print(f"ddp (b) rank {r} FARConfig() bf16 global B={B_DDP} 480x640 over gloo on one "
              f"card: ms/step median {synced:.2f} (steps 2-{DDP_STEPS + 1}: "
              f"{[round(t, 2) for t, _, _ in runs['synced']]}), without the gradient "
              f"all-reduce {alone:.2f}, the all-reduce's share {1 - alone / synced:.3f}, peak "
              f"memory {o['bf16']['peak_gib']:.3f} GiB; loss by step "
              f"{[round(m['loss'], 6) for _, m, _ in runs['synced']]} on {card}", flush=True)

    per_batch = _guard_per_batch()
    for dtype in ("float32", "bfloat16"):
        for r, o in enumerate(out):
            v = o["validation"][dtype]
            med = v["table"]["rot median err"]
            gap = abs(med - guard_medians[dtype])
            print(f"ddp (d) validate_far guard {dtype} rank {r}: rot median err {med} against "
                  f"phase 7's {guard_medians[dtype]:.4f} (gap {gap:.4f}, tol 0.01), dset size "
                  f"{v['table']['dset size']}, launches {v['launches']}", flush=True)
            if not (gap <= 0.01 and v["table"]["dset size"] == 16
                    and v["launches"] == per_batch):
                failures.append(f"ddp (d) {dtype} rank {r}: table {v['table']}, launches "
                                f"{v['launches']}, expected {per_batch}")
        if out[0]["validation"][dtype]["table"] != out[1]["validation"][dtype]["table"]:
            failures.append(f"ddp (d) {dtype}: the ranks' tables differ")
    full = "FARConfig() bfloat16"
    n_full = DDP_RANKS * B_REQUEST
    for r, o in enumerate(out):
        v = o["validation"][full]
        print(f"ddp (d) validate_far {full} 480x640, {n_full} pairs, B={B_REQUEST} a rank, rank "
              f"{r}: {json.dumps(v['table'])}; launches {v['launches']}", flush=True)
        if v["launches"] != want_batch or not (v["table"]["dset size"] == n_full and all(
                math.isfinite(x) for x in v["table"].values())):
            failures.append(f"ddp (d) {full} rank {r}: table {v['table']}, launches "
                            f"{v['launches']}, expected {want_batch}")
    if out[0]["validation"][full]["table"] != out[1]["validation"][full]["table"]:
        failures.append(f"ddp (d) {full}: the ranks' tables differ")
    if failures:
        fail("; ".join(failures))


def ddp_cli(dev, card: str) -> None:
    """Phase 18 (e): ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m far_tpu_torch.cli.train --device cuda``,
    FARConfig() in bfloat16 at 480x640, 3 steps at B=2 (NCCL, a world of
    one), then ``evaluate --ckpt_dir`` the same way on 4 pairs: the
    entry points report their NCCL group, the evaluation a finite table, and the
    checkpoint's weights restored by ``evaluate._restore_variables`` equal
    to it bit for bit."""
    import subprocess
    import tempfile

    import torch

    from far_tpu_torch.cli import evaluate
    from far_tpu_torch.pipeline import init_model

    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m"]
    common = ["--dataset", "synthetic", "--image_size", "480x640", "--dtype", "bfloat16",
              "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, argv in (
                ("train", ["far_tpu_torch.cli.train"] + common + [
                    "--n_synthetic", "8", "--batch_size", "2", "--sampler", "sequential",
                    "--log_every", "1", "--steps", "3", "--ckpt_dir", str(tmp / "ckpt"),
                    "--log_dir", str(tmp / "logs")]),
                ("evaluate", ["far_tpu_torch.cli.evaluate"] + common + [
                    "--n_synthetic", "4", "--batch_size", "4", "--ckpt_dir",
                    str(tmp / "ckpt"), "--out_dir", str(tmp / "eval")])):
            t0 = time.perf_counter()
            proc = subprocess.run(run + argv, capture_output=True, text=True,
                                  timeout=DDP_TIMEOUT_S)
            sec = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"ddp (e) torch.distributed.run {name}: exit {proc.returncode}\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            print(f"ddp (e) torch.distributed.run --nproc_per_node 1 {name}: {sec:.1f} s "
                  f"(the process's start included); its output ends "
                  f"{proc.stdout.strip().splitlines()[-1][:200]!r}", flush=True)
            if "data parallel: 1 process, nccl" not in proc.stdout:
                fail(f"ddp (e) {name}: no NCCL group reported:\n{proc.stdout[-2000:]}")
            if name == "evaluate":
                text = proc.stdout
                table = json.loads(text[text.rindex("\n{\n"):])["fused"]
                _finite_table("ddp (e) evaluate", table, 4)
        args = evaluate.parse_args(["--image_size", "480x640", "--dtype", "bfloat16",
                                    "--ckpt_dir", str(tmp / "ckpt"), "--device", "cuda"])
        restored = evaluate._restore_variables(
            args.ckpt_dir, init_model(evaluate.far_config(args), seed=1, device=dev))
        saved = torch.load(tmp / "ckpt" / "3.pt", map_location="cpu", weights_only=False)
        bad = [k for k, v in restored.state_dict().items()
               if not torch.equal(v.cpu(), saved["model"][k])]
        if saved["step"] != 3 or bad:
            fail(f"ddp (e): checkpoint step {saved['step']}, restored unlike it: {bad[:4]}")


def main() -> int:
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--ddp-worker"]:
        return ddp_worker(Path(sys.argv[2]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from far_tpu_torch.ops import _build

    dev = torch.device("cuda")
    # f32 comparisons use full f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    entries = check_kernels(dev)
    fivepoint = fivepoint_entry(dev, card)
    small_linalg = small_linalg_entry(dev, card)
    t_4 = time.perf_counter()
    compiled_request(dev, card)
    print(f"compiled request (phase 4): {time.perf_counter() - t_4:.1f} s", flush=True)
    small_agreement(dev)
    for minimal_solver in ("5pt", "8pt"):
        solver_guard(dev, minimal_solver)
    guard_medians = network_guard(dev)
    train_functions(dev)
    train_small_agreement(dev)
    train_full(dev, card)
    validation_medians = validation(dev, card, guard_medians)
    sinkhorn_requests(dev, card)
    sinkhorn_train(dev, card)
    remat_steps(dev, card)
    vitess_golden(dev)
    vitess_requests(dev, card)
    sixdreg_golden(dev)
    mapfree_requests(dev, card)
    k4_vitess_train(dev, card)
    family_train(dev, card)
    family_small_agreement(dev)
    classical_baseline(dev, card)
    t_cli = time.perf_counter()
    entry_points(dev, card)
    print(f"entry points (phase 15): {time.perf_counter() - t_cli:.1f} s", flush=True)
    t_opt = time.perf_counter()
    kernels_16_4(dev)
    option_requests(dev, card)
    groupnorm_card_vs_cpu(dev)
    superglue_requests(dev, card)
    simple_transformer_request(dev, card)
    matcher_clis(dev, card)
    print(f"options and matchers (phase 16): {time.perf_counter() - t_opt:.1f} s", flush=True)
    t_17 = time.perf_counter()
    profiled_requests(dev, card)
    visloc(dev, card)
    figure_dump(dev, validation_medians["float32"])
    sixdreg_variants(dev, card)
    print(f"profiler, trace, visloc, figures, 6DReg variants (phase 17): "
          f"{time.perf_counter() - t_17:.1f} s", flush=True)
    t_18 = time.perf_counter()
    ddp_nccl_world1(dev, card)
    ddp_two_ranks(dev, card, guard_medians)
    ddp_cli(dev, card)
    print(f"data parallelism (phase 18): {time.perf_counter() - t_18:.1f} s", flush=True)

    # the kernels line: each kernel alone (phase 3), PERF.md section 6's table
    src = {"K1_loftr_layer": ("loftr_layer.cu", "far_tpu/ops/loftr_layer.py:147"),
           "K2_dual_softmax_rowcol": ("matching_kernel.cu", "far_tpu/ops/matching_kernel.py:125"),
           "K3_fine_transformer": ("fine_layer.cu", "far_tpu/ops/fine_layer.py:246"),
           "K4_bilinear_dual_softmax": ("bilinear_attention.cu",
                                        "far_tpu/ops/bilinear_attention.py:171")}
    kernels = []
    for name, (cu, replaces) in src.items():
        # the main path's default dtype is float32; K2 always takes bf16
        main = "bf16" if name.startswith("K2") else "f32"
        other = "f32" if main == "bf16" else "bf16"
        kernels.append({"name": name, "source": f"far_tpu_torch/csrc/{cu}",
                        "replaces": replaces, **entries[name][main],
                        other: entries[name][other]})
    # the backbone's glue between cuDNN convolutions: XLA's fusions in the
    # JAX package, not a Pallas kernel
    kernels.append({"name": "backbone_glue", "source": "far_tpu_torch/csrc/backbone_glue.cu",
                    "replaces": "none: the JAX package leaves this glue to XLA's fusions",
                    **entries["backbone_glue"]["bf16"], "f32": entries["backbone_glue"]["f32"]})
    # the polish's eigensolver and 3x3 SVD (XLA's eigh/svd inside the JAX
    # package's jit) and the fused 5-point kernel (plain jnp in the jit):
    # not Pallas kernels
    kernels.append({
        "name": "small_linalg", "source": "far_tpu_torch/csrc/small_linalg.cu",
        "replaces": "far_tpu/geometry/solvers.py:65 (jnp.linalg.eigh; svd at :178, :209)",
        "dtype": "f32", **small_linalg})
    kernels.append({
        "name": "fivepoint", "source": "far_tpu_torch/csrc/fivepoint.cu",
        "replaces": "far_tpu/geometry/fivepoint.py:run_5point_essential (plain jnp in the jit)",
        "dtype": "f32", **fivepoint})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
