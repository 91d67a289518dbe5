#!/usr/bin/env python3
"""Drive far_tpu_torch, the PyTorch + CUDA port of FAR, on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports nothing
of JAX or of ``far_tpu``. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``far_tpu_torch/csrc`` (one ``nvcc`` per source,
   all started together);
3. each kernel K1-K4 at the main path's shapes (B=2 pairs), in float32
   and bfloat16: launched next to its plain PyTorch version on the same
   inputs and held to a stated tolerance, both timed with CUDA events,
   with a PyTorch library call timed beside it where one computes the
   same function; then the bfloat16 tensor-core routes of K1 and K4 at
   ragged shapes (inputs from a generator of their own);
4. ``far_forward`` at 480x640 and full width (8-point solver), three
   requests of B=4 in float32 and three in bfloat16, with the kernels'
   launch counters (all launches, and those of the tensor-core routes)
   set to 0 just before and read just after;
5. the matcher and the EMM features at a small width with the kernels on
   the card and with the plain versions on the CPU, compared;
6. the port's solver on 16 synthetic scenes at 0.5 px noise.

Prints one JSON line with the kernels' numbers, then the card line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
EX2_PER_CLOCK_SM = 16  # exponentials (MUFU.EX2) per clock per SM, sm_90

B_KERNEL = 2        # pairs at which the kernels are held to their plain versions
B_REQUEST = 4       # pairs per far_forward request
N_REQUESTS = 3
L_COARSE = 60 * 80  # coarse tokens at 480x640
C_COARSE, H_COARSE = 256, 8
K_MATCH, WW, C_FINE, H_FINE = 1024, 25, 128, 8
H_EMM, D_EMM = 4, 64


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


ROUTES = {  # how each kernel computes in bfloat16
    "K1_loftr_layer": "cuda, tensor cores (wgmma, cp.async), 3 launches",
    "K2_dual_softmax_rowcol": "cuda, CUDA cores (f32 FMA)",
    "K3_fine_transformer": "cuda, CUDA cores (f32 FMA)",
    "K4_bilinear_dual_softmax": "cuda, tensor cores (wgmma, cp.async), 3 launches",
}


def check_kernels(dev):
    """Phase 3. Returns the kernels' JSON entries."""
    import torch

    from far_tpu_torch.ops.bilinear_attention import (
        bilinear_dual_softmax, bilinear_dual_softmax_plain)
    from far_tpu_torch.ops.fine_layer import fine_transformer, fine_transformer_plain
    from far_tpu_torch.ops.loftr_layer import (
        loftr_layer, loftr_layer_plain, pack_params)
    from far_tpu_torch.ops.matching_kernel import (
        dual_softmax_rowcol, dual_softmax_rowcol_plain)

    g = torch.Generator().manual_seed(0)
    B, L, C = B_KERNEL, L_COARSE, C_COARSE
    entries = {}
    failures = []

    def ragged(what, err, tol):
        ok = err <= tol
        print(f"ragged {what}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failures.append(what)

    def k4_tol(dt, ref):
        # f32: both in f32 on the same inputs, summation order only. bf16:
        # the kernel rounds P and H = G / csum to bf16 as the TPU kernel
        # does (2^-9 relative each, of random sign, before sums over N).
        return (1e-4 if dt == torch.float32 else 1e-2) * float(ref.abs().max())

    def k4_exps(dt, elements):
        """Exponentials of S's elements on the exponential unit: the
        function's least (2 per element: E = 2^(s - cmax) feeds the column
        sums, and P = E^2 2^cmax[m] 2^-alpha[n] needs only per-row and
        per-column factors beside one row-sum exponential) and the route's
        own count (bf16 3: 1 statistics pass, 2 main pass; float32 4: 2
        statistics, 2 tile pass). Neither is a hard floor, since an
        exponential can also run on the FMA units as a polynomial, so
        neither enters bound_ms."""
        return 2 * elements, (3 if dt == torch.bfloat16 else 4) * elements

    def record(name, dt, err, tol, ms, plain_ms, flops, nbytes, lib_ms=None,
               extra="", exps=None):
        peak = PEAK_F32 if dt == torch.float32 else PEAK_BF16
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        tag = "f32" if dt == torch.float32 else "bf16"
        ok = err <= tol
        e = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        if exps:
            e["exp_bound_ms"], e["exp_route_ms"] = (n / exp_rate() * 1e3 for n in exps)
            extra += (f" exp_bound_ms={e['exp_bound_ms']:.4f} "
                      f"exp_route_ms={e['exp_route_ms']:.4f}")
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'DISAGREES'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms} {extra}",
              flush=True)
        if not ok:
            failures.append(f"{name} {tag}")
        if tag == "bf16":
            e["route"] = ROUTES[name]
        entries.setdefault(name, {})[tag] = e

    # ---- K1: one coarse LoFTR layer (cross: x attends to src) ----------
    x32 = torch.randn(B, L, C, generator=g).to(dev)
    s32 = torch.randn(B, L, C, generator=g).to(dev)
    p = layer_params(C, g, dev)
    d = C // H_COARSE
    k1_flops = B * (20 * L * C * C + 4 * L * C * d + 2 * L * C)
    for dt in (torch.float32, torch.bfloat16):
        x, s = x32.to(dt), s32.to(dt)
        pk = pack_params(p, dt)  # cast once, outside the timed launches
        ref = loftr_layer_plain(x.float(), s.float(), p, H_COARSE)
        out = loftr_layer(x, s, pk, H_COARSE)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # f32: summation order only; bf16: the kernel rounds k, v, KV, q,
        # msg, m, y and out to bf16 (2^-8 relative each), the reference not.
        tol = (1e-4 if dt == torch.float32 else 6e-2) * float(ref.abs().max())
        ms = cuda_ms(lambda: loftr_layer(x, s, pk, H_COARSE), 10)
        plain_ms = cuda_ms(lambda: loftr_layer_plain(x, s, p, H_COARSE), 5)
        e = x.element_size()
        nbytes = 3 * B * L * C * e + 10 * C * C * e + 4 * C * 4
        record("K1_loftr_layer", dt, err, tol, ms, plain_ms, k1_flops, nbytes)

    # ---- K2: dual-softmax row/col reductions ---------------------------
    f0 = torch.randn(B, L, C, generator=g)
    perm = torch.randperm(L, generator=g)
    f1 = f0[:, perm] + 0.5 * torch.randn(B, L, C, generator=g)
    scale = torch.tensor(1.0 / C ** 0.5).to(torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        a = (f0.to(dt) * scale.to(dt)).to(dev).contiguous()
        b = (f1.to(dt) * scale.to(dt)).to(dev).contiguous()
        rv, ri, cm = dual_softmax_rowcol(a, b, 10.0)
        prv, pri, pcm = dual_softmax_rowcol_plain(a, b, 10.0)
        torch.cuda.synchronize()
        err = max(max_err(rv, prv), max_err(cm, pcm))
        # an index may differ only where the plain conf has a near-tie
        sim = torch.einsum("blc,bsc->bls", a.float(), b.float()) * 10.0
        conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
        at_k = torch.gather(conf, 2, ri[..., None])[..., 0]
        idx_gap = float((prv - at_k).abs().max())
        n_diff = int((ri != pri).sum())
        del sim, conf
        err = max(err, idx_gap)
        tol = 1e-6 + 1e-4 * float(prv.abs().max())
        ms = cuda_ms(lambda: dual_softmax_rowcol(a, b, 10.0), 10)
        plain_ms = cuda_ms(lambda: dual_softmax_rowcol_plain(a, b, 10.0), 5)

        def library():  # cuBLAS S + softmax + reductions, materialized
            sm = torch.bmm(a, b.transpose(1, 2)).float() * 10.0
            cf = torch.softmax(sm, 1) * torch.softmax(sm, 2)
            return cf.max(2), cf.amax(1)

        lib_ms = cuda_ms(library, 5)
        nbytes = 2 * B * L * C * a.element_size() + B * L * (4 + 8 + 4)
        record("K2_dual_softmax_rowcol", dt, err, tol, ms, plain_ms,
               2 * B * L * L * C, nbytes, lib_ms,
               extra=f"row_idx_differs={n_diff}")

    # ---- K3: fine transformer over 5x5 windows --------------------------
    n = B * K_MATCH
    w0_32 = torch.randn(n, WW, C_FINE, generator=g).to(dev)
    w1_32 = torch.randn(n, WW, C_FINE, generator=g).to(dev)
    fp = [layer_params(C_FINE, g, dev) for _ in range(2)]
    names = ("self", "cross")
    dd = C_FINE // H_FINE
    k3_flops = 4 * n * (20 * WW * C_FINE ** 2 + 4 * WW * C_FINE * dd)
    for dt in (torch.float32, torch.bfloat16):
        a, b = w0_32.to(dt), w1_32.to(dt)
        r0, r1 = fine_transformer_plain(a.float(), b.float(), fp, names, H_FINE)
        o0, o1 = fine_transformer(a, b, fp, names, H_FINE)
        torch.cuda.synchronize()
        err = max(max_err(o0, r0), max_err(o1, r1))
        tol = (1e-4 if dt == torch.float32 else 6e-2) * float(
            max(r0.abs().max(), r1.abs().max()))
        ms = cuda_ms(lambda: fine_transformer(a, b, fp, names, H_FINE), 10)
        plain_ms = cuda_ms(lambda: fine_transformer_plain(a, b, fp, names, H_FINE), 5)
        e = a.element_size()
        nbytes = 4 * n * WW * C_FINE * e + 2 * 10 * C_FINE ** 2 * e
        record("K3_fine_transformer", dt, err, tol, ms, plain_ms, k3_flops, nbytes)

    # ---- K4: dual-softmax bilinear attention ----------------------------
    Dv = D_EMM + 6
    q32 = torch.randn(B, H_EMM, L, D_EMM, generator=g).to(dev)
    k32 = torch.randn(B, H_EMM, L, D_EMM, generator=g).to(dev)
    v32 = torch.randn(B, H_EMM, L, Dv, generator=g).to(dev)
    k4_flops = B * H_EMM * (2 * L * L * D_EMM + 2 * L * L * Dv + 2 * L * Dv * Dv)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
        ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), 0.125)
        out = bilinear_dual_softmax(q, k, v, 0.125)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        ms = cuda_ms(lambda: bilinear_dual_softmax(q, k, v, 0.125), 10)
        plain_ms = cuda_ms(lambda: bilinear_dual_softmax_plain(q, k, v, 0.125), 3)
        e = q.element_size()
        nbytes = B * H_EMM * L * (2 * D_EMM + Dv) * e + B * H_EMM * Dv * Dv * 4
        record("K4_bilinear_dual_softmax", dt, err, k4_tol(dt, ref), ms, plain_ms,
               k4_flops, nbytes, exps=k4_exps(dt, B * H_EMM * L * L))

    # ---- the bf16 tensor-core routes at ragged shapes --------------------
    # (a generator of their own, so that the inputs above do not change)
    gr = torch.Generator().manual_seed(1)
    for Br, Lr, Sr in ((1, L, L), (B, 1000, 1200)):
        x = torch.randn(Br, Lr, C, generator=gr).to(dev, torch.bfloat16)
        s = torch.randn(Br, Sr, C, generator=gr).to(dev, torch.bfloat16)
        pr = layer_params(C, gr, dev)
        ref = loftr_layer_plain(x.float(), s.float(), pr, H_COARSE)
        out = loftr_layer(x, s, pack_params(pr, torch.bfloat16), H_COARSE)
        torch.cuda.synchronize()
        ragged(f"K1_loftr_layer bf16 B={Br} L={Lr} S={Sr}", max_err(out, ref),
               6e-2 * float(ref.abs().max()))
    for Nr in (1000,):
        q, k = (torch.randn(1, H_EMM, Nr, D_EMM, generator=gr).to(dev, torch.bfloat16)
                for _ in range(2))
        v = torch.randn(1, H_EMM, Nr, Dv, generator=gr).to(dev, torch.bfloat16)
        ref = bilinear_dual_softmax_plain(q.float(), k.float(), v.float(), 0.125)
        out = bilinear_dual_softmax(q, k, v, 0.125)
        torch.cuda.synchronize()
        ragged(f"K4_bilinear_dual_softmax bf16 B=1 N={Nr}", max_err(out, ref),
               k4_tol(torch.bfloat16, ref))

    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    return entries


def counters():
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax
    from far_tpu_torch.ops.fine_layer import fine_transformer
    from far_tpu_torch.ops.loftr_layer import loftr_layer
    from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol

    return {"K1_loftr_layer": loftr_layer,
            "K2_dual_softmax_rowcol": dual_softmax_rowcol,
            "K3_fine_transformer": fine_transformer,
            "K4_bilinear_dual_softmax": bilinear_dual_softmax}


TC_ROUTES = ("K1_loftr_layer", "K4_bilinear_dual_softmax")  # have launches_tc


def run_main_path(dev, card: str):
    """Phase 4: far_forward at 480x640, full width; returns the launches
    of each kernel and those of the tensor-core routes."""
    import torch

    from far_tpu_torch.pipeline import build_inference_fn, init_model
    from far_tpu_torch.tools.profile_forward import synthetic_batch
    from far_tpu_torch.utils.config import FARConfig, SolverOptions

    fns = counters()
    total = {k: 0 for k in fns}
    total_tc = {k: 0 for k in TC_ROUTES}
    for dtype in ("float32", "bfloat16"):
        cfg = FARConfig(solver=SolverOptions(minimal_solver="8pt"), dtype=dtype)
        per_req = {"K1_loftr_layer": 2 * len(cfg.coarse.layer_names)
                   + 4 * cfg.regress.num_loftr_layers,
                   "K2_dual_softmax_rowcol": 1, "K3_fine_transformer": 1,
                   "K4_bilinear_dual_softmax": 2}
        model = init_model(cfg, seed=0, device=dev)
        fn = build_inference_fn(model)
        batch = synthetic_batch(B_REQUEST, *cfg.image_size, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        fn(batch, generator=gen)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        for k, f in fns.items():
            f.launches = 0
            if k in TC_ROUTES:
                f.launches_tc = 0
        times = []
        outs = []
        for _ in range(N_REQUESTS):
            t0 = time.perf_counter()
            out = fn(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        counts = {k: f.launches for k, f in fns.items()}
        counts_tc = {k: fns[k].launches_tc for k in TC_ROUTES}
        for k, want in per_req.items():
            if counts[k] != want * N_REQUESTS:
                fail(f"{dtype}: {k} launched {counts[k]} times, expected "
                     f"{want * N_REQUESTS} ({want} per request)")
            total[k] += counts[k]
        for k in TC_ROUTES:  # bf16 requests go through the tensor-core routes
            want = per_req[k] * N_REQUESTS if dtype == "bfloat16" else 0
            if counts_tc[k] != want:
                fail(f"{dtype}: {k} tensor-core route launched {counts_tc[k]} "
                     f"times, expected {want}")
            total_tc[k] += counts_tc[k]
        for out in outs:
            for name in ("R", "t", "regressed_9d", "gating", "num_inliers", "E"):
                val = getattr(out, name)
                if not bool(torch.isfinite(val).all()):
                    fail(f"{dtype}: non-finite {name}")
            if tuple(out.R.shape) != (B_REQUEST, 3, 3) or \
                    tuple(out.matches.mkpts1_f.shape) != (B_REQUEST, cfg.match.max_matches, 2):
                fail(f"{dtype}: unexpected output shapes")
        ms = statistics.median(times)
        print(f"far_forward {dtype} B={B_REQUEST} 480x640: ms/request median "
              f"{ms:.2f} (runs {[round(t, 2) for t in times]}), "
              f"pairs/s {B_REQUEST * 1e3 / ms:.2f}, launches {counts}, "
              f"tensor-core route launches {counts_tc}, "
              f"valid matches {outs[-1].matches.valid.sum(-1).tolist()}, "
              f"inliers {outs[-1].num_inliers.tolist()} on {card}", flush=True)
        del model, fn, outs
        torch.cuda.empty_cache()
    return total, total_tc


def small_agreement(dev):
    """Phase 5: the matcher and the EMM features at a small width, all four
    kernels on the card against the plain versions on the CPU, with the
    same weights and images. (The solver is held to ground truth in
    phase 6: on a random-weight model's matches RANSAC chooses among
    degenerate near-ties, where f32 summation order decides.)"""
    import torch

    from far_tpu_torch.pipeline import init_model
    from far_tpu_torch.tools.profile_forward import synthetic_batch
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
    # f32 on both sides, TF32 off: summation order only
    bad = {k: v for k, v in rel.items() if v > 1e-3}
    if bad or expec_err > 5e-2:
        fail(f"kernel path disagrees with the plain path: {bad}, "
             f"expec_f {expec_err}")


def solver_guard(dev):
    """Phase 6: 16 synthetic scenes, 0.5 px noise, port's first-round solver."""
    import numpy as np
    import torch

    from far_tpu_torch.pipeline import make_solver_configs
    from far_tpu_torch.solvers.pose_estimation import estimate_pose
    from far_tpu_torch.utils.config import FARConfig, SolverOptions

    cfg = FARConfig(solver=SolverOptions(minimal_solver="8pt"))
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
    print(f"solver guard: 16 scenes, 0.5 px noise, 8-point: median rotation "
          f"error {med:.4f} deg (max {float(r_err.max()):.4f})", flush=True)
    if not med < 1.0:
        fail(f"solver median rotation error {med} deg >= 1 deg")


def main() -> int:
    t_start = time.perf_counter()
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
    launches, launches_tc = run_main_path(dev, card)
    small_agreement(dev)
    solver_guard(dev)

    src = {"K1_loftr_layer": ("loftr_layer.cu", "far_tpu/ops/loftr_layer.py:147"),
           "K2_dual_softmax_rowcol": ("matching_kernel.cu",
                                      "far_tpu/ops/matching_kernel.py:125"),
           "K3_fine_transformer": ("fine_layer.cu", "far_tpu/ops/fine_layer.py:246"),
           "K4_bilinear_dual_softmax": ("bilinear_attention.cu",
                                        "far_tpu/ops/bilinear_attention.py:171")}
    kernels = []
    for name, (cu, replaces) in src.items():
        if launches[name] == 0:
            fail(f"{name} was never launched on the main path")
        # the main path's default dtype is float32; K2 always takes bf16
        main = "bf16" if name.startswith("K2") else "f32"
        other = "f32" if main == "bf16" else "bf16"
        e = entries[name][main]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"far_tpu_torch/csrc/{cu}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "dtype": main, other: entries[name][other]})
        if name in launches_tc:
            kernels[-1]["launches_tc"] = launches_tc[name]
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
