"""Evaluation CLI.

Counterpart of ``far_tpu/cli/evaluate.py`` (after crockwell/far:
mp3d_loftr/test.py and scripts/eval_*.sh): the full FAR loop over an
evaluation split on the card, the per-pair metrics gathered across
processes (the identity in one), the Matterport (or InteriorNet /
StreetLearn) table printed, and the reference's files written:
``results_<solver>.txt``, ``results_<solver>_solverpose.txt``,
``error_cdf.npy``, ``pred_R.npy`` and ``pred_t.npy``. ``--model vitess``
evaluates the 8-point ViT instead (``results.txt``, ``pred_R.npy``)::

    python -m far_tpu_torch.cli.evaluate --dataset synthetic
    python -m far_tpu_torch.cli.evaluate --dataset synthetic \\
        --image_size 64x64 --dtype float32 --device cpu --set ...

``--ckpt_dir`` restores the weights from the port's checkpoints
(``train/checkpoint.py``, ``torch.save``); a JAX orbax directory is not
read. Under ``python -m torch.distributed.run --nproc_per_node N`` each
rank evaluates its strided shard of the split, the pairs are gathered
to every rank and rank 0 prints and writes the files.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from far_tpu_torch.data.loader import Loader
from far_tpu_torch.data.sampler import sequential_indices
from far_tpu_torch.data.synthetic import SolverPoseDataset
from far_tpu_torch.eval.metrics import (
    aggregate_metrics,
    aggregate_metrics_interiornet_streetlearn,
    relative_pose_error,
)
from far_tpu_torch.geometry.rotations import rotation_6d_to_matrix
from far_tpu_torch.models.vitess import ViTEssConfig
from far_tpu_torch.parallel.comm import (
    group_summary,
    init_distributed,
    process_count,
    process_index,
)
from far_tpu_torch.pipeline import init_model, init_vitess, resolve_device
from far_tpu_torch.train.checkpoint import CheckpointManager, surgical_load
from far_tpu_torch.train.family_trainers import collate_vitess
from far_tpu_torch.train.validation import accumulate_far, far_batches, gather_pair_metrics
from far_tpu_torch.utils.cli import (
    add_common_args,
    apply_overrides,
    build_dataset,
    parse_hw,
)
from far_tpu_torch.utils.config import FARConfig


def _check_batch_intrinsics(batch, cfg: FARConfig = None) -> None:
    """Host-side guard mirroring the reference's per-batch intrinsics
    assertion (vision_transformer.py:115-127), run on each batch as it
    comes out of the forward (its intrinsics read back to the host): the
    epipolar positional basis is built once per config, so both frames
    must share intrinsics with the principal point at the image center —
    AND those intrinsics must be the ones the config's basis was built
    for.

    The basis normalization depends only on the unit-free ratios fx/cx
    and fy/cy (regressor.epipolar_positional_basis), so the batch pixel K
    is compared against the config's grid-unit constants directly.
    Tolerance is 15%: the production mp3d constants divide fx by 9 where
    the true stride is 8 (a trained-in convention, an 11% deviation that
    must pass), while a genuinely different camera (e.g. fx/cx 1.0 vs
    Matterport's 1.6) deviates far beyond it and raises instead of
    silently corrupting EMM features.
    """
    K0 = torch.as_tensor(batch.K0).cpu().numpy()
    K1 = torch.as_tensor(batch.K1).cpu().numpy()
    if not np.allclose(K0, K1, rtol=1e-3):
        raise ValueError(
            "per-pair intrinsics differ between frames; the epipolar "
            "positional basis (RegressConfig.grid_fx/grid_fy) assumes "
            "shared intrinsics")
    if cfg is None:
        return
    gh, gw = cfg.coarse_hw
    cfg_fx_ratio = cfg.regress.grid_fx / (gw / 2.0)
    cfg_fy_ratio = cfg.regress.grid_fy / (gh / 2.0)
    fx_ratio = K0[:, 0, 0] / np.maximum(K0[:, 0, 2], 1e-6)
    fy_ratio = K0[:, 1, 1] / np.maximum(K0[:, 1, 2], 1e-6)
    tol = 0.15
    bad_fx = np.abs(fx_ratio / cfg_fx_ratio - 1.0) > tol
    bad_fy = np.abs(fy_ratio / cfg_fy_ratio - 1.0) > tol
    if np.any(bad_fx) or np.any(bad_fy):
        raise ValueError(
            f"batch intrinsics (fx/cx={float(fx_ratio[0]):.3f}, "
            f"fy/cy={float(fy_ratio[0]):.3f}) do not match the epipolar "
            f"basis constants (config fx/cx={cfg_fx_ratio:.3f}, "
            f"fy/cy={cfg_fy_ratio:.3f}); set "
            "--set regress.grid_fx/grid_fy for this camera or the EMM "
            "features will be silently wrong")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="far_tpu_torch evaluator")
    add_common_args(p)
    p.add_argument("--model", default="far", choices=["far", "vitess"],
                   help="far = full FAR loop (mp3d_loftr/test.py); vitess ="
                        " 8pt-ViT geodesic eval (interiornetStreetlearn_"
                        "8ptVit/test_streetlearn_interiornet.py)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--out_dir",
                   default=os.path.join(tempfile.gettempdir(), "far_tpu_torch_eval"))
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--agg", default="matterport",
                   choices=["matterport", "interiornet_streetlearn"])
    p.add_argument("--solver_pose_npz", default=None,
                   help="[vitess] cached solver poses for the FAR-gated "
                        "model (npz with 'rt' (N,3,4) + 'num_corr' (N,))")
    return p.parse_args(argv)


def far_config(args) -> FARConfig:
    """``FARConfig`` at ``--image_size`` and ``--dtype`` with the ``--set``
    overrides."""
    return apply_overrides(FARConfig(image_size=parse_hw(args.image_size), dtype=args.dtype),
                           args.overrides)


def _restore_variables(ckpt_dir, model: torch.nn.Module) -> torch.nn.Module:
    """Load the model's weights out of the newest training checkpoint in
    ``ckpt_dir`` (a trainer's state: the model's state dict under
    ``"model"``, beside the optimizer's). Every parameter must be there
    with its shape; a missing or reshaped buffer (BatchNorm statistics)
    keeps the model's own."""
    mgr = CheckpointManager(ckpt_dir)
    raw = mgr.restore()
    merged, skipped = surgical_load(raw["model"], model.state_dict(), verbose=False)
    params = {name for name, _ in model.named_parameters()}
    bad = [k for k in skipped if k in params]
    if bad:
        raise ValueError(f"checkpoint params do not match the model config: {bad[:8]}")
    model.load_state_dict(merged)
    return model


def _write_table(path: Path, table) -> None:
    path.write_text("\n".join(f"{k}: {v}" for k, v in table.items()) + "\n")


def evaluate_far(model, dataset, args, generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                 prior_pcl: Optional[torch.Tensor] = None):
    """The FAR evaluation loop of ``main`` over ``dataset`` with ``model``
    (in eval mode, on its device): batches of ``args.batch_size`` (at most
    ``args.max_batches``), the tables of the fused and the solver's poses
    by ``args.agg``, the files written into ``args.out_dir``. Returns the
    fused table.

    Args:
        generator: the RANSAC sampler's generator, on the model's device.
        uniforms: optional sampler draws in place of the generator's: for
            each batch the per-round list that ``far_forward`` takes.
        prior_pcl: optional probe cloud of the prior rounds.
    """
    cfg = model.config
    acc = {k: [] for k in ("identifiers", "R_errs", "t_errs", "t_errs_abs",
                           "successful_fits", "epi_errs", "gt_R", "pred_R",
                           "pred_t", "solver_R_errs", "solver_t_errs",
                           "solver_t_errs_abs")}
    for batch, meta, out in far_batches(model, dataset, args.batch_size, args.max_batches,
                                        generator, uniforms, prior_pcl):
        # synthetic smoke data invents its own K (0.8*max(H,W) focal);
        # the basis-constants check applies to real-camera datasets
        _check_batch_intrinsics(batch, None if args.dataset == "synthetic" else cfg)
        accumulate_far(acc, out, batch, meta, cfg.match.max_matches)
        R, t = out.R.float().cpu().numpy(), out.t.float().cpu().numpy()
        sR = out.solver_rt[..., :3, :3].float().cpu().numpy()
        st = out.solver_rt[..., :3, 3].float().cpu().numpy()
        T = batch.T_0to1.cpu().numpy()
        for b in range(R.shape[0]):
            st_err, sr_err, st_abs = relative_pose_error(T[b], sR[b], st[b])
            acc["solver_R_errs"].append(sr_err)
            acc["solver_t_errs"].append(st_err)
            acc["solver_t_errs_abs"].append(st_abs)
            acc["gt_R"].append(T[b][:3, :3])
            acc["pred_R"].append(R[b])
            acc["pred_t"].append(t[b])
    acc = gather_pair_metrics(acc)

    agg = aggregate_metrics if args.agg == "matterport" \
        else aggregate_metrics_interiornet_streetlearn
    table = agg(acc)
    # the solver pose's table (the reference re-runs compute_pose_errors
    # on the RANSAC pose): it makes the MoE gate's quality visible
    solver_table = agg({**acc, "R_errs": acc["solver_R_errs"],
                        "t_errs": acc["solver_t_errs"],
                        "t_errs_abs": acc["solver_t_errs_abs"]})
    if process_index() != 0:
        return table

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    solver = cfg.solver.solver
    _write_table(out_dir / f"results_{solver}.txt", table)
    _write_table(out_dir / f"results_{solver}_solverpose.txt", solver_table)
    np.save(out_dir / "error_cdf.npy", np.sort(np.maximum(acc["R_errs"], acc["t_errs"])))
    np.save(out_dir / "pred_R.npy", np.asarray(acc["pred_R"]))
    np.save(out_dir / "pred_t.npy", np.asarray(acc["pred_t"]))
    print(json.dumps({"fused": table, "solver": solver_table}, indent=2, default=float))
    return table


def main(argv=None):
    args = parse_args(argv)
    init_distributed(device=args.device)
    dev = resolve_device(args.device)
    summary = group_summary()
    if summary and process_index() == 0:
        print(summary)
    if args.model == "vitess":
        return _eval_vitess(args, dev)
    model = init_model(far_config(args), seed=args.seed, device=dev)
    if args.ckpt_dir:
        _restore_variables(args.ckpt_dir, model)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return evaluate_far(model, build_dataset(args), args, generator=gen)


def _eval_vitess(args, dev: torch.device):
    """8pt-ViT geodesic eval (reference interiornetStreetlearn_8ptVit/
    test_streetlearn_interiornet.py:65-116): ViTEss, gated by cached
    solver poses when its config says so (the reference's cached-LoFTR
    scheme, train.py:96-117), over the sorted evaluation pairs; the
    large/small-overlap geodesic rotation table printed and written to
    ``results.txt``, with ``pred_R.npy``."""
    cfg = apply_overrides(ViTEssConfig(dtype=args.dtype), args.overrides)
    model = init_vitess(cfg, seed=args.seed, device=dev)
    if args.ckpt_dir:
        _restore_variables(args.ckpt_dir, model)

    dataset = build_dataset(args)
    if cfg.use_loftr_gating:
        dataset = SolverPoseDataset(dataset, args.solver_pose_npz, seed=args.seed)
    idx = sequential_indices(len(dataset), rank=process_index(), world_size=process_count())
    loader = Loader(dataset, idx, args.batch_size,
                    collate=functools.partial(collate_vitess, device=dev), keep_meta=True)

    acc = {k: [] for k in ("identifiers", "gt_R", "pred_R", "successful_fits", "epi_errs")}
    for bi, (batch, meta) in enumerate(loader):
        if args.max_batches and bi >= args.max_batches:
            break
        with torch.inference_mode():
            _, R_col, pred_9d, _ = model(batch.images, batch.solver_rt, batch.solver_num_corr)
            # production eval decodes the (un-normalized) 6d prediction
            # with the ROW convention (test_streetlearn_interiornet.py:
            # 278-283, losson6d with use_normalized_6d), not the model's
            # column-convention matrix, which the reference uses only when
            # losson6d is off
            if cfg.use_normalized_6d:
                un = pred_9d.float() * model.pose_std + model.pose_mean
                R = rotation_6d_to_matrix(un[..., 3:])
            else:
                R = R_col
        R = R.float().cpu().numpy()
        T = batch.T_0to1.cpu().numpy()
        for b in range(R.shape[0]):
            acc["identifiers"].append("#".join(meta["pair_names"][b]))
            acc["gt_R"].append(T[b][:3, :3])
            acc["pred_R"].append(R[b])
            # regression always gives a pose; the fits column tracks the
            # solver's health in the FAR family only
            acc["successful_fits"].append(1.0)
            acc["epi_errs"].append(np.full(1, np.nan, np.float32))
    acc = gather_pair_metrics(acc)

    table = aggregate_metrics_interiornet_streetlearn(acc)
    if process_index() != 0:
        return table
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    _write_table(out_dir / "results.txt", table)
    np.save(out_dir / "pred_R.npy", np.asarray(acc["pred_R"]))
    print(json.dumps(table, indent=2, default=float))
    return table


if __name__ == "__main__":
    main()
