"""Training CLI for the three model families, on one card or data-parallel on N.

Counterpart of ``far_tpu/cli/train.py`` (after crockwell/far:
mp3d_loftr/train.py, interiornetStreetlearn_8ptVit/train.py and
mapfree_6dreg/train.py): the port's stateful trainers
(``Trainer(cfg).step(batch)``, ``ViTEssTrainer``, ``SixDRegTrainer``)
with warm-up, the non-finite skip, scene-balanced sampling, checkpoints
every ``--ckpt_every`` steps, ``--resume``, validation during training
with the best checkpoint kept by ``rot mean err`` (lightning_loftr.py:
266-323, train.py:314-324), the 8-point ViT's subepoch scheme and JSONL
logging.

Under ``torch.distributed.run`` it is the JAX package's run over a mesh,
one process a card: ``--batch_size`` is the global batch (W must divide
it), each rank loads its contiguous rows of every global batch of the
same index stream, the trainers' DDP steps give the global batch's
metrics, rank 0 logs and writes the checkpoints, and every rank reads the
same validation table, so all decide alike on the best checkpoint::

    python -m far_tpu_torch.cli.train --dataset synthetic --steps 20
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m far_tpu_torch.cli.train --dataset synthetic --batch_size 8
    python -m far_tpu_torch.cli.train --model vitess --dataset synthetic ...
    python -m far_tpu_torch.cli.train --model sixdreg --dataset synthetic \\
        --image_size 368x272 ...
    python -m far_tpu_torch.cli.train --preset interiornet --dataset synthetic ...
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
import time

import numpy as np
import torch

from far_tpu_torch.configs import PRESETS
from far_tpu_torch.data import Loader, scene_balance_indices
from far_tpu_torch.data.datasets import CachedCorrespondenceDataset
from far_tpu_torch.data.loader import to_device
from far_tpu_torch.data.sampler import random_indices
from far_tpu_torch.data.synthetic import (
    GTCorrespondenceDataset,
    SolverPoseDataset,
    SyntheticPairDataset,
)
from far_tpu_torch.models.sixdreg import SixDRegConfig
from far_tpu_torch.models.vitess import ViTEssConfig
from far_tpu_torch.parallel.comm import (
    group_summary,
    init_distributed,
    process_count,
    process_index,
)
from far_tpu_torch.pipeline import resolve_device
from far_tpu_torch.train.checkpoint import CheckpointManager
from far_tpu_torch.train.family_trainers import (
    SixDRegTrainer,
    ViTEssTrainer,
    collate_sixdreg,
    collate_vitess,
)
from far_tpu_torch.train.optim import OptimConfig
from far_tpu_torch.train.trainer import Trainer
from far_tpu_torch.train.validation import validate_far
from far_tpu_torch.utils.cli import add_common_args, apply_overrides, build_dataset, parse_hw
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description="far_tpu_torch trainer")
    add_common_args(p)
    p.add_argument("--model", default="far",
                   choices=["far", "vitess", "sixdreg"])
    p.add_argument("--preset", default=None,
                   help="configs.py preset name (matterport/interiornet/"
                        "streetlearn/mapfree); sets model family, model "
                        "config and optimizer defaults")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=None,
                   help="default: preset lr or 1e-4")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--scheduler", default="none")
    p.add_argument("--sampler", default="scene_balance",
                   choices=["scene_balance", "random", "sequential"])
    p.add_argument("--subepochs", type=int, default=0,
                   help="split the index list into N shards and cycle "
                        "N-1 train shards + 1 val shard per epoch (the "
                        "8ptVit reference's subepoch scheme, N=11; "
                        "0 = plain per-epoch pass)")
    p.add_argument("--n_samples_per_scene", type=int, default=200)
    p.add_argument("--ckpt_dir", default=os.path.join(tmp, "far_tpu_torch_ckpt"))
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_dir", default=os.path.join(tmp, "far_tpu_torch_logs"))
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    # validation during training (far family; reference val loop)
    p.add_argument("--val_every", type=int, default=0,
                   help="run a val pass every N steps (0 = off)")
    p.add_argument("--val_n", type=int, default=16,
                   help="synthetic val-set size")
    p.add_argument("--val_max_batches", type=int, default=0)
    # vitess family
    p.add_argument("--w_tr", type=float, default=10.0)
    p.add_argument("--w_rot", type=float, default=10.0)
    p.add_argument("--solver_pose_npz", default=None,
                   help="cached solver poses for FAR-gated ViTEss training "
                        "(npz with 'rt' (N,3,4) + 'num_corr' (N,)); "
                        "default: GT+noise synthetic solver")
    # sixdreg family
    p.add_argument("--rot_loss", default="rot_6d_loss")
    p.add_argument("--trans_loss", default="trans_unnormalized_loss")
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--corr_max_matches", type=int, default=512)
    p.add_argument("--corr_noise_pix", type=float, default=1.0)
    p.add_argument("--corr_outlier_pct", type=float, default=0.1)
    p.add_argument("--corr_npz", default=None,
                   help="precomputed matcher shard (far_tpu_torch.cli.precompute)"
                        " instead of GT-projected correspondences")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly for the run: the "
                        "backward op that makes a NaN raises, naming the "
                        "forward op (mapfree_6dreg/train.py:22). Turns the "
                        "optimizer's non-finite skip off, so the NaN is "
                        "raised, not skipped")
    return p.parse_args(argv)


def _resolve_family(args):
    """(family, model_cfg, optim_cfg) from --preset / --model / --set."""
    optim = None
    if args.preset:
        preset = PRESETS[args.preset]()
        cfg = preset.model
        optim = preset.optim
        family = {"FARConfig": "far", "ViTEssConfig": "vitess",
                  "SixDRegConfig": "sixdreg"}[type(cfg).__name__]
    else:
        family = args.model
        if family == "far":
            cfg = FARConfig(image_size=parse_hw(args.image_size), dtype=args.dtype)
        elif family == "vitess":
            cfg = ViTEssConfig(dtype=args.dtype)
        else:
            cfg = SixDRegConfig(dtype=args.dtype)
    cfg = apply_overrides(cfg, args.overrides)

    if optim is None or args.lr is not None or args.scheduler != "none":
        optim = OptimConfig(
            lr=args.lr if args.lr is not None else 1e-4,
            warmup_steps=args.warmup_steps, scheduler=args.scheduler,
        )
    return family, cfg, optim


def _subepoch_indices(indices, subepochs, sub):
    """Shard `sub` of the reference's subepoch split: the index list is
    cut into `subepochs` equal shards; 0..subepochs-2 are train shards,
    the last is the val shard (streetlearn.py:69-71, train.py:227-247)."""
    n = len(indices) // subepochs
    return indices[sub * n: (sub + 1) * n]


def _rank_rows(indices, batch_size: int):
    """(this rank's indices, its rows a batch): its contiguous rows of each
    global batch of ``indices``, as the JAX package's ``P("data")``
    places them; the global tail is dropped, as the loader drops it."""
    w = process_count()
    if batch_size % w:
        raise ValueError(f"--batch_size {batch_size} (the global batch) does not split "
                         f"over {w} processes")
    rows = batch_size // w
    indices = np.asarray(indices)[: len(indices) // batch_size * batch_size]
    return indices.reshape(-1, w, rows)[:, process_index()].reshape(-1), rows


def _build_trainer_and_loaderfn(args, family, cfg, optim, dev):
    """(trainer, make_loader(sub=None) -> iterable of batches on ``dev``)."""
    dataset = build_dataset(args)

    if args.sampler == "scene_balance" and hasattr(dataset, "scene_lengths"):
        indices = scene_balance_indices(
            dataset.scene_lengths, args.n_samples_per_scene, args.seed)
    elif args.sampler == "random":
        indices = random_indices(len(dataset), seed=args.seed)
    else:
        indices = np.arange(len(dataset))

    collate = None
    if family == "far":
        trainer = Trainer(cfg, optim, device=dev).init(seed=args.seed)
    elif family == "vitess":
        if cfg.use_loftr_gating:
            # gated training needs a per-pair solver pose (the reference
            # loads cached LoFTR preds, train.py:96-117)
            dataset = SolverPoseDataset(dataset, args.solver_pose_npz, seed=args.seed)
        trainer = ViTEssTrainer(cfg, optim, w_tr=args.w_tr, w_rot=args.w_rot,
                                device=dev).init(seed=args.seed)
        collate = functools.partial(collate_vitess, device=dev)
    else:
        # sixdreg: the base dataset with a correspondence source
        if args.corr_npz:
            hw = np.asarray(dataset[0]["image0"]).shape[:2]
            dataset = CachedCorrespondenceDataset(
                dataset, args.corr_npz, max_matches=args.corr_max_matches,
                image_hw=hw, keep_images=True)
        else:
            dataset = GTCorrespondenceDataset(
                dataset, max_matches=args.corr_max_matches,
                noise_pix=args.corr_noise_pix,
                outlier_pct=args.corr_outlier_pct, seed=args.seed)
        trainer = SixDRegTrainer(cfg, optim, rot_loss=args.rot_loss,
                                 trans_loss=args.trans_loss, lam=args.lam,
                                 device=dev).init(seed=args.seed)
        collate = functools.partial(collate_sixdreg, device=dev)

    def make_loader(sub=None):
        idx = indices if sub is None else _subepoch_indices(indices, args.subepochs, sub)
        idx, rows = _rank_rows(idx, args.batch_size)
        if collate is None:
            return (to_device(b, dev) for b in Loader(dataset, idx, rows))
        return Loader(dataset, idx, rows, collate=collate)

    return trainer, make_loader


def main(argv=None):
    args = parse_args(argv)
    anomaly = torch.is_anomaly_enabled()
    try:
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        return _train(args)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)


def _train(args):
    init_distributed(device=args.device)
    dev = resolve_device(args.device)
    summary = group_summary()
    if summary and process_index() == 0:
        print(summary)
    family, cfg, optim = _resolve_family(args)
    if args.debug_nans:
        # surface the NaN instead of skipping the update
        optim = dataclasses.replace(optim, skip_nonfinite=False)

    # canonical-LR linear scaling by world size (reference train.py:199-211)
    if args.scheduler != "none" and family == "far":
        optim = dataclasses.replace(
            optim, lr=optim.lr * process_count() * args.batch_size / 64.0)

    trainer, make_loader = _build_trainer_and_loaderfn(args, family, cfg, optim, dev)

    mgr = CheckpointManager(args.ckpt_dir)
    if args.resume and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore())
        if process_index() == 0:
            print(f"resumed from step {mgr.latest_step()}")

    logger = MetricLogger(args.log_dir, "train", rank=process_index(),
                          print_every=args.log_every)

    # validation during training (far family; the reference's val loop)
    val_dataset = best_mgr = None
    best_rot_err = float("inf")
    if args.val_every and family == "far":
        val_dataset = SyntheticPairDataset(n=args.val_n, hw=cfg.image_size,
                                           seed=args.seed + 7777)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step = trainer.step_count
    t0 = time.time()
    metrics = {"loss": np.nan}
    subepoch = 0
    while step < args.steps:
        if args.subepochs > 1:
            loader = make_loader(subepoch % (args.subepochs - 1))
        else:
            loader = make_loader()
        for batch in loader:
            if step >= args.steps:
                break
            metrics = trainer.step(batch, generator=gen)
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                scalars = dict(metrics)
                scalars["steps_per_sec"] = step / (time.time() - t0)
                logger.log(step, scalars)
            if val_dataset is not None and (step % args.val_every == 0
                                            or step == args.steps):
                trainer.model.eval()
                try:
                    table = validate_far(
                        trainer.model, val_dataset, args.batch_size,
                        max_matches=cfg.match.max_matches,
                        max_batches=args.val_max_batches, generator=gen,
                        fig_dir=f"{args.log_dir}/figures", step=step)
                finally:
                    trainer.model.train()
                logger.log(step, {f"val/{k}": float(v) for k, v in table.items()})
                # checkpoint-on-monitor (reference train.py:314-324)
                if table["rot mean err"] < best_rot_err:
                    best_rot_err = table["rot mean err"]
                    if best_mgr is None:
                        best_mgr = CheckpointManager(f"{args.ckpt_dir}/best", max_to_keep=1)
                    best_mgr.save(step, trainer.state_dict())
            if step % args.ckpt_every == 0 or step == args.steps:
                mgr.save(step, trainer.state_dict())
        if args.subepochs > 1:
            subepoch += 1
            if (subepoch % (args.subepochs - 1) == 0
                    and hasattr(trainer, "eval_step") and step < args.steps):
                # reference: subepoch 10 is a full val-shard pass
                # (train.py:229-235); log the shard-mean loss metrics
                sums, count = {}, 0
                for vbatch in make_loader(args.subepochs - 1):
                    for k, v in trainer.eval_step(vbatch, generator=gen).items():
                        sums[k] = sums.get(k, 0.0) + v
                    count += 1
                if count:
                    logger.log(step, {f"val/{k}": v / count for k, v in sums.items()})
    logger.close()
    if process_index() == 0:
        print(f"done: {step} steps, final loss {float(metrics['loss']):.4f}")
    return trainer


if __name__ == "__main__":
    main()
