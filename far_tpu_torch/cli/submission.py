"""Map-free submission CLI.

Counterpart of ``far_tpu/cli/submission.py`` (after crockwell/far:
mapfree_6dreg/submission.py): the map-free pipeline on the card over a
split, one pair at a time (the matcher with ``regress_rt=False`` at
``--matcher_hw``, ``SixDRegConfig`` at ``--reg_hw``, ``mapfree_forward``
through ``build_mapfree_fn``: one CUDA graph replay a pair on a card, the
eager request with ``--device cpu``),
written as the official submission zip: one ``pose_<scene>.txt`` a scene,
world-to-cam quaternion and translation with the inlier count as
confidence::

    python -m far_tpu_torch.cli.submission --data_dir <mapfree_root> \\
        --split val --out submission.zip

``--ckpt_dir`` restores ``{"matcher", "regressor"}`` state dicts from one
port checkpoint; ``--set`` overrides the matcher's ``FARConfig``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from far_tpu_torch.data import MapFreeDataset
from far_tpu_torch.eval.submission import SubmissionWriter
from far_tpu_torch.models.sixdreg import SixDRegConfig
from far_tpu_torch.pipeline import build_mapfree_fn, init_model, init_sixdreg, resolve_device
from far_tpu_torch.train.checkpoint import CheckpointManager
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.cli import add_device_arg, apply_overrides, parse_hw
from far_tpu_torch.utils.config import FARConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="far_tpu_torch map-free submission")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--out", default="submission.zip")
    p.add_argument("--matcher_hw", default="720x544")
    p.add_argument("--reg_hw", default="368x272")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--max_pairs", type=int, default=0)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="matcher config override a.b.c=value (repeatable)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mh, mw = parse_hw(args.matcher_hw)
    rh, rw = parse_hw(args.reg_hw)
    matcher_cfg = apply_overrides(
        FARConfig(image_size=(mh, mw), dtype=args.dtype, regress_rt=False), args.overrides)
    matcher = init_model(matcher_cfg, seed=0, device=dev)
    reg = init_sixdreg(SixDRegConfig(image_hw=(rh, rw), dtype=args.dtype), seed=1, device=dev)
    if args.ckpt_dir:
        state = CheckpointManager(args.ckpt_dir).restore()
        matcher.load_state_dict(state["matcher"])
        reg.load_state_dict(state["regressor"])

    dataset = MapFreeDataset(args.data_dir, split=args.split,
                             resize_wh=(mw, mh), reg_resize_wh=(rw, rh))
    writer = SubmissionWriter()
    fn = build_mapfree_fn(matcher, reg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = lambda s, k: torch.from_numpy(np.asarray(s[k], np.float32))[None].to(dev)
    for i in range(len(dataset)):
        if args.max_pairs and i >= args.max_pairs:
            break
        s = dataset[i]
        batch = PairBatch(image0=t(s, "image0"), image1=t(s, "image1"),
                          K0=t(s, "K0"), K1=t(s, "K1"))
        out = fn(batch, t(s, "image0_reg"), t(s, "image1_reg"), generator=gen)
        writer.add_pose_matrix(
            s["scene"], s["pair_names"][1], out.R[0].float().cpu().numpy(),
            out.t[0].float().cpu().numpy(), confidence=float(out.num_inliers[0]))
    writer.write(args.out)
    print(f"wrote {args.out}")
    return writer


if __name__ == "__main__":
    main()
