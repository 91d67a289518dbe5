"""Single-pair pose demo.

Counterpart of ``far_tpu/cli/demo.py`` (after crockwell/far:
mp3d_loftr/demo.py and mapfree_6dreg/demo.py): two images (or a
synthetic pair) through the full FAR loop once on the card, the
predicted [R|t] printed::

    python -m far_tpu_torch.cli.demo --image0 a.png --image1 b.png \\
        --fx 517.97 --fy 517.97 --cx 320 --cy 240
    python -m far_tpu_torch.cli.demo --synthetic
    # map-free family (metric 6DReg regressor + MoE, 2-round prior loop;
    # per-image intrinsics like the reference's --k0/--k1):
    python -m far_tpu_torch.cli.demo --mapfree --image0 a.jpg --image1 b.jpg \\
        --k0 1672 1672 540 960 --k1 1672 1672 540 960 --ckpt_dir <dir>

``--ckpt_dir`` reads the port's checkpoints: a trainer's state (the
model under ``"model"``) for FAR, ``{"matcher", "regressor"}`` state
dicts for ``--mapfree``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from far_tpu_torch.cli.evaluate import _restore_variables
from far_tpu_torch.data.io import read_gray
from far_tpu_torch.data.synthetic import SyntheticPairDataset
from far_tpu_torch.models.sixdreg import SixDRegConfig
from far_tpu_torch.pipeline import (
    build_inference_fn,
    init_model,
    init_sixdreg,
    mapfree_forward,
    resolve_device,
)
from far_tpu_torch.train.checkpoint import CheckpointManager
from far_tpu_torch.types import PairBatch
from far_tpu_torch.utils.cli import add_device_arg, apply_overrides, parse_hw
from far_tpu_torch.utils.config import FARConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="far_tpu_torch demo")
    p.add_argument("--image0")
    p.add_argument("--image1")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image_size", default="480x640")
    p.add_argument("--fx", type=float, default=517.97)
    p.add_argument("--fy", type=float, default=517.97)
    p.add_argument("--cx", type=float, default=320.0)
    p.add_argument("--cy", type=float, default=240.0)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--k0", type=float, nargs=4, default=None,
                   metavar=("FX", "FY", "CX", "CY"),
                   help="intrinsics of image0 (defaults to --fx/--fy/...)")
    p.add_argument("--k1", type=float, nargs=4, default=None,
                   metavar=("FX", "FY", "CX", "CY"),
                   help="intrinsics of image1 (defaults to --k0)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mapfree", action="store_true",
                   help="use the map-free 6DReg pipeline (metric t)")
    p.add_argument("--reg_size", default="368x272",
                   help="HxW of the map-free regressor input")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_arg(p)
    return p.parse_args(argv)


def _pair_batch(img0, img1, K0, K1, dev) -> PairBatch:
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(dev)
    return PairBatch(image0=t(img0), image1=t(img1), K0=t(K0), K1=t(K1))


def _reg_image(img: np.ndarray, rh: int, rw: int, dev) -> torch.Tensor:
    """(H, W, 1 or 3) in [0, 1] -> (1, rh, rw, 3) at the regressor's size:
    antialiased bilinear, as ``jax.image.resize``; gray tiled to RGB."""
    x = torch.from_numpy(np.asarray(img, np.float32)).permute(2, 0, 1)[None].to(dev)
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).expand(-1, -1, -1, 3).contiguous()


def run_mapfree(args, img0, img1, K, gt, dev: torch.device):
    """Map-free demo path (reference mapfree_6dreg/demo.py:51-126): a
    ``FARConfig(regress_rt=False)`` matcher, ``SixDRegConfig`` at
    ``--reg_size``, ``mapfree_forward``."""
    H, W = parse_hw(args.image_size)
    rh, rw = parse_hw(args.reg_size)
    mcfg = apply_overrides(
        FARConfig(image_size=(H, W), dtype=args.dtype, regress_rt=False), args.overrides)
    matcher = init_model(mcfg, seed=0, device=dev)
    reg = init_sixdreg(SixDRegConfig(image_hw=(rh, rw), dtype=args.dtype), seed=1,
                       device=dev)
    if args.ckpt_dir:
        # the two-model layout the submission CLI reads
        state = CheckpointManager(args.ckpt_dir).restore()
        matcher.load_state_dict(state["matcher"])
        reg.load_state_dict(state["regressor"])

    K0, K1 = K
    gray = lambda im: im if im.shape[-1] == 1 else im.mean(-1, keepdims=True)
    batch = _pair_batch(gray(img0), gray(img1), K0, K1, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        out = mapfree_forward(
            matcher, reg, batch, _reg_image(img0, rh, rw, dev), _reg_image(img1, rh, rw, dev),
            generator=gen)
    rt = np.concatenate([out.R[0].float().cpu().numpy(),
                         out.t[0].float().cpu().numpy()[:, None]], -1)
    np.set_printoptions(precision=4, suppress=True)
    print("predicted metric [R|t] (map-free 6DReg):")
    print(rt)
    print(f"solver inliers: {float(out.num_inliers[0]):.0f}")
    if gt is not None:
        print("ground truth [R|t]:")
        print(gt[:3])
    return rt


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W = parse_hw(args.image_size)
    cfg = apply_overrides(FARConfig(image_size=(H, W), dtype=args.dtype), args.overrides)

    if args.synthetic or not args.image0:
        s = SyntheticPairDataset(n=1, hw=(H, W))[0]
        img0, img1 = s["image0"], s["image1"]
        K0 = K1 = s["K0"]
        gt = s["T_0to1"]
    else:
        img0 = read_gray(args.image0, (W, H))
        img1 = read_gray(args.image1, (W, H))

        def mk_k(four):
            fx, fy, cx, cy = four
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

        K0 = mk_k(args.k0 if args.k0 else (args.fx, args.fy, args.cx, args.cy))
        K1 = mk_k(args.k1) if args.k1 else K0
        gt = None

    if args.mapfree:
        return run_mapfree(args, img0, img1, (K0, K1), gt, dev)

    model = init_model(cfg, seed=0, device=dev)
    if args.ckpt_dir:
        _restore_variables(args.ckpt_dir, model)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = build_inference_fn(model)(_pair_batch(img0, img1, K0, K1, dev), generator=gen)
    rt = np.concatenate([out.R[0].float().cpu().numpy(),
                         out.t[0].float().cpu().numpy()[:, None]], -1)
    np.set_printoptions(precision=4, suppress=True)
    print("predicted [R|t]:")
    print(rt)
    print(f"matches: {int(out.matches.valid.sum())}, "
          f"inliers: {float(out.num_inliers[0]):.0f}, "
          f"solved: {bool(out.success[0])}")
    if gt is not None:
        print("ground truth [R|t]:")
        print(gt[:3])
    return rt


if __name__ == "__main__":
    main()
