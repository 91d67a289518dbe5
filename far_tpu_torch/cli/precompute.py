"""Matcher-precompute CLI.

Counterpart of ``far_tpu/cli/precompute.py`` (after crockwell/far:
mapfree_6dreg/etc/feature_matching_baselines/compute.py): the LoFTR
matcher (``FARLoFTR.match`` on the card) over a dataset's pairs, the
correspondences stored as an ``.npz`` store (``"<name0>-<name1>"``: (N, 4)
rows [x0, y0, x1, y1]) for ``PrecomputedMatching`` and the cached-match
training flows::

    python -m far_tpu_torch.cli.precompute --dataset synthetic \\
        --matcher loftr --out corr.npz

``--matcher sift`` runs rootSIFT with OpenCV on the host (no device);
``--matcher superglue`` runs SuperPoint + SuperGlue at their default
configs in ``--dtype`` on ``--device``, with seeded random weights (the
JAX package's CLI likewise inits them, from PRNGKey(0) and (1)).
"""

from __future__ import annotations

import argparse

from far_tpu_torch.models.feature_matching import (
    loftr_matcher_fn,
    precompute_matches,
    sift_matcher_fn,
    superglue_matcher_fn,
)
from far_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from far_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from far_tpu_torch.pipeline import init_model, resolve_device
from far_tpu_torch.utils.cli import add_common_args, apply_overrides, build_dataset, parse_hw
from far_tpu_torch.utils.config import FARConfig
from far_tpu_torch.utils.convert_weights import init_weights


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="far_tpu_torch matcher precompute")
    add_common_args(p)
    p.add_argument("--matcher", default="loftr",
                   choices=["loftr", "sift", "superglue"])
    p.add_argument("--out", default="correspondences.npz")
    p.add_argument("--max_pairs", type=int, default=0)
    return p.parse_args(argv)


def superglue_models(dtype: str, device):
    """SuperPoint and SuperGlue at their default configs, ``init_weights``
    seeds 0 and 1, in eval mode on ``device``."""
    sp = init_weights(SuperPoint(SuperPointConfig(dtype=dtype)), seed=0)
    sg = init_weights(SuperGlue(SuperGlueConfig(dtype=dtype)), seed=1)
    return sp.to(device).eval(), sg.to(device).eval()


def build_matcher_fn(args, cfg):
    if args.matcher == "sift":
        return sift_matcher_fn(cfg.match.max_matches)
    dev = resolve_device(args.device)
    if args.matcher == "superglue":
        return superglue_matcher_fn(*superglue_models(cfg.dtype, dev))
    return loftr_matcher_fn(init_model(cfg, seed=args.seed, device=dev))


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(FARConfig(image_size=parse_hw(args.image_size), dtype=args.dtype),
                          args.overrides)
    matcher_fn = build_matcher_fn(args, cfg)
    dataset = build_dataset(args)
    n = len(dataset) if not args.max_pairs else min(args.max_pairs, len(dataset))
    store = precompute_matches(dataset, range(n), matcher_fn, args.out)
    print(f"wrote {len(store)} pair entries to {args.out}")
    return store


if __name__ == "__main__":
    main()
