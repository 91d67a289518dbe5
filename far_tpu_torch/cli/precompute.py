"""Matcher-precompute CLI.

Counterpart of ``far_tpu/cli/precompute.py`` (after crockwell/far:
mapfree_6dreg/etc/feature_matching_baselines/compute.py): the LoFTR
matcher (``FARLoFTR.match`` on the card) over a dataset's pairs, the
correspondences stored as an ``.npz`` store (``"<name0>-<name1>"``: (N, 4)
rows [x0, y0, x1, y1]) for ``PrecomputedMatching`` and the cached-match
training flows::

    python -m far_tpu_torch.cli.precompute --dataset synthetic \\
        --matcher loftr --out corr.npz

``--matcher sift`` and ``--matcher superglue`` are the JAX package's other
matchers; the port has neither (OpenCV is outside its imports, and
SuperPoint/SuperGlue are not ported), so they raise.
"""

from __future__ import annotations

import argparse

from far_tpu_torch.models.feature_matching import loftr_matcher_fn, precompute_matches
from far_tpu_torch.pipeline import init_model, resolve_device
from far_tpu_torch.utils.cli import add_common_args, apply_overrides, build_dataset, parse_hw
from far_tpu_torch.utils.config import FARConfig

_NOT_PORTED = {
    "sift": "--matcher sift needs OpenCV (cv2), which far_tpu_torch does not "
            "import (ROADMAP Queue 1 item 3.5)",
    "superglue": "--matcher superglue needs SuperPoint and SuperGlue, which "
                 "far_tpu_torch has not ported yet (ROADMAP Queue 1 item 3.5)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="far_tpu_torch matcher precompute")
    add_common_args(p)
    p.add_argument("--matcher", default="loftr",
                   choices=["loftr", "sift", "superglue"])
    p.add_argument("--out", default="correspondences.npz")
    p.add_argument("--max_pairs", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.matcher in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[args.matcher])
    dev = resolve_device(args.device)
    cfg = apply_overrides(FARConfig(image_size=parse_hw(args.image_size), dtype=args.dtype),
                          args.overrides)
    matcher_fn = loftr_matcher_fn(init_model(cfg, seed=args.seed, device=dev))
    dataset = build_dataset(args)
    n = len(dataset) if not args.max_pairs else min(args.max_pairs, len(dataset))
    store = precompute_matches(dataset, range(n), matcher_fn, args.out)
    print(f"wrote {len(store)} pair entries to {args.out}")
    return store


if __name__ == "__main__":
    main()
