"""Config overrides, the dataset factory and the flags the CLIs share.

The port's copy of ``far_tpu/utils/cli.py``. Configs are frozen
dataclasses (``utils/config.py``, ``models/vitess.py``,
``models/sixdreg.py``); an override is a dotted path applied with
``dataclasses.replace``::

    --set match.max_matches=512 --set solver.solver=prior_ransac

An unknown leaf raises ``dataclasses.replace``'s ``TypeError``.
``--device`` (default ``cuda``) is where the entry point runs; without a
card ``cuda`` raises (``pipeline.resolve_device``), and only ``cpu``
runs the plain versions on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from far_tpu_torch.data import (
    InteriornetStreetlearnDataset,
    MapFreeDataset,
    Mp3dDataset,
    SyntheticPairDataset,
)


def _parse_value(s: str) -> Any:
    if "," in s:  # tuple values, e.g. backbone.block_dims=16,24,32
        return tuple(_parse_value(x) for x in s.split(","))
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply 'a.b.c=value' overrides to a nested frozen dataclass."""
    for ov in overrides or []:
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        value = _parse_value(raw.strip())

        def rec(node, ks):
            if len(ks) == 1:
                return dataclasses.replace(node, **{ks[0]: value})
            child = getattr(node, ks[0])
            return dataclasses.replace(node, **{ks[0]: rec(child, ks[1:])})

        cfg = rec(cfg, keys)
    return cfg


def parse_hw(s: str):
    """'HxW' -> (H, W)."""
    return tuple(int(x) for x in s.split("x"))


def build_dataset(args):
    """The dataset of ``--dataset`` (samples on the host)."""
    if args.dataset == "synthetic":
        return SyntheticPairDataset(n=args.n_synthetic, hw=parse_hw(args.image_size))
    if args.dataset == "mp3d":
        return Mp3dDataset(args.data_json, args.data_dir, args.depth_dir,
                           mode=args.split)
    if args.dataset == "interiornet_streetlearn":
        return InteriornetStreetlearnDataset(args.data_json, args.data_dir)
    if args.dataset == "mapfree":
        return MapFreeDataset(args.data_dir, split=args.split)
    raise ValueError(f"unknown dataset {args.dataset}")


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises without a card, cpu runs "
                        "the kernels' plain versions")
    return p


def add_common_args(p):
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "mp3d", "interiornet_streetlearn",
                            "mapfree"])
    p.add_argument("--data_dir", default=None)
    p.add_argument("--data_json", default=None)
    p.add_argument("--depth_dir", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--image_size", default="480x640",
                   help="HxW (synthetic + model input)")
    p.add_argument("--n_synthetic", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=4,
                   help="pairs a batch: training's global batch, which the "
                        "ranks of a data-parallel run split; evaluation's "
                        "a process")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override a.b.c=value (repeatable)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    return add_device_arg(p)
