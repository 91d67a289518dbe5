"""Checkpoints and the curriculum's parameter surgery.

Counterpart of ``far_tpu/train/checkpoint.py`` (orbax there, ``torch.save``
here): step-tagged checkpoints, ``max_to_keep`` of them, the latest ones
or, with ``best_fn_key``, the best by that metric (``best_mode`` 'min' or
'max'), as orbax's manager keeps them; ``restore`` of the newest or a
given step. ``surgical_load`` merges a restored state dict into a
template, keeping the template's entry wherever a key is missing or a
shape changed between curriculum phases.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch


class CheckpointManager:
    """``<directory>/<step>.pt`` (the state) beside ``<step>.json`` (its
    metrics); steps already in the directory count, so a new manager on
    an old directory resumes from them."""

    def __init__(self, directory, max_to_keep: int = 5,
                 best_fn_key: Optional[str] = None, best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_fn_key = best_fn_key
        self.best_mode = best_mode

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metrics(self, step: int) -> Dict[str, float]:
        return json.loads((self.directory / f"{step}.json").read_text())

    def save(self, step: int, state: Any,
             metrics: Optional[Dict[str, float]] = None) -> None:
        tmp = self.directory / f"{step}.pt.tmp"
        torch.save(state, tmp)
        (self.directory / f"{step}.json").write_text(
            json.dumps({k: float(v) for k, v in (metrics or {}).items()}))
        tmp.replace(self.directory / f"{step}.pt")
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        if self.best_fn_key is None:
            keep = steps[-self.max_to_keep:]
        else:
            sign = 1.0 if self.best_mode == "min" else -1.0
            keep = sorted(steps, key=lambda s: (sign * self._metrics(s)[self.best_fn_key],
                                                s))[:self.max_to_keep]
        for s in set(steps) - set(keep):
            (self.directory / f"{s}.pt").unlink()
            (self.directory / f"{s}.json").unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.directory / f"{step}.pt", map_location="cpu",
                          weights_only=False)


def surgical_load(restored: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
                  verbose: bool = True) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(merged state dict, skipped keys): the template's keys, each from
    ``restored`` where it is there with the same shape."""
    merged, skipped = {}, []
    for key, leaf in template.items():
        cand = restored.get(key)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            merged[key] = cand
        else:
            skipped.append(key)
            merged[key] = leaf
    if verbose and skipped:
        print(f"[surgical_load] re-initialized {len(skipped)} leaves: "
              f"{skipped[:8]}{'...' if len(skipped) > 8 else ''}")
    return merged, skipped


@dataclasses.dataclass(frozen=True)
class CurriculumPhase:
    """One phase of the FAR training curriculum: loss weights and flags,
    warm-started from the previous phase through ``surgical_load``."""

    name: str
    epochs: int
    regress_rt: bool
    use_simple_moe: bool
    solver: str
    rt_weight_rot: float
    rt_weight_tr: float
    coarse_weight: float = 1.0
    fine_weight: float = 1.0


MATTERPORT_CURRICULUM = (
    CurriculumPhase("correspondence", 100, False, False, "ransac", 0.0, 0.0),
    CurriculumPhase("rt_regression", 100, True, False, "ransac", 1.0, 1.0),
    CurriculumPhase("moe_fusion", 100, True, True, "ransac", 1.0, 1.0),
    CurriculumPhase("prior_refine", 50, True, True, "prior_ransac", 1.0, 1.0),
)

MAPFREE_CURRICULUM = (
    CurriculumPhase("regression", 30, True, False, "ransac", 1.0, 1.0,
                    coarse_weight=0.0, fine_weight=0.0),
    CurriculumPhase("moe_fusion", 15, True, True, "ransac", 1.0, 1.0,
                    coarse_weight=0.0, fine_weight=0.0),
    CurriculumPhase("prior_refine", 5, True, True, "prior_ransac", 1.0, 1.0,
                    coarse_weight=0.0, fine_weight=0.0),
)


def apply_phase(cfg, phase: CurriculumPhase):
    """The FARConfig of a curriculum phase."""
    r = dataclasses.replace
    return r(cfg, regress_rt=phase.regress_rt,
             regress=r(cfg.regress, use_simple_moe=phase.use_simple_moe),
             solver=r(cfg.solver, solver=phase.solver),
             loss=r(cfg.loss, rt_weight_rot=phase.rt_weight_rot,
                    rt_weight_tr=phase.rt_weight_tr,
                    coarse_weight=phase.coarse_weight,
                    fine_weight=phase.fine_weight))
