"""Validation during training for FARLoFTR.

Counterpart of ``far_tpu/train/validation.py:validate_far``: one pass over
a validation set in sequential shards, the per-pair pose errors and the
per-match symmetric epipolar distances of the K-normalised keypoints
against the ground truth's essential matrix, the gather across processes
(the identity in one; each rank runs its strided shard, padded to as many
pairs as the others) and the Matterport table, which drops the padding's
repeats by identifier: the same on every rank. Its ``rot mean err`` is
the signal a trainer keeps its best checkpoint by. With ``fig_dir`` it
also saves match figures of the first batch (``utils/plotting.py``),
which need matplotlib: without it the pass raises ImportError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from far_tpu_torch.data.loader import Loader, to_device
from far_tpu_torch.data.sampler import sequential_indices
from far_tpu_torch.eval.metrics import aggregate_metrics, relative_pose_error
from far_tpu_torch.geometry.epipolar import (
    essential_from_pose34,
    symmetrical_epipolar_distance,
)
from far_tpu_torch.geometry.transforms import normalize_kpts_by_K
from far_tpu_torch.models.loftr import FARLoFTR
from far_tpu_torch.parallel.comm import (
    all_gather_metrics,
    decode_strings,
    encode_strings,
    process_count,
    process_index,
)
from far_tpu_torch.pipeline import build_inference_fn
from far_tpu_torch.types import FarOutput, PairBatch

_KEYS = ("identifiers", "R_errs", "t_errs", "t_errs_abs", "successful_fits",
         "epi_errs")


def validate_far(
    model: FARLoFTR,
    dataset,
    batch_size: int,
    max_matches: Optional[int] = None,
    max_batches: int = 0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    prior_pcl: Optional[torch.Tensor] = None,
    fig_dir: Optional[str] = None,
    n_figs: int = 2,
    step: int = 0,
) -> Dict:
    """One validation pass of ``model`` (``build_inference_fn``, on the
    model's device) over ``dataset`` -> the Matterport table.

    Args:
        dataset: items with the images, intrinsics, ``T_0to1`` and
            ``pair_names`` (joined with '#' into each pair's identifier).
        max_matches: width of each pair's NaN-padded epipolar row (the
            config's ``match.max_matches`` by default).
        max_batches: stop after this many batches (0: all).
        generator: the RANSAC sampler's generator, on the model's device.
        uniforms: optional sampler draws in place of the generator's: for
            each batch the per-round list that ``far_forward`` takes.
        prior_pcl: optional probe cloud of the prior rounds.
        fig_dir: when set, process 0 saves the match figures of the first
            batch's first ``n_figs`` pairs there, as
            ``val_step{step:07d}_pair{i}.png`` at dpi 75.
    Returns:
        the table of ``aggregate_metrics``, with 'rot mean err'.
    """
    max_matches = max_matches or model.config.match.max_matches
    acc = {k: [] for k in _KEYS}
    batches = far_batches(model, dataset, batch_size, max_batches, generator, uniforms,
                          prior_pcl)
    for bi, (batch, meta, out) in enumerate(batches):
        epi = accumulate_far(acc, out, batch, meta, max_matches)
        if bi == 0 and fig_dir is not None and process_index() == 0:
            save_match_figures(out, batch, epi, fig_dir, step, n_figs)
    return aggregate_metrics(gather_pair_metrics(acc))


def save_match_figures(out: FarOutput, batch: PairBatch, epi: np.ndarray, fig_dir: str,
                       step: int, n_figs: int) -> None:
    """The first ``n_figs`` pairs' match figures, coloured by their (B, K)
    epipolar distances, saved under ``fig_dir``; every figure is closed."""
    from far_tpu_torch.utils.plotting import make_matching_figures, pyplot

    figs = make_matching_figures(out, batch, "validation", epi)["validation"]
    d = Path(fig_dir)
    d.mkdir(parents=True, exist_ok=True)
    plt = pyplot()
    for i, fig in enumerate(figs):
        if i < n_figs:
            fig.savefig(d / f"val_step{step:07d}_pair{i}.png", dpi=75)
        plt.close(fig)


def far_batches(model: FARLoFTR, dataset, batch_size: int, max_batches: int = 0,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                prior_pcl: Optional[torch.Tensor] = None
                ) -> Iterator[Tuple[PairBatch, Dict, FarOutput]]:
    """The evaluation loop that ``validate_far`` and the evaluation CLI
    share: this process's sequential shard of ``dataset`` in batches (at
    most ``max_batches``; 0: all), each moved to the model's device and
    run through ``build_inference_fn`` -> ``(batch, meta, output)``. The
    arguments are ``validate_far``'s."""
    device = next(model.parameters()).device
    fn = build_inference_fn(model)
    idx = sequential_indices(len(dataset), rank=process_index(),
                             world_size=process_count())
    for bi, (batch, meta) in enumerate(Loader(dataset, idx, batch_size, keep_meta=True)):
        if max_batches and bi >= max_batches:
            break
        batch = to_device(batch, device)
        out = fn(batch, generator=generator,
                 uniforms=None if uniforms is None else uniforms[bi],
                 prior_pcl=prior_pcl)
        yield batch, meta, out


def accumulate_far(acc: Dict[str, list], out, batch, meta, max_matches: int) -> np.ndarray:
    """Append each pair of a ``far_forward`` output to ``acc``: its
    identifier (``pair_names`` joined with '#'), the fused pose's errors,
    the solver's success, and the symmetric epipolar distances of its valid
    matches against the ground truth, NaN-padded to ``max_matches``.
    Returns every match slot's distance, (B, K)."""
    m = out.matches
    with torch.inference_mode():
        E_gt = essential_from_pose34(batch.T_0to1[:, :3, :4])
        p0 = normalize_kpts_by_K(m.mkpts0_f.float(), batch.K0)
        p1 = normalize_kpts_by_K(m.mkpts1_f.float(), batch.K1)
        epi = symmetrical_epipolar_distance(p0, p1, E_gt).cpu().numpy()
    R, t = out.R.float().cpu().numpy(), out.t.float().cpu().numpy()
    T = batch.T_0to1.cpu().numpy()
    valid = m.valid.cpu().numpy()
    success = out.success.cpu().numpy()
    for b in range(R.shape[0]):
        t_err, r_err, t_abs = relative_pose_error(T[b], R[b], t[b])
        acc["identifiers"].append("#".join(meta["pair_names"][b]))
        acc["R_errs"].append(r_err)
        acc["t_errs"].append(t_err)
        acc["t_errs_abs"].append(t_abs)
        acc["successful_fits"].append(float(success[b]))
        e = np.full(max_matches, np.nan, np.float32)
        ev = epi[b][valid[b]][:max_matches]
        e[: len(ev)] = ev
        acc["epi_errs"].append(e)
    return epi


def gather_pair_metrics(acc: Dict[str, list]) -> Dict[str, list]:
    """Every process's per-pair lists in rank order (the identifiers as
    fixed-width bytes, so they stay aligned with the arrays), each epipolar
    row without its NaN padding. The sampler's padding repeats stay:
    ``aggregate_metrics`` drops them by identifier."""
    gathered = all_gather_metrics({
        **{k: np.asarray(v) for k, v in acc.items() if k != "identifiers"},
        "identifiers": encode_strings(acc["identifiers"]),
    })
    out = {k: list(v) for k, v in gathered.items()}
    out["identifiers"] = decode_strings(np.asarray(gathered["identifiers"]))
    out["epi_errs"] = [e[~np.isnan(e)] for e in gathered["epi_errs"]]
    return out
