"""Match visualization figures.

Counterpart of ``far_tpu/utils/plotting.py`` (crockwell/far:
mp3d_loftr/src/utils/plotting.py, make_matching_figures): side-by-side
pair with match lines colored by epipolar error (green = correct under
the threshold), dynamic alpha by match count, and the text box with
counts/precision. It takes the port's ``FarOutput`` and ``PairBatch``
and moves their tensors to the host. matplotlib (Agg) is imported where
a figure is drawn, not with the module: a machine without it imports
the port and raises ``ImportError`` only when asked for a figure.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("match figures need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def error_colormap(err: np.ndarray, thr: float, alpha: float = 1.0):
    """Green below thr, fading to red at 2*thr (reference convention)."""
    x = 1.0 - np.clip(err / (thr * 2.0), 0.0, 1.0)
    return np.stack([2 - x * 2, x * 2, np.zeros_like(x),
                     np.full_like(x, alpha)], -1).clip(0, 1)


def dynamic_alpha(n_matches: int,
                  milestones=(0, 300, 1000, 2000),
                  alphas=(1.0, 0.8, 0.4, 0.2)) -> float:
    if n_matches == 0:
        return 1.0
    ranges = list(zip(alphas, alphas[1:] + (alphas[-1],)))
    for (m0, m1), (a0, a1) in zip(zip(milestones, milestones[1:] + (1e9,)),
                                  ranges):
        if m0 <= n_matches < m1:
            if m1 >= 1e9:
                return a0
            return a0 + (a1 - a0) * (n_matches - m0) / (m1 - m0)
    return alphas[-1]


def make_matching_figure(
    img0: np.ndarray,
    img1: np.ndarray,
    mkpts0: np.ndarray,
    mkpts1: np.ndarray,
    epi_errs: Optional[np.ndarray] = None,
    epi_thr: float = 5e-4,
    text: Optional[list] = None,
    dpi: int = 75,
):
    """One pair figure with error-colored match lines."""
    plt = pyplot()
    from matplotlib.lines import Line2D

    img0 = np.asarray(img0).squeeze()
    img1 = np.asarray(img1).squeeze()
    n = len(mkpts0)
    alpha = dynamic_alpha(n)
    if epi_errs is not None and n:
        color = error_colormap(np.asarray(epi_errs), epi_thr, alpha)
        precision = float(np.mean(np.asarray(epi_errs) < epi_thr))
    else:
        color = np.tile([0.0, 1.0, 0.0, alpha], (n, 1))
        precision = float("nan")

    fig, axes = plt.subplots(1, 2, figsize=(10, 6), dpi=dpi)
    for ax, im in zip(axes, (img0, img1)):
        ax.imshow(im, cmap="gray", vmin=0, vmax=1)
        ax.get_yaxis().set_ticks([])
        ax.get_xaxis().set_ticks([])
    plt.tight_layout(pad=1)

    if n:
        fig.canvas.draw()
        t0 = axes[0].transData.transform(mkpts0)
        t1 = axes[1].transData.transform(mkpts1)
        inv = fig.transFigure.inverted()
        f0 = inv.transform(t0)
        f1 = inv.transform(t1)
        fig.lines = [
            Line2D((f0[i, 0], f1[i, 0]), (f0[i, 1], f1[i, 1]),
                   transform=fig.transFigure, c=color[i], linewidth=1)
            for i in range(n)
        ]
        axes[0].scatter(mkpts0[:, 0], mkpts0[:, 1], c=color, s=4)
        axes[1].scatter(mkpts1[:, 0], mkpts1[:, 1], c=color, s=4)

    lines = text or [f"#matches: {n}", f"precision: {precision:.2f}"]
    axes[0].text(0.01, 0.99, "\n".join(lines),
                 transform=axes[0].transAxes, va="top", ha="left",
                 fontsize=12, color="w",
                 bbox=dict(facecolor="k", alpha=0.6, pad=2))
    return fig


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_matching_figures(batch_out, batch, mode: str = "evaluation",
                          epi_errs: Optional[np.ndarray] = None) -> Dict:
    """Figures for every pair of a ``FarOutput`` batch (``epi_errs``: the
    (B, K) epipolar distances of its match slots, or None)."""
    figs = {mode: []}
    m = batch_out.matches
    valid = m.valid.cpu().numpy()
    mk0, mk1 = _host(m.mkpts0_f), _host(m.mkpts1_f)
    im0, im1 = _host(batch.image0), _host(batch.image1)
    for b in range(valid.shape[0]):
        v = valid[b]
        figs[mode].append(make_matching_figure(
            im0[b], im1[b], mk0[b][v], mk1[b][v],
            None if epi_errs is None else _host(epi_errs[b])[v],
        ))
    return figs
