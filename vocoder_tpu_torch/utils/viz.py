"""Validation visualisation: GT-vs-generated mel comparison figures.

A copy of ``vocoder_tpu/utils/viz.py``.

Functional analogue of the reference's val-time mel plots
(fish_vocoder/utils/viz.py:8-29 + models/vocoder.py:63-77), designed fresh:
one column of time-aligned panels sharing the frame axis, each a pcolormesh
of the log-mel with its own colorbar, so GT/prediction differences line up
vertically.  Headless (Agg) and import-gated — callers get None when
matplotlib is unavailable rather than an exception mid-training.
"""

from __future__ import annotations

import numpy as np


def plot_mel(mels, titles=None):
    """[(n_mels, frames), ...] log-mel arrays -> matplotlib Figure (or None).

    Panels are stacked top-to-bottom in the given order with a shared frame
    axis; amplitude range is common across panels so colours are comparable.
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    mels = [np.asarray(m) for m in mels]
    titles = list(titles) if titles is not None else [None] * len(mels)
    vmin = min(float(m.min()) for m in mels)
    vmax = max(float(m.max()) for m in mels)

    fig, axes = plt.subplots(
        len(mels), 1, figsize=(10.0, 2.4 * len(mels)), sharex=True, constrained_layout=True
    )
    axes = np.atleast_1d(axes)
    for ax, mel, title in zip(axes, mels, titles):
        quad = ax.pcolormesh(mel, shading="auto", vmin=vmin, vmax=vmax, rasterized=True)
        fig.colorbar(quad, ax=ax, pad=0.01)
        ax.set_ylabel("mel bin", fontsize=8)
        if title:
            ax.set_title(title, fontsize=9, loc="left")
        ax.tick_params(labelsize=7)
    axes[-1].set_xlabel("frame", fontsize=8)
    return fig
