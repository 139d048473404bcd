"""Corner and comparison plotting (counterpart of ``aspire_tpu/plot.py``).

A matplotlib corner plot with the call surface the samples use
(``labels``, ``weights``, ``bins``, ``color``, ``hist_kwargs``, ``fig``
reuse for overlays), and overlays of several sample sets or histories.
matplotlib is imported at first use.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .utils import require_module


def corner_plot(
    x,
    fig=None,
    labels: list[str] | None = None,
    weights=None,
    bins: int = 30,
    color: str = "C0",
    hist_kwargs: dict | None = None,
    plot_datapoints: bool = True,
    density: bool = True,
    levels: tuple = (0.393, 0.865),
    **kwargs: Any,
):
    """d x d corner plot: histograms on the diagonal, 2-D density below.

    Returns the figure; pass ``fig`` to overlay another set of samples on
    the same axes (the overlay contract the comparison plots rely on).
    Other keyword arguments are accepted and ignored, as the JAX
    package's.
    """
    plt = require_module("matplotlib.pyplot", "plotting")
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    d = x.shape[1]
    if fig is None:
        fig, axes = plt.subplots(
            d, d, figsize=(2.2 * d, 2.2 * d), squeeze=False
        )
        for i in range(d):
            for j in range(d):
                if j > i:
                    axes[i][j].set_visible(False)
        new_fig = True
    else:
        grid = np.asarray(fig.axes).reshape(d, d)
        axes = grid
        new_fig = False

    hist_kwargs = dict(hist_kwargs or {})
    hist_kwargs.setdefault("color", color)
    hist_kwargs.setdefault("density", density)

    for i in range(d):
        ax = axes[i][i]
        ax.hist(
            x[:, i],
            bins=bins,
            weights=weights,
            histtype="step",
            **hist_kwargs,
        )
        ax.set_yticks([])
        for j in range(i):
            ax2 = axes[i][j]
            if plot_datapoints:
                ax2.scatter(
                    x[:, j], x[:, i], s=2, alpha=0.3, color=color,
                    linewidths=0,
                )
            # 2-D histogram contours at the given mass levels.
            h, xe, ye = np.histogram2d(
                x[:, j], x[:, i], bins=bins, weights=weights
            )
            if h.sum() > 0:
                hs = np.sort(h.ravel())[::-1]
                cum = np.cumsum(hs) / hs.sum()
                cuts = [
                    hs[np.searchsorted(cum, lv)]
                    for lv in sorted(levels)[::-1]
                    if np.searchsorted(cum, lv) < len(hs)
                ]
                cuts = sorted(set(float(c) for c in cuts if c > 0))
                if cuts:
                    xc = 0.5 * (xe[:-1] + xe[1:])
                    yc = 0.5 * (ye[:-1] + ye[1:])
                    ax2.contour(
                        xc, yc, h.T, levels=cuts, colors=color,
                        linewidths=1.0,
                    )
    if labels is not None and new_fig:
        for j in range(d):
            axes[d - 1][j].set_xlabel(labels[j])
        for i in range(1, d):
            axes[i][0].set_ylabel(labels[i])
    return fig


def plot_comparison(
    *samples,
    parameters: list[str] | None = None,
    per_samples_kwargs: list[dict[str, Any]] | None = None,
    labels: list[str] | None = None,
    **kwargs,
):
    """Overlay corner plots for several sample sets on shared axes.

    Common ``kwargs`` apply to every set; ``per_samples_kwargs[i]``
    overrides them for set ``i``. Colors default to the matplotlib
    cycle (``C0``, ``C1``, ...); pass ``color`` inside a per-sample
    dict to override. ``labels`` adds a figure legend drawn with proxy
    line handles, one per sample set.
    """
    Line2D = require_module("matplotlib.lines", "plotting").Line2D
    if per_samples_kwargs is None:
        # One dict per set (not aliased): per-set mutation must not leak.
        per_samples_kwargs = [{} for _ in samples]
    if len(per_samples_kwargs) != len(samples):
        raise ValueError(
            f"Got {len(per_samples_kwargs)} per-sample kwarg dicts for "
            f"{len(samples)} sample sets; they must have the same length."
        )

    colors = []
    fig = None
    for index, (sample_set, overrides) in enumerate(
        zip(samples, per_samples_kwargs)
    ):
        options = {"bins": 30, "density": True, **kwargs, **overrides}
        # Colors are per-set: only a per_samples_kwargs entry overrides
        # the cycle default (a shared top-level color would make the
        # overlays indistinguishable).
        options.pop("color", None)
        color = overrides.get("color", f"C{index}")
        colors.append(color)
        options["hist_kwargs"] = {
            # Normalized marginals so sets of different sizes overlay
            # on a common scale (also honored by the external corner
            # package when a user routes through it).
            "density": options.get("density", True),
            "color": color,
            **options.get("hist_kwargs", {}),
        }
        fig = sample_set.plot_corner(
            fig=fig, parameters=parameters, color=color, **options
        )

    if labels:
        handles = [
            Line2D([], [], color=c, label=text)
            for c, text in zip(colors, labels)
        ]
        fig.legend(handles=handles, loc="upper right")
    return fig


def plot_history_comparison(*histories):
    """Draw several histories' diagnostic panels onto one shared figure."""
    kinds = {type(h) for h in histories}
    if len(kinds) > 1:
        names = ", ".join(sorted(k.__name__ for k in kinds))
        raise ValueError(
            f"Cannot compare histories of mixed types ({names}); all "
            "inputs must be of the same type."
        )
    fig = None
    for history in histories:
        fig = history.plot(fig=fig)
    return fig
