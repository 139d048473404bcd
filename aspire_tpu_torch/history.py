"""Training and SMC diagnostics histories (counterpart of
``aspire_tpu/history.py``): :class:`FlowHistory` (training and validation
loss) and :class:`SMCHistory` (per temperature: beta, the ESS, the
evidence increments, the chain's acceptance and autocorrelation, the
lineage fraction, the port's ``mutation_route`` and ``nonfinite_target``,
and the population snapshots), each saved to and loaded from HDF5 in the
JAX package's layout (a file of either package loads in the other), and
the JAX package's plots. matplotlib and h5py are imported at first use.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from .utils import require_module


def _pyplot():
    return require_module("matplotlib.pyplot", "plotting")


@dataclass
class History:
    """Base class: dict-shaped HDF5 round trip."""

    def save(self, h5_file, path: str = "history"):
        from .io import save_dict_to_hdf5

        save_dict_to_hdf5(h5_file, path, copy.deepcopy(self.__dict__))

    @classmethod
    def load(cls, h5_file, path: str = "history"):
        from .io import load_dict_from_hdf5

        return cls._from_dict(load_dict_from_hdf5(h5_file, path))

    @classmethod
    def _from_dict(cls, dictionary: dict):
        field_names = set(cls.__dataclass_fields__)
        instance = cls(**{k: _to_list(v) for k, v in dictionary.items()
                          if k in field_names})
        for k, v in dictionary.items():
            if k not in field_names:
                setattr(instance, k, v)
        return instance


def _to_list(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


@dataclass
class FlowHistory(History):
    training_loss: list = field(default_factory=list)
    validation_loss: list = field(default_factory=list)

    def plot_loss(self):
        plt = _pyplot()
        fig = plt.figure()
        plt.plot(self.training_loss, label="Training loss")
        plt.plot(self.validation_loss, label="Validation loss")
        plt.legend()
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        return fig

    def save(self, h5_file, path: str = "flow_history"):
        super().save(h5_file, path=path)

    @classmethod
    def load(cls, h5_file, path: str = "flow_history"):
        return super().load(h5_file, path=path)


@dataclass
class SMCHistory(History):
    log_norm_ratio: list = field(default_factory=list)
    log_norm_ratio_var: list = field(default_factory=list)
    beta: list = field(default_factory=list)
    ess: list = field(default_factory=list)
    ess_target: list = field(default_factory=list)
    eff_target: list = field(default_factory=list)
    mcmc_autocorr: list = field(default_factory=list)
    mcmc_acceptance: list = field(default_factory=list)
    lineage_fraction: list = field(default_factory=list)
    #: which chain ran each mutation, one entry per temperature on either
    #: ladder: "fused_kernel" (the whole-chain kernel, or its plain
    #: version on a CPU tensor) or "split" (the per-step torch chain)
    mutation_route: list = field(default_factory=list)
    #: per mutation, particles whose log-prior or log-likelihood came back
    #: non-finite (the device ladder reads it with the rung's flags)
    nonfinite_target: list = field(default_factory=list)
    #: host (numpy) snapshots of the population: before the first
    #: temperature, then after every mutation
    sample_history: list = field(default_factory=list)

    # -- persistence -------------------------------------------------------

    def save(self, h5_file, path: str = "smc_history"):
        from .io import save_dict_to_hdf5

        dictionary = {k: copy.deepcopy(v) for k, v in self.__dict__.items()
                      if k != "sample_history"}
        dictionary["__len_sample_history"] = len(self.sample_history)
        save_dict_to_hdf5(h5_file, path, dictionary)
        for i, samples in enumerate(self.sample_history):
            samples.save(h5_file, path=f"{path}__sample_history/{i}")

    @classmethod
    def load(cls, h5_file, path: str = "smc_history"):
        from .io import load_dict_from_hdf5
        from .samples import SMCSamples

        dictionary = load_dict_from_hdf5(h5_file, path)
        n = int(dictionary.pop("__len_sample_history", 0))
        dictionary["sample_history"] = [
            SMCSamples.load(h5_file, path=f"{path}__sample_history/{i}"
                            ).to_numpy()
            for i in range(n)]
        return cls._from_dict(dictionary)

    # -- plots -------------------------------------------------------------

    def _plot_series(self, values, ylabel, ax=None):
        plt = _pyplot()

        if ax is None:
            fig, ax = plt.subplots()
        else:
            fig = None
        ax.plot(values)
        ax.set_xlabel("Iteration")
        ax.set_ylabel(ylabel)
        return fig

    def plot_beta(self, ax=None):
        return self._plot_series(self.beta, r"$\beta$", ax)

    def plot_log_norm_ratio(self, ax=None):
        return self._plot_series(
            self.log_norm_ratio, "Log evidence ratio", ax
        )

    def plot_ess(self, ax=None):
        return self._plot_series(self.ess, "ESS", ax)

    def plot_ess_target(self, ax=None):
        return self._plot_series(self.ess_target, "ESS target", ax)

    def plot_eff_target(self, ax=None):
        return self._plot_series(self.eff_target, "Efficiency target", ax)

    def plot_mcmc_acceptance(self, ax=None):
        return self._plot_series(self.mcmc_acceptance, "MCMC Acceptance", ax)

    def plot_mcmc_autocorr(self, ax=None):
        return self._plot_series(self.mcmc_autocorr, "MCMC Autocorr", ax)

    def plot_lineage_fraction(self, ax=None):
        """Effective independent-lineage fraction per iteration: the
        particle-degeneracy diagnostic that inflates the reported
        evidence variance (1.0 = fully independent particles)."""
        return self._plot_series(
            self.lineage_fraction, "Lineage fraction", ax
        )

    def plot(self, fig=None):
        plt = _pyplot()

        methods = [
            self.plot_beta,
            self.plot_log_norm_ratio,
            self.plot_ess,
            self.plot_ess_target,
            self.plot_eff_target,
            self.plot_mcmc_acceptance,
        ]
        if fig is None:
            fig, axs = plt.subplots(
                len(methods), 1, sharex=True, figsize=(6, 2 * len(methods))
            )
        else:
            axs = fig.axes
        for method, ax in zip(methods, axs):
            method(ax)
        for ax in axs[:-1]:
            ax.set_xlabel("")
        return fig

    def _panel_layout(self, parameters, ax):
        """Shared panel setup for the per-parameter history plots.

        Resolves the requested parameter names to column indices in the
        stored particle arrays and returns
        ``(fig_or_None, axes, names, columns)``. When ``ax`` is given
        the caller draws into it and ``fig`` is ``None``.
        """
        plt = _pyplot()

        if not self.sample_history:
            raise ValueError(
                "No sample history was recorded for this run; enable "
                "sample-history storage on the sampler to use this plot."
            )
        first = self.sample_history[0]
        known = first.parameters or [f"x_{i}" for i in range(first.dims)]
        names = list(parameters) if parameters is not None else known
        columns = [known.index(p) for p in names]

        if ax is not None:
            axes = np.atleast_1d(ax)
            if len(axes) != len(names):
                raise ValueError(
                    f"Expected {len(names)} axes for parameters "
                    f"{names}, got {len(axes)}."
                )
            return None, axes, names, columns
        fig, axes = plt.subplots(
            len(names),
            1,
            sharex=True,
            figsize=(6, 2 * len(names)),
            squeeze=False,
        )
        return fig, axes[:, 0], names, columns

    def plot_sample_history(
        self,
        n_samples=None,
        parameters=None,
        ax=None,
        cmap: str = "viridis",
        scatter_kwargs=None,
        x_axis: str = "log_p_t",
        iterations: list[int] | None = None,
    ):
        """Particle positions across the tempering ladder.

        One panel per parameter. Points are shaded by SMC iteration
        (with a colorbar) and positioned horizontally by ``x_axis`` —
        the tempered density ``log_p_t``, the raw ``log_likelihood``,
        or, when the required quantities were not stored with the
        snapshots, the iteration index.

        The JAX package's plot: one flattened scatter per panel.
        """
        if x_axis not in ("log_p_t", "log_likelihood"):
            raise ValueError(
                f"Unsupported x_axis {x_axis!r}: choose 'log_p_t' or "
                "'log_likelihood'."
            )
        fig, axes, names, columns = self._panel_layout(parameters, ax)

        chosen = (
            list(iterations)
            if iterations is not None
            else list(range(len(self.sample_history)))
        )
        snapshots = [self.sample_history[t].to_numpy() for t in chosen]

        def horizontal(snap):
            if x_axis == "log_likelihood":
                got = snap.log_likelihood
                return None if got is None else np.asarray(got)
            ingredients = (
                snap.log_likelihood,
                snap.log_prior,
                snap.log_q,
                getattr(snap, "beta", None),
            )
            if any(part is None for part in ingredients):
                return None
            return np.asarray(snap.log_p_t(snap.beta))

        positions = [horizontal(snap) for snap in snapshots]
        if any(p is None for p in positions):
            # Snapshots lack the requested quantity: degrade to the
            # iteration index so the plot stays usable.
            positions = [
                np.full(len(snap), float(t))
                for t, snap in zip(chosen, snapshots)
            ]
            x_label = "Iteration"
        else:
            x_label = (
                r"$\log p_t(\beta)$" if x_axis == "log_p_t"
                else r"$\log L$"
            )

        # Flatten all chosen iterations into one array per panel and
        # draw a single scatter shaded by iteration.
        keep = slice(None, n_samples)
        x_flat = np.concatenate([p[keep] for p in positions])
        shade = np.concatenate(
            [
                np.full(len(p[keep]), float(t))
                for t, p in zip(chosen, positions)
            ]
        )
        style = {"s": 10, **(scatter_kwargs or {})}
        mappable = None
        for axis, name, col in zip(axes, names, columns):
            y_flat = np.concatenate(
                [np.asarray(snap.x)[keep, col] for snap in snapshots]
            )
            mappable = axis.scatter(
                x_flat, y_flat, c=shade, cmap=cmap,
                vmin=min(chosen), vmax=max(chosen), **style,
            )
            axis.set_ylabel(name)
        axes[-1].set_xlabel(x_label)
        if fig is not None and mappable is not None:
            fig.colorbar(mappable, ax=list(axes), label="Iteration")
        return fig

    def plot_quantile_bands(
        self,
        parameters: list[str] | None = None,
        quantile_interval: tuple[float, float] = (0.1, 0.9),
        ax=None,
        line_kwargs=None,
        band_kwargs=None,
    ):
        """Median track and quantile band per parameter vs iteration.

        The JAX package's plot: the quantiles of each snapshot in one pass.
        """
        low, high = quantile_interval
        if not 0.0 <= low < 0.5 < high <= 1.0:
            raise ValueError(
                "quantile_interval must be (low, high) with "
                f"0 <= low < 0.5 < high <= 1; got {quantile_interval}."
            )
        fig, axes, names, columns = self._panel_layout(parameters, ax)

        # (n_iterations, 3, n_params): lower / median / upper per step.
        bands = np.stack(
            [
                np.quantile(
                    np.asarray(snap.to_numpy().x)[:, columns],
                    [low, 0.5, high],
                    axis=0,
                )
                for snap in self.sample_history
            ]
        )
        steps = np.arange(bands.shape[0])
        track_style = {"color": "C0", "lw": 1.5, **(line_kwargs or {})}
        band_style = {"color": "C0", "alpha": 0.2, **(band_kwargs or {})}
        for panel, (axis, name) in enumerate(zip(axes, names)):
            axis.fill_between(
                steps, bands[:, 0, panel], bands[:, 2, panel], **band_style
            )
            axis.plot(steps, bands[:, 1, panel], **track_style)
            axis.set_ylabel(name)
        axes[-1].set_xlabel("Iteration")
        return fig
