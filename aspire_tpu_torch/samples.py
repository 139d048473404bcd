"""Sample containers (counterpart of ``aspire_tpu/samples.py``).

:class:`Samples` carries importance weights, the evidence and the ESS;
:class:`SMCSamples` carries particles at an inverse temperature ``beta``
with the per-step evidence ratio and resampling; :class:`MCMCSamples` a
chain ``(n_steps, n_walkers, d)`` stored flat; :class:`PTMCMCSamples` the
parallel-tempered chains ``(n_temps, n_steps, n_walkers, d)`` with the
thermodynamic-integration and stepping-stone evidence estimators. Each
saves to and loads from HDF5 in the JAX package's layout (a file of either
package loads in the other) and has the JAX package's plots; h5py,
matplotlib and pandas are imported at first use.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .ops.resampling import (
    alltoall_move,
    get_resampler,
    global_index,
    ring_move,
)
from .ops.special import effective_sample_size, logsumexp
from .parallel.mesh import all_gather_rows
from .utils import (
    as_tensor,
    dtype_name,
    require_module,
    resolve_dtype,
    to_numpy,
)

logger = logging.getLogger("aspire_tpu_torch")


def incremental_log_weights(log_q, log_likelihood, log_prior, beta_prev,
                            beta):
    """``(beta_prev - beta) log_q + (beta - beta_prev)(logL + logPi)``,
    NaN -> -inf."""
    log_w = (beta_prev - beta) * log_q + (beta - beta_prev) * (
        log_likelihood + log_prior
    )
    return torch.where(torch.isnan(log_w),
                       torch.full_like(log_w, -math.inf), log_w)


def _copy_value(value):
    """A copy of a field's value (a tensor is cloned)."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return copy.deepcopy(value)


def _maybe(fn, value):
    return fn(value) if value is not None else None


# -- the ladder's evidence reductions -----------------------------------
#
# ``betas`` ascending (the prior first); the log-likelihood matrix
# ``(T, S)`` is centred per rung on the host in float64 and reduced in
# float64. Error bars use the delta method with n / tau effective samples
# per rung, tau the integrated autocorrelation time of the rung's logL.


def _trapezoid_weights(betas: torch.Tensor) -> torch.Tensor:
    """Node weights ``w`` with ``w @ f == trapezoid(f, betas)``."""
    gaps = torch.diff(betas)
    w = torch.zeros_like(betas)
    w[:-1] += 0.5 * gaps
    w[1:] += 0.5 * gaps
    return w


def _ti_spread_error(betas, logl_centered, tau) -> torch.Tensor:
    """Delta-method TI quadrature error from centred draws: the rungs are
    independent chains, each mean's variance deflated by ``S / tau``."""
    betas, logl_centered, tau = (torch.as_tensor(np.asarray(v, np.float64))
                                 for v in (betas, logl_centered, tau))
    w = _trapezoid_weights(betas)
    n_eff = logl_centered.shape[1] / tau
    var_of_mean = torch.var(logl_centered, dim=1, correction=0) / n_eff
    return torch.sqrt(torch.sum(w**2 * var_of_mean))


def _stepping_stone_reduce(betas, logl_centered, tau):
    """Stepping stone over centred draws: ``log r_j = log E_{beta_j}[
    L^{dbeta_j}]`` from the hotter rung ``j`` by a max-shifted mean-exp,
    every rung at once; the error ``sqrt(sum relvar(g_j) / n_eff_j)``.
    An all-``-inf`` rung is shifted by 0 (it gives an honest ``-inf``
    ratio, not NaN), and the exponent is clipped at 0, a no-op in exact
    arithmetic that keeps a rung whose logL spans 1e19 finite."""
    betas, logl_centered, tau = (torch.as_tensor(np.asarray(v, np.float64))
                                 for v in (betas, logl_centered, tau))
    gaps = torch.diff(betas)
    a = gaps[:, None] * logl_centered[:-1]
    shift = torch.max(a, dim=1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift,
                        torch.zeros_like(shift))
    g = torch.exp(torch.clamp(a - shift, max=0.0))
    g_mean = torch.mean(g, dim=1)
    log_r = torch.log(g_mean) + shift[:, 0]
    n_eff = logl_centered.shape[1] / tau[:-1]
    rel_var = torch.var(g, dim=1, correction=0) / (n_eff * g_mean**2)
    return torch.sum(log_r), torch.sqrt(torch.sum(rel_var))


def _integrated_autocorr_1d(series: np.ndarray, c: float = 5.0) -> float:
    """Sokal-windowed IAT of a ``(n_steps, n_chains)`` scalar series; 1.0
    for a constant or too short series (usable as an ESS deflator)."""
    series = np.asarray(series, dtype=np.float64)
    n = series.shape[0]
    if n < 4:
        return 1.0
    centered = series - series.mean(axis=0, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    spec = np.fft.rfft(centered, n=nfft, axis=0)
    acf = np.fft.irfft(spec * np.conjugate(spec), n=nfft, axis=0)[:n].real
    acf = acf.mean(axis=1)
    if not np.isfinite(acf[0]) or acf[0] <= 0:
        return 1.0
    rho = acf / acf[0]
    tau_running = 2.0 * np.cumsum(rho) - 1.0
    window = np.nonzero(np.arange(n) >= c * tau_running)[0]
    tau = tau_running[window[0]] if window.size else tau_running[-1]
    return float(max(tau, 1.0))


@dataclass
class BaseSamples:
    """Samples ``x`` of shape ``(n, d)`` with log-density annotations."""

    x: Any
    log_likelihood: Any = None
    log_prior: Any = None
    log_q: Any = None
    parameters: list[str] | None = None
    dtype: Any = None
    device: Any = None

    def __post_init__(self):
        self.dtype = resolve_dtype(self.dtype)
        device = self.device
        if device is None:
            device = (self.x.device if isinstance(self.x, torch.Tensor)
                      else "cpu")
        self.device = torch.device(device)
        self.x = as_tensor(self.x, dtype=self.dtype, device=self.device)
        if self.x.dim() == 1:
            self.x = self.x[:, None]
        if self.dtype is None:
            if not self.x.is_floating_point():
                self.x = self.x.to(torch.get_default_dtype())
            self.dtype = self.x.dtype

        def conv(v):
            return as_tensor(v, dtype=self.dtype,
                             device=self.device).reshape(-1)

        self.log_likelihood = _maybe(conv, self.log_likelihood)
        self.log_prior = _maybe(conv, self.log_prior)
        self.log_q = _maybe(conv, self.log_q)
        if self.parameters is None:
            self.parameters = [f"x_{i}" for i in range(self.dims)]
        else:
            self.parameters = list(self.parameters)

    @property
    def dims(self) -> int:
        return self.x.shape[1] if self.x.dim() > 1 else 1

    def __len__(self) -> int:
        return len(self.x)

    def _fields(self, idx) -> dict:
        return dict(
            x=self.x[idx],
            log_likelihood=_maybe(lambda v: v[idx], self.log_likelihood),
            log_prior=_maybe(lambda v: v[idx], self.log_prior),
            log_q=_maybe(lambda v: v[idx], self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
            device=self.device,
        )

    def __getitem__(self, idx):
        return self.__class__(**self._fields(idx))

    def __str__(self) -> str:
        return (f"No. samples: {len(self.x)}\n"
                f"No. parameters: {self.x.shape[-1]}\n")

    def to_numpy(self) -> "BaseSamples":
        """A host copy: every tensor field as a numpy array (the JAX
        package's ``to_numpy``)."""
        out = copy.copy(self)
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, torch.Tensor):
                setattr(out, f.name, value.detach().cpu().numpy().copy())
        return out

    # -- conversion and persistence -------------------------------------

    def to_dict(self, flat: bool = True, copy: bool = True) -> dict:
        """Every field but ``x`` (and the port's ``device``), with the
        columns of ``x`` by parameter name: flat, or under ``"samples"``."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in ("x", "device"):
                continue
            value = getattr(self, f.name)
            if copy:
                try:
                    value = _copy_value(value)
                except Exception:  # noqa: BLE001 - keep an uncopyable value
                    pass
            out[f.name] = value
        columns = dict(zip(self.parameters, self.x.T, strict=True))
        if flat:
            out.update(columns)
        else:
            out["samples"] = columns
        return out

    @classmethod
    def from_dict(cls, dictionary: dict, device: Any = None):
        """Samples from :meth:`to_dict`'s form (either package's)."""
        dictionary = dict(dictionary)
        if "samples" in dictionary:
            columns = dictionary.pop("samples")
            parameters = dictionary.pop("parameters", None)
            if parameters is None:
                parameters = sorted(columns.keys())
            x = np.stack([np.asarray(columns[p]) for p in parameters],
                         axis=-1)
        else:
            parameters = dictionary.pop("parameters", None)
            if parameters is None:
                raise ValueError(
                    "Parameters must be provided if samples are not nested "
                    "in a 'samples' key")
            x = np.stack([np.asarray(dictionary.pop(p)) for p in parameters],
                         axis=-1)
        init_fields = {f.name for f in dataclasses.fields(cls) if f.init}
        kwargs = {k: v for k, v in dictionary.items()
                  if k in init_fields and k != "device"}
        return cls(x=x, parameters=list(parameters), device=device, **kwargs)

    def to_dataframe(self, include: list[str] | None = None):
        pd = require_module("pandas", "to_dataframe")
        host = self.to_numpy()
        data = dict(zip(self.parameters, host.x.T, strict=True))
        n = len(host.x)
        for key in (["log_likelihood", "log_prior", "log_q"]
                    if include is None else include):
            value = getattr(host, key, None)
            data[key] = (np.asarray(value) if value is not None
                         else np.full(n, np.nan))
        return pd.DataFrame(data)

    def _encode_for_hdf5(self, flat: bool = True) -> dict:
        dictionary = self.to_numpy().to_dict(flat=flat)
        dictionary["dtype"] = dtype_name(self.dtype)
        dictionary["__class__"] = type(self).__name__
        return dictionary

    def save(self, h5_file, path: str = "samples", flat: bool = False):
        from .io import save_dict_to_hdf5

        save_dict_to_hdf5(h5_file, path, self._encode_for_hdf5(flat=flat))

    @classmethod
    def load(cls, h5_file, path: str = "samples", device: Any = None):
        from .io import load_dict_from_hdf5

        dictionary = load_dict_from_hdf5(h5_file, path)
        dictionary.pop("__class__", None)
        return cls.from_dict(dictionary, device=device)

    # -- plotting -----------------------------------------------------------

    def plot_corner(self, parameters: list[str] | None = None, fig=None,
                    **kwargs):
        """A corner plot: the ``corner`` package's where it is installed,
        else :func:`aspire_tpu_torch.plot.corner_plot`."""
        kwargs = copy.deepcopy(kwargs)
        kwargs.setdefault("labels", self.parameters)
        x = self.x
        if parameters is not None:
            x = x[:, [self.parameters.index(p) for p in parameters]]
            kwargs["labels"] = parameters
        x = to_numpy(x)
        try:
            import corner
        except ImportError:
            from .plot import corner_plot

            return corner_plot(x, fig=fig, **kwargs)
        return corner.corner(x, fig=fig, **kwargs)

    @classmethod
    def concatenate(cls, samples: list) -> "BaseSamples":
        if not samples:
            raise ValueError("No samples to concatenate")

        def cat(name):
            values = [getattr(s, name) for s in samples]
            if any(v is None for v in values):
                return None
            return torch.cat(values, dim=0)

        return cls(
            x=cat("x"),
            log_likelihood=cat("log_likelihood"),
            log_prior=cat("log_prior"),
            log_q=cat("log_q"),
            parameters=samples[0].parameters,
            dtype=samples[0].dtype,
            device=samples[0].device,
        )

    @classmethod
    def from_samples(cls, samples: "BaseSamples", **kwargs):
        kwargs.setdefault("dtype", samples.dtype)
        kwargs.setdefault("parameters", samples.parameters)
        kwargs.setdefault("device", samples.device)
        return cls(
            x=samples.x,
            log_likelihood=samples.log_likelihood,
            log_prior=samples.log_prior,
            log_q=samples.log_q,
            **kwargs,
        )


@dataclass
class Samples(BaseSamples):
    """Weighted (importance) samples."""

    log_evidence: Any = None
    log_evidence_error: Any = None
    log_w: Any = field(init=False, default=None)
    weights: Any = field(init=False, default=None)
    evidence: Any = field(init=False, default=None)
    evidence_error: Any = field(init=False, default=None)
    effective_sample_size: Any = field(init=False, default=None)

    def __post_init__(self):
        super().__post_init__()
        if all(v is not None
               for v in (self.log_likelihood, self.log_prior, self.log_q)):
            self.compute_weights()

    def compute_weights(self) -> None:
        """log_w = logL + logPi - log_q; evidence, delta-method error, ESS.
        The relative error is computed in max-shifted space, so it does not
        underflow float32 at a large ``|log Z|``."""
        self.log_w = self.log_likelihood + self.log_prior - self.log_q
        n = len(self.x)
        self.log_evidence = logsumexp(self.log_w) - math.log(n)
        self.weights = torch.exp(self.log_w)
        self.evidence = torch.exp(self.log_evidence)
        m = torch.max(self.log_w)
        u = torch.exp(torch.clamp(self.log_w - m, max=0.0))
        u_mean = torch.mean(u)
        sigma_u = torch.sqrt(torch.sum((u - u_mean) ** 2) / (n * (n - 1.0)))
        self.log_evidence_error = torch.where(
            u_mean > 0, sigma_u / u_mean, torch.full_like(u_mean, math.inf)
        )
        self.evidence_error = self.log_evidence_error * self.evidence
        self.effective_sample_size = effective_sample_size(self.log_w - m)

    @property
    def efficiency(self):
        if self.log_w is None:
            raise RuntimeError("Samples do not contain weights!")
        return self.effective_sample_size / len(self.x)

    @property
    def scaled_weights(self):
        return torch.exp(self.log_w - torch.max(self.log_w))

    def rejection_sample(self, generator: torch.Generator | None = None,
                         rng=None) -> "Samples":
        """Unweighted samples by rejection: row i is kept where
        ``log_w_i - max log_w > log u_i``. The uniforms are drawn on the
        samples' device from ``generator``, or else on the host from the
        numpy ``rng`` (``rng.uniform(size=n)`` in the weights' dtype, so a
        seed keeps the rows the JAX package keeps). The accept mask stays on
        the device."""
        n = len(self.x)
        if generator is not None:
            log_u = torch.log(torch.rand(n, generator=generator,
                                         dtype=self.log_w.dtype,
                                         device=self.log_w.device))
        else:
            rng = rng or np.random.default_rng()
            log_u = torch.as_tensor(np.log(rng.uniform(size=n)),
                                    dtype=self.log_w.dtype,
                                    device=self.log_w.device)
        accept = self.log_w - torch.max(self.log_w) > log_u
        return self.__class__(
            x=self.x[accept], log_likelihood=self.log_likelihood[accept],
            log_prior=self.log_prior[accept], dtype=self.dtype,
            parameters=self.parameters, device=self.device)

    def plot_corner(self, include_weights: bool = True, **kwargs):
        kwargs = copy.deepcopy(kwargs)
        if (include_weights and self.log_w is not None
                and "weights" not in kwargs):
            kwargs["weights"] = to_numpy(self.scaled_weights)
        return super().plot_corner(**kwargs)

    def __getitem__(self, idx):
        sliced = super().__getitem__(idx)
        sliced.log_evidence = self.log_evidence
        sliced.log_evidence_error = self.log_evidence_error
        return sliced

    def __str__(self) -> str:
        out = super().__str__()
        if self.log_evidence is not None:
            out += f"Log evidence: {float(self.log_evidence):.2f}"
            if self.log_evidence_error is not None:
                out += f" +/- {float(self.log_evidence_error):.2f}"
            out += "\n"
        if self.log_w is not None:
            out += (f"Effective sample size: "
                    f"{float(self.effective_sample_size):.1f}\n"
                    f"Efficiency: {float(self.efficiency):.2f}\n")
        return out


@dataclass
class SMCSamples(BaseSamples):
    """Particles at ``beta`` on ``log p_t = (1-beta) log_q + beta (logL +
    logPi)``."""

    beta: float | None = None
    log_evidence: float | None = None
    log_evidence_error: float | None = None

    def log_p_t(self, beta):
        return (1 - beta) * self.log_q + beta * (self.log_likelihood
                                                 + self.log_prior)

    def unnormalized_log_weights(self, beta) -> torch.Tensor:
        return incremental_log_weights(
            self.log_q, self.log_likelihood, self.log_prior, self.beta, beta
        )

    def _global_log_weights(self, beta, mesh) -> torch.Tensor:
        """The incremental log-weights of the whole population: this
        rank's, gathered over ``mesh`` where the rows are sharded."""
        log_w = self.unnormalized_log_weights(beta)
        return log_w if mesh is None else all_gather_rows(log_w, mesh)

    def log_evidence_ratio(self, beta, mesh=None) -> torch.Tensor:
        log_w = self._global_log_weights(beta, mesh)
        return logsumexp(log_w) - math.log(log_w.shape[0])

    def log_evidence_ratio_variance(self, beta, mesh=None) -> torch.Tensor:
        """Delta-method variance of the per-step evidence ratio."""
        log_w = self._global_log_weights(beta, mesh)
        m = torch.max(log_w)
        u = torch.exp(torch.clamp(log_w - m, max=0.0))
        mean_w = torch.mean(u)
        var_w = torch.var(u, correction=0)
        return torch.where(mean_w != 0, var_w / (log_w.shape[0] * mean_w**2),
                           torch.full_like(mean_w, math.nan))

    def log_weights(self, beta) -> torch.Tensor:
        if bool(torch.isnan(self.log_q).any()
                | torch.isnan(self.log_likelihood).any()
                | torch.isnan(self.log_prior).any()):
            raise ValueError(f"Log weights contain NaN values for beta={beta}")
        log_w = self.unnormalized_log_weights(beta)
        return log_w + logsumexp(log_w) - math.log(len(self.x))

    def resample(self, beta, generator: torch.Generator,
                 n_samples: int | None = None,
                 method: str = "systematic", impl: str = "auto",
                 mesh=None) -> "SMCSamples":
        """Resample the particles to temperature ``beta``.

        ``mesh`` (:class:`~aspire_tpu_torch.parallel.mesh.ProcessMesh`)
        says the rows are sharded over it: these are this rank's, and
        ``n_samples`` (the whole population's size by default) counts the
        whole output. Every rank draws the same global index from the
        gathered log-weights, then ``impl`` moves the rows: ``"auto"``
        gathers them and takes this rank's block of ``data[idx]`` (all of
        it where ``n_samples`` does not divide by the mesh size: the
        output is then the whole population on every rank), ``"ring"``
        and ``"alltoall"`` run the schedules of
        :mod:`aspire_tpu_torch.ops.resampling`, bit for bit the same rows;
        they need a mesh and an ``n_samples`` that divides by its size."""
        n = len(self.x) * (mesh.size if mesh is not None else 1)
        if n_samples is None:
            n_samples = n
        if beta == self.beta and n_samples == n:
            logger.warning(
                "Resampling with the same beta value, returning identical "
                "samples"
            )
            return self
        if impl not in ("auto", "ring", "alltoall"):
            raise ValueError(
                f"Unknown resampling impl {impl!r}: use 'auto', 'ring' "
                "or 'alltoall'.")
        if impl != "auto":
            if mesh is None:
                raise ValueError(
                    f"impl={impl!r} needs a mesh-sharded population; use "
                    "impl='auto' for single-device runs.")
            if n_samples % mesh.size:
                raise ValueError(
                    f"impl={impl!r} emits n_samples/S rows per shard: "
                    f"n_samples ({n_samples}) must be divisible by the "
                    f"mesh size ({mesh.size}).")
        if beta == self.beta:
            log_w = torch.zeros(len(self.x), dtype=self.x.dtype,
                                device=self.x.device)
        else:
            log_w = self.unnormalized_log_weights(beta)
        fields = {"x": self.x, "log_likelihood": self.log_likelihood,
                  "log_prior": self.log_prior, "log_q": self.log_q}
        if mesh is None:
            idx = get_resampler(method)(generator, log_w, int(n_samples))
            moved = {name: v[idx] for name, v in fields.items()}
        else:
            moved = self._moved_on_mesh(fields, global_index(
                generator, log_w, mesh, method, int(n_samples)), impl, mesh)
        return self.__class__(
            **moved,
            beta=beta,
            dtype=self.dtype,
            parameters=self.parameters,
            device=self.device,
        )

    @staticmethod
    def _moved_on_mesh(fields: dict, idx: torch.Tensor, impl: str,
                       mesh) -> dict:
        """The fields' rows at the global index ``idx``, this rank's block
        of them (all where ``idx`` does not divide by the mesh size), moved
        by ``impl``: one matrix per dtype, as the JAX package packs them,
        so each field keeps its precision."""
        cols = {name: v.reshape(v.shape[0], -1) for name, v in fields.items()}
        groups: dict = {}
        for name, v in cols.items():
            groups.setdefault(v.dtype, []).append(name)
        tiles = idx.shape[0] % mesh.size == 0
        out = {}
        for names in groups.values():
            packed = torch.cat([cols[name] for name in names], dim=1)
            if impl == "ring":
                rows = ring_move(idx, packed, mesh)
            elif impl == "alltoall":
                rows = alltoall_move(idx, packed, mesh)[0]
            else:
                rows = all_gather_rows(packed, mesh)[idx]
                if tiles:
                    rows = mesh.local_rows(rows)
            col = 0
            for name in names:
                width = cols[name].shape[1]
                out[name] = rows[:, col:col + width].reshape(
                    -1, *fields[name].shape[1:]).contiguous()
                col += width
        return out

    def to_standard_samples(self) -> Samples:
        return Samples(
            x=self.x,
            log_likelihood=self.log_likelihood,
            log_prior=self.log_prior,
            parameters=self.parameters,
            log_evidence=self.log_evidence,
            log_evidence_error=self.log_evidence_error,
            device=self.device,
        )

    def __getitem__(self, idx):
        sliced = super().__getitem__(idx)
        sliced.beta = self.beta
        sliced.log_evidence = self.log_evidence
        sliced.log_evidence_error = self.log_evidence_error
        return sliced

    def __str__(self) -> str:
        out = super().__str__()
        if self.log_evidence is not None:
            out += f"Log evidence: {float(self.log_evidence):.2f}\n"
        return out


@dataclass
class MCMCSamples(BaseSamples):
    """Chain-shaped samples ``(n_steps, n_walkers, d)`` stored flattened,
    with the burn-in and thinning already applied and the integrated
    autocorrelation time once computed."""

    chain_shape: tuple | None = None
    burn_in: int = 0
    thin: int = 1
    autocorrelation_time: Any = None

    def __post_init__(self):
        super().__post_init__()
        if self.chain_shape is not None:
            self.chain_shape = tuple(int(s) for s in self.chain_shape)

    @classmethod
    def from_chain(cls, chain, parameters: list[str] | None = None,
                   dtype: Any = None, device: Any = None,
                   **kwargs) -> "MCMCSamples":
        """Build from a chain ``(n_steps, n_walkers, d)`` (a 2-d chain is
        one walker)."""
        chain = as_tensor(chain, dtype=dtype, device=device)
        if chain.dim() == 2:
            chain = chain[:, None, :]
        return cls(x=chain.reshape(-1, chain.shape[-1]),
                   chain_shape=tuple(chain.shape[:-1]),
                   parameters=parameters, dtype=dtype, device=chain.device,
                   **kwargs)

    def __getitem__(self, idx):
        """Slice the flat samples: the result is one walker of the sliced
        length, with the burn-in, thinning and autocorrelation time kept."""
        sliced = super().__getitem__(idx)
        sliced.chain_shape = (len(sliced.x), 1)
        sliced.burn_in = self.burn_in
        sliced.thin = self.thin
        sliced.autocorrelation_time = self.autocorrelation_time
        return sliced

    @property
    def chain(self) -> torch.Tensor:
        """The samples reshaped to ``(n_steps, n_walkers, d)``."""
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        return self.x.reshape(*self.chain_shape, self.dims)

    def _reshape_like_chain(self, value) -> torch.Tensor:
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        return value.reshape(*self.chain_shape)

    def compute_autocorrelation_time(self, c: float = 5.0) -> torch.Tensor:
        """Integrated autocorrelation time per parameter, emcee's way: the
        FFT autocorrelation averaged over walkers, summed over Sokal's
        adaptive window (``c`` times the running estimate); NaN for a
        constant parameter. On the host, in float64."""
        chain = self.chain.detach().cpu().double().numpy()
        n = chain.shape[0]
        taus = []
        for k in range(chain.shape[-1]):
            x = chain[:, :, k]
            x = x - x.mean(axis=0, keepdims=True)
            nfft = 1 << (2 * n - 1).bit_length()
            f = np.fft.fft(x, n=nfft, axis=0)
            acf = np.fft.ifft(f * np.conjugate(f), axis=0)[:n].real
            acf = acf.mean(axis=1)
            if acf[0] <= 0:
                taus.append(np.nan)
                continue
            acf /= acf[0]
            cumulative = 2.0 * np.cumsum(acf) - 1.0
            window = np.arange(n) < c * cumulative
            taus.append(cumulative[-1] if window.all()
                        else cumulative[np.argmin(window)])
        self.autocorrelation_time = torch.as_tensor(np.array(taus))
        return self.autocorrelation_time

    def post_process(self, burn_in: int | None = None,
                     thin: int | None = None) -> "MCMCSamples":
        """Drop ``burn_in`` steps and keep every ``thin``-th after them.
        The ``burn_in``/``thin`` attributes record what was already
        applied and are not applied again: a call with no arguments is a
        no-op."""
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        burn_in = 0 if burn_in is None else burn_in
        thin = 1 if thin is None else thin
        chain = self.chain[burn_in::thin]

        def slice_chain(value):
            if value is None:
                return None
            return self._reshape_like_chain(value)[burn_in::thin].reshape(-1)

        return self.__class__(
            x=chain.reshape(-1, self.dims),
            log_likelihood=slice_chain(self.log_likelihood),
            log_prior=slice_chain(self.log_prior),
            log_q=slice_chain(self.log_q),
            parameters=self.parameters, dtype=self.dtype, device=self.device,
            chain_shape=chain.shape[:-1], burn_in=burn_in, thin=thin,
        )

    def to_samples(self) -> Samples:
        return Samples.from_samples(self)


@dataclass
class PTMCMCSamples(MCMCSamples):
    """Parallel-tempered chains ``(n_temps, n_steps, n_walkers, d)`` stored
    flat, with their inverse temperatures (``betas``: 1-d, strictly
    decreasing, the cold chain first at 1) and the run's per-rung move
    and per-pair swap acceptance, which ride through ``post_process`` and
    ``subsample``."""

    betas: Any = None
    #: per-rung stretch-move acceptance rate, shape (T,)
    move_acceptance: Any = None
    #: per-adjacent-pair swap acceptance rate, shape (T-1,)
    swap_acceptance: Any = None

    def __post_init__(self):
        super().__post_init__()
        if self.betas is None:
            return
        self.betas = to_numpy(self.betas)
        betas = np.atleast_1d(np.asarray(self.betas, dtype=float))
        if betas.ndim != 1:
            raise ValueError("betas must be one-dimensional")
        if self.chain_shape is not None and len(betas) != self.chain_shape[0]:
            raise ValueError(f"Got {len(betas)} betas for "
                             f"{self.chain_shape[0]} temperature rungs")
        if len(betas) > 1 and np.any(np.diff(betas) >= 0):
            raise ValueError("betas must be strictly decreasing (cold chain "
                             "first)")
        if not np.isclose(betas[0], 1.0):
            raise ValueError(f"betas must start at 1 (cold chain); got "
                             f"{betas[0]}")

    def __getitem__(self, idx):
        raise NotImplementedError(
            "Slicing is not supported for PTMCMCSamples. Use "
            "at_temperature() to extract samples at a specific temperature.")

    def _with(self, x, pick, chain_shape, **kwargs) -> "PTMCMCSamples":
        """A ladder of the same rungs: ``x`` and every density field through
        ``pick`` (a ``(T, ...)`` tensor to a flat one)."""
        return self.__class__(
            x=x, log_likelihood=_maybe(pick, self.log_likelihood),
            log_prior=_maybe(pick, self.log_prior),
            log_q=_maybe(pick, self.log_q), parameters=self.parameters,
            dtype=self.dtype, device=self.device, chain_shape=chain_shape,
            betas=self.betas, move_acceptance=self.move_acceptance,
            swap_acceptance=self.swap_acceptance, **kwargs)

    def post_process(self, burn_in: int | None = None,
                     thin: int | None = None) -> "PTMCMCSamples":
        """Burn-in and thinning along every rung's step axis (axis 1)."""
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        burn_in = 0 if burn_in is None else burn_in
        thin = 1 if thin is None else thin
        chain = self.chain[:, burn_in::thin]
        return self._with(
            chain.reshape(-1, self.dims),
            lambda v: self._reshape_like_chain(v)[:, burn_in::thin]
            .reshape(-1),
            tuple(chain.shape[:-1]), burn_in=burn_in, thin=thin)

    def compute_autocorrelation_time(self, c: float = 5.0) -> torch.Tensor:
        """Per-rung, per-parameter integrated autocorrelation time, shape
        ``(T, d)``."""
        taus = []
        for t in range(self.n_temperatures):
            sub = self.at_temperature(t)
            sub.autocorrelation_time = None
            taus.append(sub.compute_autocorrelation_time(c))
        self.autocorrelation_time = torch.stack(taus)
        return self.autocorrelation_time

    @property
    def n_temperatures(self) -> int:
        return self.chain_shape[0]

    def at_temperature(self, index: int) -> MCMCSamples:
        """The samples of rung ``index`` as plain MCMCSamples."""
        def pick(value):
            return self._reshape_like_chain(value)[index].reshape(-1)

        return MCMCSamples(
            x=self.chain[index].reshape(-1, self.dims),
            log_likelihood=_maybe(pick, self.log_likelihood),
            log_prior=_maybe(pick, self.log_prior),
            log_q=_maybe(pick, self.log_q), parameters=self.parameters,
            dtype=self.dtype, device=self.device,
            chain_shape=self.chain_shape[1:], burn_in=self.burn_in,
            thin=self.thin,
            autocorrelation_time=(self.autocorrelation_time[index]
                                  if self.autocorrelation_time is not None
                                  else None))

    def cold_chain(self) -> MCMCSamples:
        return self.at_temperature(0)

    def subsample(self, n: int, rng=None, *,
                  generator: torch.Generator | None = None
                  ) -> "PTMCMCSamples":
        """``n`` (step, walker) entries of every rung, drawn without
        replacement and independently per rung (a shared index would keep
        the rungs step-aligned, against the independence the evidence
        errors assume), from ``generator``, or one seeded from ``rng`` (a
        numpy Generator, a fresh one by default)."""
        n_temps = self.n_temperatures
        flat = self.chain.reshape(n_temps, -1, self.dims)
        total = flat.shape[1]
        if n > total:
            raise ValueError(
                f"Cannot subsample {n} from {total} samples per temperature")
        if generator is None:
            rng = rng or np.random.default_rng()
            generator = torch.Generator(device=self.x.device)
            generator.manual_seed(int(rng.integers(2**63)))
        idx = torch.stack([
            torch.randperm(total, generator=generator,
                           device=generator.device)[:n]
            for _ in range(n_temps)]).to(self.x.device)

        def pick(value):
            v = self._reshape_like_chain(value).reshape(n_temps, -1)
            return torch.take_along_dim(v, idx, dim=1).reshape(-1)

        return self._with(
            torch.take_along_dim(flat, idx[:, :, None], dim=1)
            .reshape(-1, self.dims), pick, (n_temps, n, 1),
            burn_in=self.burn_in, thin=self.thin)

    def _ladder_logl(self, burn_in_fraction: float | None,
                     correlated: bool):
        """``(betas, logl, tau)``, the rungs ordered prior to posterior:
        betas (T,) ascending, logl (T, S) after the burn-in, tau each
        rung's logL autocorrelation time (ones unless ``correlated``)."""
        if self.betas is None:
            raise ValueError(
                "This ladder has no inverse temperatures (betas=None); "
                "evidence estimation needs them.")
        if self.log_likelihood is None:
            raise ValueError(
                "Evidence estimation needs per-sample log-likelihoods.")
        by_rung = to_numpy(self._reshape_like_chain(self.log_likelihood))
        if burn_in_fraction:
            skip = int(round(by_rung.shape[1] * burn_in_fraction))
            by_rung = by_rung[:, skip:]
        if by_rung[0].size == 0:
            raise ValueError(
                "Burn-in removed every step of the chain; lower "
                "burn_in_fraction or run longer chains.")
        ascending = np.argsort(np.asarray(self.betas))
        betas = np.asarray(self.betas, dtype=np.float64)[ascending]
        by_rung = np.asarray(by_rung, dtype=np.float64)[ascending]
        tau = (np.array([_integrated_autocorr_1d(r) for r in by_rung])
               if correlated else np.ones(len(betas)))
        return betas, by_rung.reshape(len(betas), -1), tau

    def log_evidence_thermodynamic_integration(
            self, burn_in_fraction: float | None = 0.1,
            method: str = "variance",
            correlated: bool = True) -> tuple[float, float]:
        """Thermodynamic-integration log Z over the ladder (the trapezoid
        of the rung means of logL). ``method``: "variance", the
        delta-method sampling error; "coarse", ``|I_full - I_half|`` from
        every other rung; "total", the sampling error plus the Richardson
        estimate of the remaining trapezoid bias, ``|I_full - I_half| /
        3``."""
        betas, logl, tau = self._ladder_logl(burn_in_fraction, correlated)
        rung_means = logl.mean(axis=1)
        logz = float(np.trapezoid(rung_means, betas))
        err = float(_ti_spread_error(betas, logl - rung_means[:, None], tau))
        if method == "variance":
            return logz, err
        keep = sorted(set(range(0, len(betas), 2)) | {len(betas) - 1})
        coarse = float(np.trapezoid(rung_means[keep], betas[keep]))
        if method == "coarse":
            return logz, abs(logz - coarse)
        if method == "total":
            return logz, err + abs(logz - coarse) / 3.0
        raise ValueError(
            f"Unknown TI error method {method!r}; expected 'variance', "
            "'coarse' or 'total'.")

    def log_evidence_stepping_stone(
            self, burn_in_fraction: float | None = 0.1,
            correlated: bool = True) -> tuple[float, float]:
        """Stepping-stone log Z, the product of the rungs' power ratios;
        needs a rung at beta = 0. Each rung is centred on its maximum (so
        every exponent is at most 0), an all-``-inf`` rung on 0, and the
        base ``sum dbeta_j ref_j`` added back in float64."""
        betas, logl, tau = self._ladder_logl(burn_in_fraction, correlated)
        if betas[0] != 0.0:
            raise ValueError(
                "The stepping-stone estimator needs a rung at beta=0 "
                f"(the prior); the hottest rung supplied is at "
                f"beta={betas[0]}.")
        rung_ref = logl.max(axis=1)
        rung_ref = np.where(np.isfinite(rung_ref), rung_ref, 0.0)
        shifted, err = _stepping_stone_reduce(
            betas, logl - rung_ref[:, None], tau)
        base = float(np.sum(np.diff(betas) * rung_ref[:-1]))
        return base + float(shifted), float(err)

    def plot_chain(self, beta_index: int, n_walkers: int | None = None,
                   **kwargs):
        """Trace of every parameter of rung ``beta_index`` per step."""
        plt = require_module("matplotlib.pyplot", "plotting")
        chain = to_numpy(self.chain)[beta_index]  # (n_steps, n_walkers, d)
        if n_walkers is not None:
            chain = chain[:, :n_walkers]
        d = chain.shape[-1]
        fig, axes = plt.subplots(d, 1, sharex=True, figsize=(8, 2 * d))
        if d == 1:
            axes = [axes]
        for k, ax in enumerate(axes):
            ax.plot(chain[:, :, k], alpha=0.5, **kwargs)
            ax.set_ylabel(self.parameters[k])
        axes[-1].set_xlabel("step")
        return fig

    def plot_ladder(self, swap_floor: float = 0.15):
        """Ladder diagnostics: the swap acceptance of each adjacent pair at
        its midpoint (pairs under ``swap_floor`` flagged) and the move
        acceptance of each rung, the rungs drawn as ticks."""
        plt = require_module("matplotlib.pyplot", "plotting")
        if (self.betas is None or self.swap_acceptance is None
                or self.move_acceptance is None):
            raise ValueError(
                "plot_ladder needs betas and the recorded acceptance "
                "diagnostics (run the PT sampler to get them).")
        betas = np.asarray(self.betas, dtype=float)
        swap = np.asarray(self.swap_acceptance, dtype=float)
        move = np.asarray(self.move_acceptance, dtype=float)
        mids = 0.5 * (betas[:-1] + betas[1:])
        fig, (ax_swap, ax_move) = plt.subplots(2, 1, sharex=True,
                                               figsize=(8, 5))
        low = swap < swap_floor
        ax_swap.plot(mids, swap, "o-", color="C0")
        if low.any():
            ax_swap.plot(mids[low], swap[low], "o", color="C3",
                         label=f"below floor ({swap_floor})")
            ax_swap.legend()
        ax_swap.axhline(swap_floor, color="C3", ls="--", lw=0.8)
        ax_swap.set_ylabel("swap acceptance")
        ax_swap.set_ylim(0, 1.05)
        ax_move.plot(betas, move, "s-", color="C1")
        ax_move.set_ylabel("move acceptance")
        ax_move.set_ylim(0, 1.05)
        ax_move.set_xlabel(r"inverse temperature $\beta$")
        for ax in (ax_swap, ax_move):
            for b in betas:
                ax.axvline(b, color="0.85", lw=0.5, zorder=0)
        fig.tight_layout()
        return fig
