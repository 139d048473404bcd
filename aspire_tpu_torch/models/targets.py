"""Analytic target posteriors (counterpart of ``aspire_tpu/models/targets.py``).

Each problem exposes ``log_likelihood(samples)`` / ``log_prior(samples)``
over ``samples.x`` of shape ``(n, d)``, ``draw_initial_samples(rng, n)``
and, for the problems the whole-chain kernel evaluates in-kernel,
``kernel_target(device)`` -> ``(target id, float32 constants)``. The ids
and constant layouts match ``target_densities`` in ``csrc/chain.cu``;
:func:`target_densities` is the same arithmetic in torch (the plain
version the kernel is held against).

A user's own target opts into the whole-chain kernel the same way (the
port's form of the JAX package's ``log_likelihood_td``/``log_prior_td``
protocol): ``kernel_target(device)`` on the object both callables are
bound to returns ``(KernelSource(name, cuda), constants)``, or, for bare
callables, ``log_likelihood`` and ``log_prior`` both carry the same
``kernel_target`` attribute. ``cuda`` defines::

    template <int D, class X>
    __device__ void user_target(const float* c, const X& x, float& lpi,
                                float& ll);

where ``x[i]`` reads coordinate i of the point in data space (``X`` is a
register array, or a view of shared memory in the wide form), ``c`` is
``constants`` (a float32 tensor of any length on the device, made once
per device, e.g. by :func:`kernel_constants`, so a CUDA graph can capture
it), and ``lpi``/``ll`` receive the log-prior and log-likelihood (NaN is
taken as -inf). The source is compiled into a chain kernel instance of
its own at first use (``ops/_build.py::build_user``), cached by a hash of
the kernel sources, the flags, the flow's configuration and the source.
The user's torch ``log_likelihood``/``log_prior`` are its plain version:
the split chain and the CPU run them. A source that does not build
raises with nvcc's message; nothing falls back to the split chain.

A density makes no tensor from host data after its first call on a
device: its constants are kept per ``(device, dtype)``
(:func:`_constant`), so the device ladder can capture it in a CUDA graph
(a pageable host-to-device copy cannot be captured).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GAUSSIAN_MIXTURE = 1
GAUSSIAN = 2
HIERARCHICAL = 3
ROSENBROCK = 4
FUNNEL = 5

_LOG_2PI = math.log(2 * math.pi)


def _constant(owner, name: str, value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor on ``like``'s device and dtype, made once per
    ``(name, device, dtype)`` and kept on ``owner``."""
    cache = owner.__dict__.setdefault("_constants", {})
    key = (name, like.device, like.dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(value), dtype=like.dtype,
                                     device=like.device)
    return cache[key]


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """A user target's body as CUDA source (the module docstring's
    ``user_target``), compiled into a chain kernel instance of its own."""

    name: str
    cuda: str


def _neg_inf_if_nan(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(v), torch.full_like(v, -math.inf), v)


def target_densities(target_id: int, consts: torch.Tensor,
                     x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(log_prior, log_likelihood)`` of an in-kernel target; NaN -> -inf."""
    d = x.shape[-1]
    if target_id == GAUSSIAN_MIXTURE:
        mu1, mu2 = consts[:d], consts[d:2 * d]
        v1, v2 = consts[2 * d], consts[2 * d + 1]
        c1 = (-0.5 * torch.sum((x - mu1) ** 2, dim=-1) / v1
              - 0.5 * d * _LOG_2PI - 0.5 * d * torch.log(v1))
        c2 = (-0.5 * torch.sum((x - mu2) ** 2, dim=-1) / v2
              - 0.5 * d * _LOG_2PI - 0.5 * d * torch.log(v2))
        ll = torch.logaddexp(c1, c2) - math.log(2.0)
        lpi = -0.5 * torch.sum(x**2, dim=-1) - 0.5 * d * _LOG_2PI
    elif target_id == GAUSSIAN:
        mu, sigma, lower, upper = consts[0], consts[1], consts[2], consts[3]
        ll = torch.sum(
            -0.5 * ((x - mu) / sigma) ** 2
            - 0.5 * torch.log(2 * math.pi * sigma**2),
            dim=-1,
        )
        inside = torch.all((x >= lower) & (x <= upper), dim=-1)
        lpi = torch.where(inside, -d * torch.log(upper - lower),
                          torch.full_like(ll, -math.inf))
    elif target_id == HIERARCHICAL:
        ll, lpi = _hierarchical(consts[:d - 2], x)
    elif target_id == ROSENBROCK:
        ll = _rosenbrock(x)
        lpi = _box(x, consts[0], consts[1])
    elif target_id == FUNNEL:
        ll, lpi = _funnel(x, consts[0], consts[1])
    else:
        raise ValueError(f"unknown in-kernel target id {target_id}")
    return _neg_inf_if_nan(lpi), _neg_inf_if_nan(ll)


def _hierarchical(y: torch.Tensor, x: torch.Tensor):
    """``(log_likelihood, log_prior)`` of :class:`HierarchicalProblem` with
    data ``y`` at ``x = [m, s, theta]``."""
    m, s, theta = x[..., 0], x[..., 1], x[..., 2:]
    ll = torch.sum(-0.5 * (y - theta) ** 2 - 0.5 * _LOG_2PI, dim=-1)
    scale = torch.exp(s)
    log_p_m = -0.5 * (m / 5.0) ** 2 - 0.5 * math.log(2 * math.pi * 25.0)
    log_p_s = -0.5 * s**2 - 0.5 * _LOG_2PI
    log_p_theta = torch.sum(
        -0.5 * ((theta - m[..., None]) / scale[..., None]) ** 2
        - torch.log(scale[..., None]) - 0.5 * _LOG_2PI,
        dim=-1,
    )
    return ll, log_p_m + log_p_s + log_p_theta


def _log(v):
    """log of a number or of a tensor (a target's constants are numbers in
    its own methods and tensor entries in :func:`target_densities`)."""
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _rosenbrock(x: torch.Tensor) -> torch.Tensor:
    """The Rosenbrock log-likelihood, ``-sum 100 (x_{i+1} - x_i^2)^2 +
    (1 - x_i)^2``."""
    return -torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                      + (1 - x[..., :-1]) ** 2, dim=-1)


def _box(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """The uniform log-prior on the closed box ``[lower, upper]^d``:
    ``-d log(upper - lower)`` inside, -inf outside."""
    inside = torch.all((x >= lower) & (x <= upper), dim=-1)
    log_p = -x.shape[-1] * _log(upper - lower)
    return torch.where(inside, log_p, torch.full_like(x[..., 0], -math.inf))


def _funnel(x: torch.Tensor, scale, prior_scale):
    """``(log_likelihood, log_prior)`` of :class:`FunnelProblem` at
    ``x = [v, rest]``: v ~ N(0, scale^2), rest ~ N(0, e^v) in the
    likelihood, every coordinate ~ N(0, prior_scale^2) in the prior, the
    constant terms ``log 2 pi scale^2`` and ``log 2 pi prior_scale^2``
    formed once, as the chain kernel forms them. In float32 exp(-v)
    overflows below v ~ -88: the likelihood is then -inf, or NaN where
    every rest coordinate is 0 (0 * inf), which the samplers and
    :func:`target_densities` turn to -inf."""
    d = x.shape[-1]
    v, rest = x[..., 0], x[..., 1:]
    log_p_v = -0.5 * (v / scale) ** 2 - 0.5 * _log(2 * math.pi * scale**2)
    log_p_rest = (-0.5 * torch.sum(rest**2, dim=-1) * torch.exp(-v)
                  - 0.5 * (d - 1) * (_LOG_2PI + v))
    lpi = (torch.sum(-0.5 * (x / prior_scale) ** 2, dim=-1)
           - d * (0.5 * _log(2 * math.pi * prior_scale**2)))
    return log_p_v + log_p_rest, lpi


@dataclasses.dataclass
class Problem:
    dims: int

    @property
    def parameters(self) -> list[str]:
        return [f"x_{i}" for i in range(self.dims)]

    prior_bounds = None
    #: analytic log Z where there is one (the quadrature truths of the
    #: validation rows are no part of the package, as in the JAX package)
    true_log_evidence = None

    def log_likelihood(self, samples):
        raise NotImplementedError

    def log_prior(self, samples):
        raise NotImplementedError

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        raise NotImplementedError

    def kernel_target(self, device="cpu"):
        """``(id or KernelSource, constants)`` for the chain kernel, or
        None."""
        return None


@dataclasses.dataclass
class GaussianProblem(Problem):
    """N(mu, sigma) likelihood x U(lower, upper)^d prior."""

    dims: int = 4
    mu: float = 2.0
    sigma: float = 1.0
    lower: float = -10.0
    upper: float = 10.0

    @property
    def prior_bounds(self):
        return {p: [self.lower, self.upper] for p in self.parameters}

    @property
    def true_log_evidence(self):
        return -self.dims * math.log(self.upper - self.lower)

    def log_likelihood(self, samples):
        x = samples.x
        return torch.sum(
            -0.5 * ((x - self.mu) / self.sigma) ** 2
            - 0.5 * math.log(2 * math.pi * self.sigma**2),
            dim=-1,
        )

    def log_prior(self, samples):
        x = samples.x
        inside = torch.all((x >= self.lower) & (x <= self.upper), dim=-1)
        log_p = -self.dims * math.log(self.upper - self.lower)
        return torch.where(inside, torch.full_like(x[:, 0], log_p),
                           torch.full_like(x[:, 0], -math.inf))

    def kernel_target(self, device="cpu"):
        consts = [self.mu, self.sigma, self.lower, self.upper]
        return GAUSSIAN, torch.tensor(consts, dtype=torch.float32,
                                      device=device)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        return rng.normal(self.mu + 0.5, self.sigma, size=(n, self.dims))


@dataclasses.dataclass
class GaussianMixtureProblem(Problem):
    """Two-Gaussian mixture likelihood x standard-normal prior."""

    dims: int = 4
    separation: float = 2.0

    def __post_init__(self):
        d = self.dims
        self.mu1 = self.separation * np.ones(d)
        self.mu2 = -self.separation * np.ones(d)
        self.var1 = 0.5
        self.var2 = 1.0

    def _comp(self, x, name, var):
        d = self.dims
        mu = _constant(self, name, getattr(self, name), x)
        return (-0.5 * torch.sum((x - mu) ** 2, dim=-1) / var
                - 0.5 * d * _LOG_2PI - 0.5 * d * math.log(var))

    def log_likelihood(self, samples):
        x = samples.x
        return torch.logaddexp(self._comp(x, "mu1", self.var1),
                               self._comp(x, "mu2", self.var2)
                               ) - math.log(2.0)

    def log_prior(self, samples):
        x = samples.x
        return -0.5 * torch.sum(x**2, dim=-1) - 0.5 * self.dims * _LOG_2PI

    def kernel_target(self, device="cpu"):
        consts = np.concatenate([self.mu1, self.mu2, [self.var1, self.var2]])
        return GAUSSIAN_MIXTURE, torch.tensor(consts, dtype=torch.float32,
                                              device=device)

    def true_log_evidence(self) -> float:
        """Analytic log Z: each component convolved with the N(0, I) prior."""
        d = self.dims

        def at_zero(mu, var):
            return np.exp(-0.5 * np.sum(mu**2) / var) / (
                2 * np.pi * var) ** (d / 2)

        return float(np.log(0.5 * at_zero(self.mu1, 1 + self.var1)
                            + 0.5 * at_zero(self.mu2, 1 + self.var2)))

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        offset_1 = rng.uniform(-3, 3, size=(self.dims,))
        offset_2 = rng.uniform(-3, 3, size=(self.dims,))
        return np.concatenate(
            [
                rng.normal(self.mu1 - offset_1, 1, size=(n // 2, self.dims)),
                rng.normal(self.mu2 - offset_2, 1,
                           size=(n - n // 2, self.dims)),
            ],
            axis=0,
        )


def kernel_constants(owner, values, device):
    """The in-kernel constants ``values`` as float32 on ``device``, made
    once per device and kept on ``owner`` (as :func:`_constant`), so a
    device ladder built on them captures no host copy."""
    like = torch.empty(0, dtype=torch.float32, device=device)
    return _constant(owner, "kernel_target", values, like)


@dataclasses.dataclass
class RosenbrockProblem(Problem):
    """Rosenbrock likelihood x uniform prior (BASELINE.json config 4)."""

    dims: int = 2
    lower: float = -5.0
    upper: float = 5.0

    @property
    def prior_bounds(self):
        return {p: [self.lower, self.upper] for p in self.parameters}

    def log_likelihood(self, samples):
        return _rosenbrock(samples.x)

    def log_prior(self, samples):
        return _box(samples.x, self.lower, self.upper)

    def kernel_target(self, device="cpu"):
        return ROSENBROCK, kernel_constants(self, [self.lower, self.upper],
                                            device)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        """Points along the banana, x_{i+1} = x_i^2 + N(0, 0.5^2), clipped
        to the box less 0.1 on each side."""
        x0 = rng.normal(1.0, 1.0, size=(n, 1))
        cols = [x0]
        for _ in range(self.dims - 1):
            cols.append(cols[-1] ** 2 + rng.normal(0, 0.5, size=(n, 1)))
        x = np.concatenate(cols, axis=1)
        return np.clip(x, self.lower + 0.1, self.upper - 0.1)


@dataclasses.dataclass
class FunnelProblem(Problem):
    """Neal's funnel as a likelihood x wide-normal prior."""

    dims: int = 10
    scale: float = 3.0
    #: scale of the wide-normal prior (the quadrature truth of
    #: ``benchmarks/validate.py`` reads it too)
    prior_scale: float = 10.0

    def log_likelihood(self, samples):
        return _funnel(samples.x, self.scale, self.prior_scale)[0]

    def log_prior(self, samples):
        return _funnel(samples.x, self.scale, self.prior_scale)[1]

    def kernel_target(self, device="cpu"):
        return FUNNEL, kernel_constants(self, [self.scale, self.prior_scale],
                                        device)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        v = rng.normal(0, self.scale, size=(n, 1))
        rest = rng.normal(size=(n, self.dims - 1)) * np.exp(v / 2)
        return np.concatenate([v, rest], axis=1)


@dataclasses.dataclass
class HierarchicalProblem(Problem):
    """d-dimensional hierarchical Gaussian posterior (BASELINE config 5).

    A global mean ``m`` and log-scale ``s`` with per-group effects:
    x = [m, s, theta_1..theta_{d-2}]; observations y_i ~ N(theta_i, 1),
    theta_i ~ N(m, exp(s)), m ~ N(0, 25), s ~ N(0, 1). ``y_obs`` comes from
    ``numpy.random.default_rng(seed)``, as in the JAX package, so both see
    the same data.
    """

    dims: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.y_obs = rng.normal(1.0, 1.2, size=(self.dims - 2,))

    def _y(self, x: torch.Tensor) -> torch.Tensor:
        return _constant(self, "y_obs", self.y_obs, x)

    def log_likelihood(self, samples):
        x = samples.x
        return _hierarchical(self._y(x), x)[0]

    def log_prior(self, samples):
        x = samples.x
        return _hierarchical(self._y(x), x)[1]

    def kernel_target(self, device="cpu"):
        return HIERARCHICAL, torch.tensor(self.y_obs, dtype=torch.float32,
                                          device=device)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        m = rng.normal(1.0, 0.5, size=(n, 1))
        s = rng.normal(0.0, 0.3, size=(n, 1))
        theta = rng.normal(self.y_obs, 1.0, size=(n, self.dims - 2))
        return np.concatenate([m, s, theta], axis=1)

    def log_evidence_quadrature(self, m_points: int = 2801,
                                s_points: int = 2001) -> float:
        """log Z by quadrature: theta integrates out (y_i ~ N(m, 1 +
        e^{2s}) given m and s), leaving a 2-d integral over m and s,
        summed on an (m_points, s_points) grid over m in [-15, 15] and
        s in [-10, 10] (the trapezoid rule, in float64 and log space)."""
        y = np.asarray(self.y_obs, dtype=np.float64)
        m = np.linspace(-15.0, 15.0, m_points)[:, None]
        s = np.linspace(-10.0, 10.0, s_points)[None, :]
        var = 1.0 + np.exp(2.0 * s)
        # sum_i log N(y_i; m, var) from the sufficient statistics of y.
        sq = (np.sum(y**2) - 2.0 * m * np.sum(y) + y.size * m**2)
        log_f = (-0.5 * sq / var - 0.5 * y.size * np.log(2 * np.pi * var)
                 - 0.5 * m**2 / 25.0 - 0.5 * np.log(2 * np.pi * 25.0)
                 - 0.5 * s**2 - 0.5 * np.log(2 * np.pi))
        w = np.ones_like(log_f)
        w[0, :] *= 0.5
        w[-1, :] *= 0.5
        w[:, 0] *= 0.5
        w[:, -1] *= 0.5
        top = log_f.max()
        cell = (m[1, 0] - m[0, 0]) * (s[0, 1] - s[0, 0])
        return float(top + np.log(np.sum(w * np.exp(log_f - top)) * cell))


_PROBLEMS = {
    "gaussian": GaussianProblem,
    "gaussian_mixture": GaussianMixtureProblem,
    "rosenbrock": RosenbrockProblem,
    "funnel": FunnelProblem,
    "hierarchical": HierarchicalProblem,
}


def get_problem(name: str, **kwargs) -> Problem:
    try:
        return _PROBLEMS[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"Unknown problem '{name}'. Choose from {sorted(_PROBLEMS)}"
        ) from None
