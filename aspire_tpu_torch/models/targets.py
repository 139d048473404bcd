"""Analytic target posteriors (counterpart of ``aspire_tpu/models/targets.py``).

Each problem exposes ``log_likelihood(samples)`` / ``log_prior(samples)``
over ``samples.x`` of shape ``(n, d)``, ``draw_initial_samples(rng, n)``
and, for the problems the whole-chain kernel evaluates in-kernel,
``kernel_target(device)`` -> ``(target id, float32 constants)``. The ids
and constant layouts match ``target_densities`` in ``csrc/chain.cu``;
:func:`target_densities` is the same arithmetic in torch (the plain
version the kernel is held against).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GAUSSIAN_MIXTURE = 1
GAUSSIAN = 2

_LOG_2PI = math.log(2 * math.pi)


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
    else:
        raise ValueError(f"unknown in-kernel target id {target_id}")
    return _neg_inf_if_nan(lpi), _neg_inf_if_nan(ll)


@dataclasses.dataclass
class Problem:
    dims: int

    @property
    def parameters(self) -> list[str]:
        return [f"x_{i}" for i in range(self.dims)]

    prior_bounds = None

    def kernel_target(self, device="cpu"):
        """``(id, constants)`` for the in-kernel target, or None."""
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

    def _comp(self, x, mu, var):
        d = self.dims
        mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
        return (-0.5 * torch.sum((x - mu) ** 2, dim=-1) / var
                - 0.5 * d * _LOG_2PI - 0.5 * d * math.log(var))

    def log_likelihood(self, samples):
        x = samples.x
        return torch.logaddexp(self._comp(x, self.mu1, self.var1),
                               self._comp(x, self.mu2, self.var2)
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
