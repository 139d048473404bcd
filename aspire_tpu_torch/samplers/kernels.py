"""MCMC mutation kernels over particle batches: the per-step ("split") chain.

Counterpart of the pCN / tpCN / RWMH part of
``aspire_tpu/samplers/kernels.py``. Every kernel advances the whole
``(n, d)`` particle array per step; randomness comes from an explicit
``torch.Generator``. The target density of each step goes through the
flow's ``forward``, so on a CUDA tensor the coupling kernel evaluates it.
The whole-chain kernel (:mod:`aspire_tpu_torch.ops.fused_mutation`)
replaces this loop where its predicate holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


@dataclass
class ChainState:
    x: torch.Tensor  # (n, d) positions
    log_prob: torch.Tensor  # (n,)
    step_size: torch.Tensor  # 0-d, adapted
    n_accept: torch.Tensor  # (n,)
    n_evals: int = 0


class GaussianReference(NamedTuple):
    mean: torch.Tensor  # (d,)
    chol: torch.Tensor  # (d, d) lower Cholesky factor of the covariance
    inv_chol: torch.Tensor  # (d, d)


class ChainStats(NamedTuple):
    tau: torch.Tensor
    mixing: torch.Tensor


def fit_gaussian_reference(x: torch.Tensor,
                           jitter: float = 1e-6) -> GaussianReference:
    """Ensemble mean and covariance of the particles."""
    mean = torch.mean(x, dim=0)
    xc = x - mean
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    cov = (xc.T @ xc) / x.shape[0] + jitter * eye
    chol = torch.linalg.cholesky(cov)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    return GaussianReference(mean=mean, chol=chol, inv_chol=inv_chol)


def mahalanobis_sq(ref: GaussianReference, x: torch.Tensor) -> torch.Tensor:
    z = (x - ref.mean) @ ref.inv_chol.T
    return torch.sum(z**2, dim=-1)


def monotone_beta_bisect(ok: Callable, beta_prev, tol: float, dtype,
                         device) -> torch.Tensor:
    """Largest ``beta`` in ``[beta_prev, 1]`` whose predicate holds.

    Jumps to 1 when ``ok(1)`` holds, otherwise a fixed 54-halving
    bisection (no data-dependent trip count, so nothing syncs the host).
    """
    one = torch.ones((), dtype=dtype, device=device)
    prev = torch.as_tensor(beta_prev, dtype=dtype, device=device)
    lo = torch.where(ok(one), one, prev)
    hi = one
    for _ in range(54):
        done = hi - lo <= tol
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        new_lo = torch.where(good, mid, lo)
        new_hi = torch.where(good, hi, mid)
        lo = torch.where(done, lo, new_lo)
        hi = torch.where(done, hi, new_hi)
    return lo


def _gamma_rejection(generator, alpha: float, n: int, dtype, device):
    """Marsaglia-Tsang Gamma(alpha, 1) for a non-half-integer shape."""
    a = alpha if alpha >= 1 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while bool(todo.any()):
        idx = torch.nonzero(todo)[:, 0]
        m = idx.numel()
        x = torch.randn(m, generator=generator, dtype=dtype, device=device)
        u = torch.rand(m, generator=generator, dtype=dtype, device=device)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out[idx[ok]] = d * v[ok]
        todo[idx[ok]] = False
    if alpha < 1:
        u = torch.rand(n, generator=generator, dtype=dtype, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def gamma_fixed_shape(generator, alpha: float, n: int, dtype, device):
    """Gamma(alpha, 1); for integer ``2 alpha`` the closed construction
    ``sum of floor(alpha) exponentials (+ half a squared normal)``."""
    k = int(round(2.0 * alpha))
    if abs(2.0 * alpha - k) > 1e-9 or k <= 0:
        return _gamma_rejection(generator, alpha, n, dtype, device)
    m, odd = divmod(k, 2)
    out = torch.zeros(n, dtype=dtype, device=device)
    if m > 0:
        u = torch.rand((n, m), generator=generator, dtype=dtype,
                       device=device)
        out = -torch.sum(torch.log1p(-u), dim=-1)
    if odd:
        g = torch.randn(n, generator=generator, dtype=dtype, device=device)
        out = out + 0.5 * g**2
    return out


def adapt_step_size(step_size, accept_prob_mean, target_acceptance,
                    adaptation_rate, max_log_step: float = 0.0):
    """Robbins-Monro adaptation in log space, clipped to [-10, max]."""
    log_s = torch.log(step_size) + adaptation_rate * (
        accept_prob_mean - target_acceptance)
    return torch.exp(torch.clamp(log_s, -10.0, max_log_step)).to(
        step_size.dtype)


def mh_update(state: ChainState, generator, x_prop, lp_prop, log_alpha, *,
              target_acceptance: float, adaptation_rate: float,
              max_log_step: float = 0.0) -> ChainState:
    """NaN guard, accept/select and step adaptation, shared by kernels."""
    n = state.x.shape[0]
    log_alpha = torch.where(torch.isnan(log_alpha),
                            torch.full_like(log_alpha, -math.inf), log_alpha)
    u = torch.rand(n, generator=generator, dtype=state.x.dtype,
                   device=state.x.device)
    accept = torch.log(u) < log_alpha
    acc_prob = torch.mean(torch.exp(torch.clamp(log_alpha, max=0.0)))
    return ChainState(
        x=torch.where(accept[:, None], x_prop, state.x),
        log_prob=torch.where(accept, lp_prop, state.log_prob),
        step_size=adapt_step_size(state.step_size, acc_prob,
                                  target_acceptance, adaptation_rate,
                                  max_log_step=max_log_step),
        n_accept=state.n_accept + accept.to(state.x.dtype),
        n_evals=state.n_evals + n,
    )


def _normal(generator, like):
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def pcn_step(state: ChainState, generator, log_prob_fn: Callable,
             ref: GaussianReference, target_acceptance: float = 0.234,
             adaptation_rate: float = 0.1) -> ChainState:
    """pCN under N(mean, chol chol^T)."""
    s = torch.clamp(state.step_size, max=1.0)
    xi = _normal(generator, state.x)
    x_prop = (ref.mean
              + torch.sqrt(torch.clamp(1 - s**2, min=0.0))
              * (state.x - ref.mean) + s * xi @ ref.chol.T)
    lp_prop = log_prob_fn(x_prop)
    log_alpha = lp_prop - state.log_prob + 0.5 * (
        mahalanobis_sq(ref, x_prop) - mahalanobis_sq(ref, state.x))
    return mh_update(state, generator, x_prop, lp_prop, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate)


def tpcn_step(state: ChainState, generator, log_prob_fn: Callable,
              ref: GaussianReference, nu: float = 5.0,
              target_acceptance: float = 0.234,
              adaptation_rate: float = 0.1) -> ChainState:
    """t-preconditioned Crank-Nicolson (scale mixture of pCN steps)."""
    n, d = state.x.shape
    s = torch.clamp(state.step_size, max=1.0)
    r2_old = mahalanobis_sq(ref, state.x)
    alpha_gamma = 0.5 * (nu + d)
    w = gamma_fixed_shape(generator, alpha_gamma, n, state.x.dtype,
                          state.x.device)
    w = w / (0.5 * (nu + r2_old))
    xi = _normal(generator, state.x)
    x_prop = (ref.mean
              + torch.sqrt(torch.clamp(1 - s**2, min=0.0))
              * (state.x - ref.mean)
              + (s / torch.sqrt(w))[:, None] * (xi @ ref.chol.T))
    lp_prop = log_prob_fn(x_prop)
    r2_new = mahalanobis_sq(ref, x_prop)
    log_alpha = lp_prop - state.log_prob + alpha_gamma * (
        torch.log(nu + r2_new) - torch.log(nu + r2_old))
    return mh_update(state, generator, x_prop, lp_prop, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate)


def rwmh_step(state: ChainState, generator, log_prob_fn: Callable,
              ref: GaussianReference, target_acceptance: float = 0.234,
              adaptation_rate: float = 0.1) -> ChainState:
    """Gaussian random walk with the ensemble-covariance proposal."""
    xi = _normal(generator, state.x)
    x_prop = state.x + state.step_size * xi @ ref.chol.T
    lp_prop = log_prob_fn(x_prop)
    return mh_update(state, generator, x_prop, lp_prop,
                     lp_prop - state.log_prob,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate, max_log_step=2.3)


def lag1_autocorr_time(s1, s2, c1, n_steps: int) -> torch.Tensor:
    """AR(1) integrated autocorrelation time from deviation sums."""
    m = n_steps + 1
    mean = s1 / m
    var = s2 / m - mean**2
    cov1 = c1 / n_steps - mean**2
    rho = torch.where(var > 1e-12, cov1 / torch.clamp(var, min=1e-12),
                      torch.ones_like(var))
    rho_dim = torch.clamp(torch.mean(rho, dim=0), -0.9999, 0.9999)
    tau_dim = (1 + rho_dim) / (1 - rho_dim)
    return torch.mean(torch.clamp(tau_dim, min=1.0))


def chain_mixing_ratio(x0, s1, s2, n_steps: int) -> torch.Tensor:
    """Worst-dimension within/pooled variance ratio, in [0, 1]."""
    m = n_steps + 1
    dev_mean = s1 / m
    within = torch.mean(s2 / m - dev_mean**2, dim=0)
    walker_means = x0 + dev_mean
    grand = torch.mean(walker_means, dim=0)
    between = torch.mean((walker_means - grand) ** 2, dim=0)
    pooled = within + between
    ratio = torch.where(pooled > 1e-12,
                        within / torch.clamp(pooled, min=1e-12),
                        torch.ones_like(pooled))
    return torch.clamp(torch.min(ratio), 0.0, 1.0)


def run_chain(step_fn: Callable[[ChainState], ChainState],
              state: ChainState, n_steps: int):
    """Run ``n_steps`` steps, tracking the online AR(1)/mixing sums.

    Returns ``(final_state, ChainStats)``.
    """
    x0 = state.x
    prev_d = torch.zeros_like(x0)
    s1, s2, c1 = prev_d.clone(), prev_d.clone(), prev_d.clone()
    for _ in range(n_steps):
        state = step_fn(state)
        delta = state.x - x0
        s1 = s1 + delta
        s2 = s2 + delta**2
        c1 = c1 + delta * prev_d
        prev_d = delta
    stats = ChainStats(tau=lag1_autocorr_time(s1, s2, c1, n_steps),
                       mixing=chain_mixing_ratio(x0, s1, s2, n_steps))
    return state, stats

