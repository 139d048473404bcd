"""Stable reductions the sampler stack is built on.

Counterpart of ``aspire_tpu/ops/special.py`` (single device only: the
``axis_name`` collectives of the JAX package are not ported).
"""

from __future__ import annotations

import math

import torch


def logsumexp(log_w: torch.Tensor) -> torch.Tensor:
    """``log(sum(exp(log_w)))`` over all elements; all ``-inf`` gives
    ``-inf`` and a ``+inf`` element propagates."""
    m = torch.max(log_w)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    x = log_w - m_safe
    x = torch.where(finite, torch.clamp(x, max=0.0), x)
    return m_safe + torch.log(torch.sum(torch.exp(x)))


def effective_sample_size(log_w: torch.Tensor) -> torch.Tensor:
    """Kish ESS ``exp(2 lse(log_w) - lse(2 log_w))``."""
    return torch.exp(2 * logsumexp(log_w) - logsumexp(2 * log_w))


def logit(x: torch.Tensor, eps: float | None = None) -> torch.Tensor:
    """``log(x) - log1p(-x)``, ``x`` first clamped to ``[eps, 1 - eps]``
    with an ``eps``."""
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def log_evidence_from_log_weights(
    log_w: torch.Tensor, n: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Log evidence and its delta-method standard error from IS
    log-weights (max-shifted for stability)."""
    if n is None:
        n = log_w.shape[0]
    log_z = logsumexp(log_w) - math.log(float(n))
    m = torch.max(log_w)
    m_finite = torch.isfinite(m)
    m = torch.where(m_finite, m, torch.zeros_like(m))
    u = log_w - m
    u = torch.exp(torch.where(m_finite, torch.clamp(u, max=0.0), u))
    mean_w = torch.sum(u) / n
    var_w = torch.sum(u**2) / n - mean_w**2
    var_log_z = torch.where(
        mean_w > 0, var_w / (n * mean_w**2),
        torch.full_like(mean_w, float("nan")),
    )
    return log_z, torch.sqrt(var_log_z)
