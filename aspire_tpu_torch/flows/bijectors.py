"""Elementwise bijector math: affine, rational-quadratic spline, normal base.

Counterpart of ``aspire_tpu/flows/bijectors.py`` with the same formulas,
so the plain path agrees with the JAX package to float64 round-off. The
CUDA kernels (``csrc/common.cuh``) implement the same arithmetic per
particle.
"""

from __future__ import annotations

import math

import torch

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without a cut-over threshold (as ``jax.nn``)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def affine_forward(x, shift, log_scale):
    return x * torch.exp(log_scale) + shift, log_scale


def affine_inverse(y, shift, log_scale):
    return (y - shift) * torch.exp(-log_scale), -log_scale


def constrain_log_scale(raw, bound: float = 3.0):
    return bound * torch.tanh(raw / bound)


def _parse_spline_params(raw, num_bins: int, tail_bound: float):
    """Raw ``(..., 3K - 1)`` params -> knots and derivatives ``(..., K+1)``."""
    K = num_bins
    widths = torch.softmax(raw[..., :K], dim=-1)
    widths = DEFAULT_MIN_BIN_WIDTH + (1 - DEFAULT_MIN_BIN_WIDTH * K) * widths
    heights = torch.softmax(raw[..., K:2 * K], dim=-1)
    heights = (
        DEFAULT_MIN_BIN_HEIGHT + (1 - DEFAULT_MIN_BIN_HEIGHT * K) * heights
    )
    edge = torch.full_like(raw[..., :1], -tail_bound)
    x_knots = torch.cumsum(widths, dim=-1) * (2 * tail_bound) - tail_bound
    x_knots = torch.cat([edge, x_knots], dim=-1)
    y_knots = torch.cumsum(heights, dim=-1) * (2 * tail_bound) - tail_bound
    y_knots = torch.cat([edge, y_knots], dim=-1)
    derivs = DEFAULT_MIN_DERIVATIVE + softplus(raw[..., 2 * K:])
    ones = torch.ones_like(derivs[..., :1])
    derivs = torch.cat([ones, derivs, ones], dim=-1)
    return x_knots, y_knots, derivs


def rational_quadratic_spline(inputs, raw_params, num_bins: int,
                              tail_bound: float = 5.0,
                              inverse: bool = False):
    """Monotonic RQS with identity tails outside ``[-B, B]``.

    Returns ``(outputs, elementwise log|det|)``; ``inverse=True`` is the
    data -> latent (density) direction of a coupling layer.
    """
    x_knots, y_knots, derivs = _parse_spline_params(
        raw_params, num_bins, tail_bound
    )
    inside = (inputs > -tail_bound) & (inputs < tail_bound)
    safe = torch.clamp(inputs, -tail_bound, tail_bound)
    ref_knots = y_knots if inverse else x_knots
    k = torch.sum(safe[..., None] >= ref_knots[..., :-1], dim=-1) - 1
    k = torch.clamp(k, 0, num_bins - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, k)[..., 0]

    x_k = take(x_knots[..., :-1])
    x_k1 = take(x_knots[..., 1:])
    y_k = take(y_knots[..., :-1])
    y_k1 = take(y_knots[..., 1:])
    d_k = take(derivs[..., :-1])
    d_k1 = take(derivs[..., 1:])
    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w

    if not inverse:
        xi = torch.clamp((safe - x_k) / w, 0.0, 1.0)
        xi_1m = 1 - xi
        num = h * (s * xi**2 + d_k * xi * xi_1m)
        den = s + (d_k1 + d_k - 2 * s) * xi * xi_1m
        outputs = y_k + num / den
        log_det = (
            2 * torch.log(s)
            + torch.log(d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2)
            - 2 * torch.log(den)
        )
    else:
        y_rel = safe - y_k
        a = h * (s - d_k) + y_rel * (d_k1 + d_k - 2 * s)
        b = h * d_k - y_rel * (d_k1 + d_k - 2 * s)
        c = -s * y_rel
        disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
        xi = torch.clamp((2 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
        xi_1m = 1 - xi
        outputs = xi * w + x_k
        den = s + (d_k1 + d_k - 2 * s) * xi * xi_1m
        log_det = -(
            2 * torch.log(s)
            + torch.log(d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2)
            - 2 * torch.log(den)
        )
    outputs = torch.where(inside, outputs, inputs)
    log_det = torch.where(inside, log_det, torch.zeros_like(log_det))
    return outputs, log_det


def standard_normal_log_prob(z: torch.Tensor) -> torch.Tensor:
    d = z.shape[-1]
    return -0.5 * torch.sum(z**2, dim=-1) - 0.5 * d * math.log(2 * math.pi)


def standard_normal_sample(shape, generator: torch.Generator,
                           dtype=torch.float32, device="cpu"):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)
