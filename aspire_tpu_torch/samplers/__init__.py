"""Samplers: importance and adaptive-tempered SMC (the MCMC family,
ensemble, gradient-based and parallel-tempered samplers are not ported)."""

from __future__ import annotations

from .base import Sampler  # noqa: F401
from .importance import ImportanceSampler  # noqa: F401
from .smc import BetaScheduleError, PCNSMC, SMCSampler  # noqa: F401

SAMPLER_REGISTRY: dict[str, type] = {
    "importance": ImportanceSampler,
    "smc": PCNSMC,
    "pcn_smc": PCNSMC,
    "minipcn_smc": PCNSMC,
}


def get_sampler_class(name: str) -> type:
    try:
        return SAMPLER_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown sampler '{name}'. Known samplers: "
            f"{sorted(SAMPLER_REGISTRY)}") from None
