"""Samplers: importance, adaptive-tempered SMC with tpCN/pCN, stretch,
RWMH, MALA, HMC and NUTS mutations, and the standalone pCN, ensemble and
parallel-tempered MCMC samplers."""

from __future__ import annotations

from .base import Sampler  # noqa: F401
from .importance import ImportanceSampler  # noqa: F401
from .mcmc import (  # noqa: F401
    EnsembleSampler,
    MCMCSampler,
    ParallelTemperedSampler,
    PCNSampler,
)
from .smc import (  # noqa: F401
    BetaScheduleError,
    EnsembleSMC,
    GradientSMC,
    HMCSMC,
    MALASMC,
    NUTSSMC,
    PCNSMC,
    RWMHSMC,
    SMCSampler,
)

SAMPLER_REGISTRY: dict[str, type] = {
    "importance": ImportanceSampler,
    "smc": PCNSMC,
    "pcn_smc": PCNSMC,
    "minipcn_smc": PCNSMC,
    "ensemble_smc": EnsembleSMC,
    "emcee_smc": EnsembleSMC,
    "blackjax_smc": HMCSMC,
    "hmc_smc": HMCSMC,
    "nuts_smc": NUTSSMC,
    "mala_smc": MALASMC,
    "rwmh_smc": RWMHSMC,
    "mcmc": PCNSampler,
    "pcn": PCNSampler,
    "minipcn": PCNSampler,
    "ensemble": EnsembleSampler,
    "emcee": EnsembleSampler,
    "ptmcmc": ParallelTemperedSampler,
    "parallel_tempered": ParallelTemperedSampler,
}


def get_sampler_class(name: str) -> type:
    key = name.lower()
    try:
        return SAMPLER_REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"Unknown sampler '{name}'. Known samplers: "
            f"{sorted(SAMPLER_REGISTRY)}") from None
