"""Training and SMC diagnostics (counterpart of ``aspire_tpu/history.py``
without HDF5 persistence or plotting)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FlowHistory:
    training_loss: list = field(default_factory=list)
    validation_loss: list = field(default_factory=list)


@dataclass
class SMCHistory:
    log_norm_ratio: list = field(default_factory=list)
    log_norm_ratio_var: list = field(default_factory=list)
    beta: list = field(default_factory=list)
    ess: list = field(default_factory=list)
    ess_target: list = field(default_factory=list)
    eff_target: list = field(default_factory=list)
    mcmc_autocorr: list = field(default_factory=list)
    mcmc_acceptance: list = field(default_factory=list)
    lineage_fraction: list = field(default_factory=list)
    #: which chain ran each mutation: "fused_kernel" (the whole-chain
    #: kernel, or its plain version on a CPU tensor) or "split" (the
    #: per-step torch chain)
    mutation_route: list = field(default_factory=list)
    #: per mutation, particles whose log-prior or log-likelihood came back
    #: non-finite
    nonfinite_target: list = field(default_factory=list)
    #: host (numpy) snapshots of the population: before the first
    #: temperature, then after every mutation
    sample_history: list = field(default_factory=list)
