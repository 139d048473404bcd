"""Adaptive-tempered Sequential Monte Carlo with a host-driven ladder.

Counterpart of ``aspire_tpu/samplers/smc.py`` (``SMCSampler``, ``PCNSMC``)
run with the JAX package's ``device_ladder=False`` semantics: the host
loops over temperatures; per temperature one batch of device work bisects
for the next beta and computes the ESS and evidence increment (fetched in
one transfer), then the population is resampled and mutated.

Each mutation runs either the whole-chain CUDA kernel
(:func:`aspire_tpu_torch.ops.fused_mutation.fused_mh_chain`; its plain
torch version on a CPU tensor) or the per-step ("split") chain of
:mod:`.kernels`, chosen by :meth:`SMCSampler._fused_chain_spec` exactly as
the JAX package's ``_fused_chain_spec`` chooses between its TPU kernel and
its XLA chain. History records which ran.
"""

from __future__ import annotations

import logging
import math
from typing import Callable

import numpy as np
import torch

from ..flows.architectures import Coupling
from ..history import SMCHistory
from ..ops import fused_mutation as FM
from ..ops.special import effective_sample_size
from ..samples import Samples, SMCSamples
from ..transforms import affine_state
from .base import Sampler
from . import kernels as K

logger = logging.getLogger("aspire_tpu_torch")

DEFAULT_BETA_TOLERANCE = 1e-8
#: sampler_kwargs the JAX package reads and the port does not implement:
#: each raises when set rather than being ignored
UNPORTED_SAMPLER_KWARGS = ("waste_free", "windowed_tau", "flow_moves")


class BetaScheduleError(RuntimeError):
    """The adaptive beta ladder stalled."""


def bisect_beta(delta: torch.Tensor, beta_prev, target_eff: float,
                tol: float) -> torch.Tensor:
    """Largest beta whose incremental weights ``(beta - beta_prev) delta``
    keep ESS / n >= ``target_eff`` (fixed-trip bisection on the device)."""
    n = delta.shape[0]

    def ok(beta):
        return effective_sample_size((beta - beta_prev) * delta) / n >= target_eff

    return K.monotone_beta_bisect(ok, beta_prev, tol, delta.dtype,
                                  delta.device)


def iteration_stats(log_l, log_pi, log_q, beta_prev: float,
                    beta_fixed: float, target_eff: float, tol: float,
                    min_beta_step: float, max_beta_step: float, *,
                    adaptive: bool, adaptive_min_step: bool):
    """Next beta, the step floor, the bisected beta, both ESS values and the
    evidence increment with its variance, as one ``(7,)`` tensor."""
    delta = log_l + log_pi - log_q
    dt = dict(dtype=delta.dtype, device=delta.device)
    if adaptive:
        beta_star = bisect_beta(delta, beta_prev, target_eff, tol)
        if adaptive_min_step:
            min_step = torch.where(
                beta_star < 1.0,
                min_beta_step * (1 - beta_prev) / (1 - beta_star),
                torch.full((), min_beta_step, **dt))
        else:
            min_step = torch.full((), min_beta_step, **dt)
        beta = torch.maximum(beta_star, beta_prev + min_step)
        beta = torch.clamp(torch.clamp(beta, max=beta_prev + max_beta_step),
                           max=1.0)
    else:
        beta_star = beta = torch.full((), beta_fixed, **dt)
        min_step = torch.full((), min_beta_step, **dt)
    log_w = (beta - beta_prev) * delta
    ess = effective_sample_size(log_w)
    ess_at_one = effective_sample_size((1.0 - beta_prev) * delta)
    n = log_w.shape[0]
    m = torch.max(log_w)
    u = torch.exp(torch.clamp(log_w - m, max=0.0))
    mean_u = torch.mean(u)
    ratio = m + torch.log(mean_u)
    var = torch.var(u, correction=0) / (n * mean_u**2)
    return torch.stack([beta, min_step, beta_star, ess, ess_at_one, ratio,
                        var])


def _check_beta_progress(beta, beta_star, beta_prev, target_eff,
                         beta_tolerance, min_beta_step, adaptive):
    if adaptive and beta_star <= beta_prev + beta_tolerance and beta_prev < 1.0:
        logger.warning(
            "Adaptive beta search could not find a beta above %.6g that "
            "satisfies the target efficiency %.3f within tolerance %.1e; "
            "beta may remain unchanged.", beta_prev, target_eff,
            beta_tolerance)
    if beta == beta_prev:
        raise BetaScheduleError(
            f"Beta did not increase from previous value {beta:.6g}. "
            "Adaptive beta search may have failed to find a suitable "
            f"beta. Consider adjusting beta_tolerance ({beta_tolerance}), "
            f"min_beta_step ({min_beta_step}) or target_efficiency "
            f"({target_eff}).")


class SMCSampler(Sampler):
    """Adaptive-tempered SMC; subclasses provide the mutation kernel."""

    default_sampler_kwargs: dict = {}

    def __init__(self, *args, resampling_method: str = "systematic",
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.resampling_method = resampling_method
        self.history = SMCHistory()
        self.sampler_kwargs: dict = {}
        self._adaptive_target_efficiency = False
        self._step_size_carry = None
        self._step_size_carry_fused = None
        self._lineage_fraction = 1.0
        self._last_chain_stats = None

    # -- target efficiency schedule ----------------------------------------

    @property
    def target_efficiency(self):
        return self._target_efficiency

    @target_efficiency.setter
    def target_efficiency(self, value):
        if isinstance(value, float):
            if not 0 < value < 1:
                raise ValueError("target_efficiency must be in (0, 1)")
            self._target_efficiency = value
            self._adaptive_target_efficiency = False
        elif len(value) != 2:
            raise ValueError(
                "target_efficiency must be a float or tuple of two floats")
        else:
            value = tuple(map(float, value))
            if not 0 < value[0] < value[1] < 1:
                raise ValueError(
                    "target_efficiency tuple must be in (0, 1) and increasing")
            self._target_efficiency = value
            self._adaptive_target_efficiency = True

    def current_target_efficiency(self, beta: float) -> float:
        if self._adaptive_target_efficiency:
            lo, hi = self._target_efficiency
            return lo + (hi - lo) * (beta**self.target_efficiency_rate)
        return self._target_efficiency

    # -- tempered target ---------------------------------------------------

    def tempered_log_prob(self, z: torch.Tensor, beta: float):
        """``(1-beta) log q + beta (logL + logPi) + log|J|`` in the
        preconditioned space, NaN -> -inf."""
        x, log_j = self.invert_preconditioning(z)
        log_q = self.prior_flow.log_prob(x)
        view = self._make_view(x)
        log_pi = torch.as_tensor(self.log_prior(view)).reshape(-1)
        log_l = torch.as_tensor(self.log_likelihood(view)).reshape(-1)
        log_p = (1 - beta) * log_q + beta * (log_l + log_pi) + log_j
        return torch.where(torch.isnan(log_p),
                           torch.full_like(log_p, -math.inf), log_p).to(z.dtype)

    # -- mutation ----------------------------------------------------------

    def _kernel_step_builder(self, log_prob_fn, ref):
        """Return ``(step_fn, init_step)``; overridden."""
        raise NotImplementedError

    def _fused_kernel_config(self, kwargs) -> dict | None:
        return None

    def _kernel_target(self):
        """``(id, constants)`` when both user callables are bound to one
        problem object that carries an in-kernel target."""
        owner = getattr(self.log_likelihood, "__self__", None)
        if owner is None or getattr(self.log_prior, "__self__", None) is not owner:
            return None
        fn = getattr(owner, "kernel_target", None)
        return fn(self.device) if fn is not None else None

    def _fused_chain_spec(self, kwargs, n: int, dtype) -> dict | None:
        """Dispatch predicate for the whole-chain kernel (None -> split).

        Mirrors the JAX package's ``_fused_chain_spec``: a coupling flow
        (a MAF always takes the split chain, on every device), float32, an
        identity or affine-only data transform, no
        preconditioning, a target with an in-kernel id, an integer
        ``nu + d`` for tpCN, whole tiles, and on a CUDA device a kernel
        compiled for the flow's shape.
        """
        if kwargs.get("fused_chain", "auto") in (False, "off"):
            return None
        arch = self.prior_flow.architecture
        if not isinstance(arch, Coupling):
            return None
        kcfg = self._fused_kernel_config(kwargs)
        if (kcfg is None or self.preconditioning_transform is not None
                or dtype != torch.float32 or n % FM.TILE):
            return None
        if kcfg["kernel"] == "tpcn":
            k2 = kcfg["nu"] + self.dims
            if abs(k2 - round(k2)) > 1e-9:
                return None
            kcfg = dict(kcfg, gamma_m=int(round(k2)) // 2,
                        gamma_odd=int(round(k2)) % 2)
        else:
            kcfg = dict(kcfg, gamma_m=0, gamma_odd=0)
        try:
            kcfg["data_transform"] = affine_state(
                self.prior_flow.data_transform)
        except LookupError:
            return None
        kcfg["target"] = self._kernel_target()
        if kcfg["target"] is None:
            return None
        cfg = FM.ChainConfig(
            arch, kcfg["kernel"], 1, nu=kcfg["nu"],
            gamma_m=kcfg["gamma_m"], gamma_odd=kcfg["gamma_odd"])
        if self.device.type == "cuda" and not FM.kernel_supports(cfg):
            return None
        return kcfg

    def _mutate_fused(self, z, beta, n_steps, spec):
        n, d = z.shape
        nt = n // FM.TILE
        carry = self._step_size_carry_fused
        if carry is not None and carry.shape == (nt,):
            step0 = carry
        else:
            step0 = torch.full((nt,), spec["init_step"], dtype=torch.float32,
                               device=z.device)
        ref = K.fit_gaussian_reference(z)
        seed = torch.randint(0, 2**32, (2,), generator=self.generator,
                             device=self.device).tolist()
        cfg = FM.ChainConfig(
            self.prior_flow.architecture, spec["kernel"], n_steps,
            nu=spec["nu"], target_acceptance=spec["target_acceptance"],
            adaptation_rate=spec["adaptation_rate"],
            gamma_m=spec["gamma_m"], gamma_odd=spec["gamma_odd"])
        x, lq, lpi, ll, nacc, steps, stats = FM.fused_mh_chain(
            cfg, self.prior_flow.params, z, beta, seed, step0, ref.mean,
            ref.chol, ref.inv_chol, spec["target"],
            data_transform=spec["data_transform"])
        self._step_size_carry_fused = steps
        tau, mixing = FM.combine_tile_stats(stats, d, FM.TILE)
        acceptance = torch.mean(nacc) / max(n_steps, 1)
        return x, lq, lpi, ll, acceptance, tau, mixing, (n_steps + 1) * n

    def _mutate_split(self, z, beta, n_steps, kwargs):
        ref = K.fit_gaussian_reference(z)

        def log_prob_fn(zz):
            return self.tempered_log_prob(zz, beta)

        step_fn, init_step = self._kernel_step_builder(log_prob_fn, ref)
        carry = self._step_size_carry
        step0 = (carry if carry is not None else
                 torch.tensor(float(init_step), dtype=z.dtype,
                              device=z.device))
        state = K.ChainState(x=z, log_prob=log_prob_fn(z), step_size=step0,
                             n_accept=torch.zeros_like(z[:, 0]))
        final, stats = K.run_chain(step_fn, state, n_steps)
        self._step_size_carry = final.step_size
        x, _ = self.invert_preconditioning(final.x)
        log_q = self.prior_flow.log_prob(x)
        log_pi = self.evaluate_log_prior(x)
        view = self._make_view(x)
        log_l = torch.as_tensor(self.log_likelihood(view)).reshape(-1)
        acceptance = torch.mean(final.n_accept / max(n_steps, 1))
        evals = final.n_evals + z.shape[0] + x.shape[0]
        return (x, log_q, log_pi, log_l, acceptance, stats.tau, stats.mixing,
                evals)

    def mutate(self, samples: SMCSamples, beta: float,
               n_steps: int | None = None) -> SMCSamples:
        """Fit the preconditioning, run the chain at ``beta``, and return
        the mutated particles with refreshed densities."""
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        n_steps = int(n_steps or kwargs.get("n_steps") or 5 * self.dims)
        z = self.fit_preconditioning_transform(samples.x)
        spec = self._fused_chain_spec(kwargs, z.shape[0], z.dtype)
        if spec is not None:
            out = self._mutate_fused(z.contiguous(), beta, n_steps, spec)
            route = "fused_kernel"
        else:
            out = self._mutate_split(z, beta, n_steps, kwargs)
            route = "split"
        x, log_q, log_pi, log_l, acceptance, tau, mixing, evals = out
        nan_q = torch.isnan(log_q).sum()
        nonfinite = (~torch.isfinite(log_pi) | ~torch.isfinite(log_l)).sum()
        nan_target = (torch.isnan(log_pi) | torch.isnan(log_l)).sum()
        acceptance, tau, mixing, nan_q, nonfinite, nan_target = torch.stack([
            acceptance.float(), tau.float(), mixing.float(), nan_q.float(),
            nonfinite.float(), nan_target.float()]).tolist()
        self.n_likelihood_evaluations += int(evals)
        self.history.mcmc_acceptance.append(acceptance)
        self.history.mcmc_autocorr.append(tau)
        self.history.mutation_route.append(route)
        self.history.nonfinite_target.append(int(nonfinite))
        self._last_chain_stats = (tau, mixing)
        if nan_q:
            raise ValueError(f"Log proposal contains {int(nan_q)} NaN values")
        if nan_target:
            raise ValueError(
                "log_prior/log_likelihood returned NaN for mutated particles "
                "(return -inf for invalid points instead)")
        new = SMCSamples(x=x, beta=beta, dtype=self.dtype,
                         parameters=self.parameters, device=self.device)
        new.log_q = log_q
        new.log_prior = log_pi
        new.log_likelihood = log_l
        return new

    # -- lineage bookkeeping -------------------------------------------------

    def _update_lineage_after_resample(self, ess: float, n: int) -> None:
        self._lineage_fraction = min(
            max(self._lineage_fraction * max(ess, 1.0) / n, 1.0 / n), 1.0)

    def _update_lineage_after_mutation(self) -> None:
        if self._last_chain_stats is None:
            return
        tau, mixing = self._last_chain_stats
        k = int(self.sampler_kwargs.get("n_steps") or 5 * self.dims)
        rho = max((tau - 1.0) / (tau + 1.0), 0.0)
        recovered = (1.0 - rho ** (2 * k)) * mixing
        self._lineage_fraction += (1.0 - self._lineage_fraction) * recovered

    # -- main loop ---------------------------------------------------------

    def sample(
        self,
        n_samples: int,
        n_steps: int | None = None,
        adaptive: bool = True,
        min_beta_step: float | None = None,
        max_beta_step: float | None = None,
        max_n_steps: int | None = None,
        target_efficiency: float | tuple = 0.5,
        target_efficiency_rate: float = 1.0,
        n_final_samples: int | None = None,
        sampler_kwargs: dict | None = None,
        store_sample_history: bool | None = None,
        beta_tolerance: float = DEFAULT_BETA_TOLERANCE,
        device_ladder: bool | None = None,
    ) -> Samples:
        """Run adaptive-tempered SMC; returns posterior samples with the
        log evidence and its error. ``n_steps`` fixes the beta ladder
        (``1 / n_steps`` increments); the mutation length is
        ``sampler_kwargs["n_steps"]``."""
        if device_ladder:
            raise NotImplementedError(
                "the device ladder is not ported; the host ladder runs")
        self.sampler_kwargs = dict(self.default_sampler_kwargs)
        self.sampler_kwargs.update(sampler_kwargs or {})
        for name in UNPORTED_SAMPLER_KWARGS:
            if self.sampler_kwargs.get(name):
                raise NotImplementedError(
                    f"sampler_kwargs[{name!r}] is not ported")
        if store_sample_history is None:
            # One host copy of the population per temperature: by default
            # only at plot sizes, as in the JAX package.
            store_sample_history = n_samples <= 10_000
        n_final_steps = self.sampler_kwargs.pop("n_final_steps", None)
        self._step_size_carry = None
        self._step_size_carry_fused = None
        self._lineage_fraction = 1.0
        self.history = SMCHistory()

        init = self.draw_initial_samples(n_samples)
        samples = SMCSamples.from_samples(init, beta=0.0, dtype=self.dtype)
        beta = 0.0
        if store_sample_history:
            self.history.sample_history.append(samples.to_numpy())
        for name in ("log_q", "log_prior", "log_likelihood"):
            if bool(torch.isnan(getattr(samples, name)).any()):
                raise ValueError(
                    f"{name.replace('_', ' ').capitalize()} contains NaN "
                    "values")

        self.target_efficiency = target_efficiency
        self.target_efficiency_rate = target_efficiency_rate
        if n_steps is not None:
            beta_step = 1 / n_steps
        elif not adaptive:
            raise ValueError("Either n_steps or adaptive=True must be set")
        else:
            beta_step = math.nan
        self.adaptive = adaptive
        if min_beta_step is None:
            if max_n_steps is None:
                min_beta_step = 0.0
                self.adaptive_min_beta_step = False
            else:
                min_beta_step = 1 / max_n_steps
                self.adaptive_min_beta_step = True
        else:
            self.adaptive_min_beta_step = False
        if max_beta_step is not None:
            if not 0 < max_beta_step < 1:
                raise ValueError("max_beta_step must be in (0, 1)")
        else:
            max_beta_step = 1.0

        iterations = 0
        while True:
            iterations += 1
            beta_prev = samples.beta
            target_eff = float(self.current_target_efficiency(beta_prev))
            stats = iteration_stats(
                samples.log_likelihood, samples.log_prior, samples.log_q,
                beta_prev, min(beta + beta_step, 1.0), target_eff,
                beta_tolerance, min_beta_step, max_beta_step,
                adaptive=self.adaptive,
                adaptive_min_step=self.adaptive_min_beta_step)
            (beta, min_beta_step, beta_star, ess, ess_at_one, ratio,
             var) = stats.tolist()
            _check_beta_progress(beta, beta_star, beta_prev, target_eff,
                                 beta_tolerance, min_beta_step, self.adaptive)
            self.history.eff_target.append(
                float(self.current_target_efficiency(beta)))
            self.history.beta.append(beta)
            eff = ess / len(samples)
            if eff < 0.1:
                logger.warning("it %d - Low sample efficiency: %.2f",
                               iterations, eff)
            self.history.ess.append(ess)
            self.history.ess_target.append(ess_at_one)
            self.history.log_norm_ratio.append(ratio)
            self.history.log_norm_ratio_var.append(
                var / self._lineage_fraction)
            self.history.lineage_fraction.append(self._lineage_fraction)
            logger.info("it %d - beta %.6g, ESS %.1f, log ratio %.3f",
                        iterations, beta, ess, ratio)
            n_before = len(samples)
            samples = samples.resample(beta, self.generator,
                                       method=self.resampling_method)
            self._update_lineage_after_resample(ess, n_before)
            samples = self.mutate(samples, beta)
            self._update_lineage_after_mutation()
            if store_sample_history:
                self.history.sample_history.append(samples.to_numpy())
            if beta == 1.0 or (max_n_steps is not None
                               and iterations >= max_n_steps):
                break

        if n_final_samples is not None and len(samples) != n_final_samples:
            if float(samples.beta or 0.0) < 1.0:
                self.history.log_norm_ratio.append(
                    float(samples.log_evidence_ratio(1.0)))
                self.history.log_norm_ratio_var.append(
                    float(samples.log_evidence_ratio_variance(1.0))
                    / self._lineage_fraction)
            final = samples.resample(1.0, self.generator,
                                     n_samples=n_final_samples,
                                     method=self.resampling_method)
            samples = self.mutate(final, 1.0, n_steps=n_final_steps)

        samples.log_evidence = float(np.sum(self.history.log_norm_ratio))
        samples.log_evidence_error = float(
            np.sqrt(np.sum(self.history.log_norm_ratio_var)))
        out = samples.to_standard_samples()
        logger.info("Log evidence: %.3f +/- %.3f", out.log_evidence,
                    out.log_evidence_error)
        return out


class PCNSMC(SMCSampler):
    """SMC with (t)pCN mutation, the default sampler (minipcn defaults:
    ``n_steps = 5 d``, target acceptance 0.234, ``step_fn="tpcn"``)."""

    @property
    def default_sampler_kwargs(self):
        return {
            "n_steps": 5 * self.dims,
            "target_acceptance_rate": 0.234,
            "step_fn": "tpcn",
            "nu": 5.0,
            "adaptation_rate": 0.1,
            "initial_step_size": 0.5,
        }

    def _fused_kernel_config(self, kwargs):
        step_name = kwargs.get("step_fn", "tpcn")
        if step_name not in ("tpcn", "pcn"):
            return None
        return {
            "kernel": step_name,
            "nu": float(kwargs.get("nu", 5.0)),
            "target_acceptance": float(
                kwargs.get("target_acceptance_rate", 0.234)),
            "adaptation_rate": float(kwargs.get("adaptation_rate", 0.1)),
            "init_step": float(kwargs.get("initial_step_size", 0.5)),
        }

    def _kernel_step_builder(self, log_prob_fn: Callable, ref):
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        step_name = kwargs.get("step_fn", "tpcn")
        common = dict(
            target_acceptance=kwargs.get("target_acceptance_rate", 0.234),
            adaptation_rate=kwargs.get("adaptation_rate", 0.1))
        gen = self.generator
        if step_name == "pcn":
            def step(state):
                return K.pcn_step(state, gen, log_prob_fn, ref, **common)
        elif step_name == "tpcn":
            nu = kwargs.get("nu", 5.0)

            def step(state):
                return K.tpcn_step(state, gen, log_prob_fn, ref, nu=nu,
                                   **common)
        else:
            raise ValueError(f"Unknown pCN step function: {step_name}")
        return step, kwargs.get("initial_step_size", 0.5)
