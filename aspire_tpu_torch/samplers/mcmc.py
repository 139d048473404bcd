"""Standalone MCMC posterior samplers (counterpart of
``aspire_tpu/samplers/mcmc.py`` without the parallel-tempered sampler).

Each draws its walkers' initial states from the flow proposal, fits the
preconditioning transform to them, and runs a chain on the posterior
``logL + logPi`` in the preconditioned space, every walker one row of the
batch each step (:func:`~aspire_tpu_torch.samplers.kernels.run_chain`),
then returns the chain in data space as
:class:`~aspire_tpu_torch.samples.MCMCSamples`:

- :class:`PCNSampler`: tpCN or pCN steps with step-size adaptation;
- :class:`EnsembleSampler`: the affine-invariant stretch move, red-black.

With a flow preconditioning every step inverts the preconditioning's flow
(B3 for a coupling flow on the card). Chain checkpoints need HDF5, which
the port does not have yet: asking for one raises.
"""

from __future__ import annotations

import logging
import math
from typing import Callable

import torch

from ..samples import MCMCSamples
from . import kernels as K
from .base import Sampler

logger = logging.getLogger("aspire_tpu_torch")


class MCMCSampler(Sampler):
    """Base for MCMC samplers: the posterior log-density in the
    preconditioned space, and the chain's way back to data space."""

    def make_log_prob(self) -> Callable:
        """``z -> logL(x) + logPi(x) + log|dx/dz|`` with ``x`` the
        preconditioning's inverse of ``z``; NaN -> -inf."""
        precond = self.preconditioning_transform

        def log_prob(z):
            if precond is None:
                x = z
                log_j = torch.zeros(z.shape[0], dtype=z.dtype,
                                    device=z.device)
            else:
                x, log_j = precond.inverse(z)
            view = self._make_view(x)
            lp = (torch.as_tensor(self.log_likelihood(view),
                                  device=z.device).reshape(-1)
                  + torch.as_tensor(self.log_prior(view),
                                    device=z.device).reshape(-1)
                  + log_j)
            return torch.where(torch.isnan(lp),
                               torch.full_like(lp, -math.inf), lp)

        return log_prob

    @staticmethod
    def _check_checkpoint(file_path, every) -> None:
        """A chain checkpoint (written unless ``every <= 0``) needs HDF5."""
        if file_path is not None and (every is None or every > 0):
            raise NotImplementedError(
                "MCMC chain checkpoints need HDF5, which is not ported yet")

    def _finalize_chain(self, chain_z: torch.Tensor, burn_in: int,
                        thin: int) -> MCMCSamples:
        """Invert the preconditioning over the whole chain, evaluate the
        target on it, then apply the burn-in and thinning."""
        n_steps, n_walkers, d = chain_z.shape
        x, _ = self.invert_preconditioning(chain_z.reshape(-1, d))
        samples = MCMCSamples.from_chain(
            x.reshape(n_steps, n_walkers, d), parameters=self.parameters,
            dtype=self.dtype)
        samples.log_prior = self.evaluate_log_prior(samples.x)
        samples.log_likelihood = self.evaluate_log_likelihood(samples.x)
        return samples.post_process(burn_in=burn_in, thin=thin)

    @torch.no_grad()
    def _run(self, n_samples: int, n_steps: int, make_step: Callable,
             initial_step_size: float, burn_in: int,
             thin: int) -> MCMCSamples:
        """Draw, precondition, run ``n_steps`` steps of ``make_step(
        log_prob_fn, z)`` from every walker and finish the chain; the
        evaluations the JAX package counts, (n_steps + 1) n."""
        init = self.draw_initial_samples(n_samples)
        z = self.fit_preconditioning_transform(init.x)
        log_prob_fn = self.make_log_prob()
        step = make_step(log_prob_fn, z)
        state = K.ChainState(
            x=z, log_prob=log_prob_fn(z),
            step_size=torch.as_tensor(initial_step_size, dtype=z.dtype,
                                      device=z.device),
            n_accept=torch.zeros(z.shape[0], dtype=z.dtype, device=z.device))
        final, _, chain = K.run_chain(step, state, n_steps, store_chain=True)
        self.n_likelihood_evaluations += (n_steps + 1) * z.shape[0]
        acceptance = float(torch.mean(final.n_accept / n_steps))
        logger.info("Mean acceptance rate: %.3f", acceptance)
        samples = self._finalize_chain(chain, burn_in, thin)
        samples.acceptance_rate = acceptance
        return samples


class PCNSampler(MCMCSampler):
    """(t)pCN MCMC on the posterior (the reference's ``minipcn``)."""

    def sample(
        self,
        n_samples: int,
        n_steps: int | None = None,
        step_fn: str = "tpcn",
        target_acceptance_rate: float = 0.234,
        nu: float = 5.0,
        adaptation_rate: float = 0.1,
        initial_step_size: float = 0.5,
        burn_in: int = 0,
        thin: int = 1,
        checkpoint_file_path: str | None = None,
        checkpoint_every: int | None = None,
    ) -> MCMCSamples:
        """``n_samples`` walkers, ``n_steps`` steps each (5 d by default)
        under the ensemble's Gaussian reference fitted once to the initial
        states."""
        if step_fn not in ("pcn", "tpcn"):
            raise ValueError(f"Unknown step function: {step_fn}")
        self._check_checkpoint(checkpoint_file_path, checkpoint_every)
        n_steps = n_steps or 5 * self.dims
        generator = self.generator

        def make_step(log_prob_fn, z):
            ref = K.fit_gaussian_reference(z)
            if step_fn == "pcn":
                return lambda s: K.pcn_step(
                    s, generator, log_prob_fn, ref,
                    target_acceptance=target_acceptance_rate,
                    adaptation_rate=adaptation_rate)
            return lambda s: K.tpcn_step(
                s, generator, log_prob_fn, ref, nu=nu,
                target_acceptance=target_acceptance_rate,
                adaptation_rate=adaptation_rate)

        return self._run(n_samples, n_steps, make_step, initial_step_size,
                         burn_in, thin)


class EnsembleSampler(MCMCSampler):
    """Affine-invariant ensemble MCMC (the reference's ``emcee``)."""

    def sample(
        self,
        n_samples: int,
        n_steps: int = 100,
        a: float = 2.0,
        burn_in: int = 0,
        thin: int = 1,
        checkpoint_file_path: str | None = None,
        checkpoint_every: int | None = None,
    ) -> MCMCSamples:
        """``n_samples`` walkers, ``n_steps`` stretch moves each (scale
        ``a``); the samples carry their autocorrelation time."""
        self._check_checkpoint(checkpoint_file_path, checkpoint_every)
        generator = self.generator

        def make_step(log_prob_fn, z):
            return lambda s: K.stretch_step(s, generator, log_prob_fn, a=a)

        samples = self._run(n_samples, n_steps, make_step, 1.0, burn_in,
                            thin)
        samples.compute_autocorrelation_time()
        return samples
