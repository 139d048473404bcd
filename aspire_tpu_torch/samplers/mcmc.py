"""Standalone MCMC posterior samplers (counterpart of
``aspire_tpu/samplers/mcmc.py``).

Each draws its walkers' initial states from the flow proposal, fits the
preconditioning transform to them, and runs a chain on the posterior
``logL + logPi`` in the preconditioned space, every walker one row of the
batch each step (:func:`~aspire_tpu_torch.samplers.kernels.run_chain`),
then returns the chain in data space as
:class:`~aspire_tpu_torch.samples.MCMCSamples`:

- :class:`PCNSampler`: tpCN or pCN steps with step-size adaptation;
- :class:`EnsembleSampler`: the affine-invariant stretch move, red-black;
- :class:`ParallelTemperedSampler`: a stretch-move ensemble per inverse
  temperature, all rungs advanced as one ``(T, n, d)`` batch, with
  even/odd replica swaps, returning
  :class:`~aspire_tpu_torch.samples.PTMCMCSamples` for the
  thermodynamic-integration and stepping-stone evidence.

With a flow preconditioning every step inverts the preconditioning's flow
(B3 for a coupling flow on the card). Given ``checkpoint_file_path``, each
writes its finished chain in data space to the file (HDF5, the JAX
package's ``checkpoint/mcmc_chain``); the parallel-tempered sampler also
writes a resumable state every ``state_checkpoint_every`` rounds
(``checkpoint/pt_state``), from which ``resume_from`` continues the run
bit for bit.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable

import numpy as np
import torch

from ..samples import MCMCSamples, PTMCMCSamples
from ..utils import to_numpy, track_calls
from . import kernels as K
from .base import Sampler, generator_state, restore_generator

logger = logging.getLogger("aspire_tpu_torch")


def _bisect_pt_beta(log_l, log_base, beta_prev, target: float,
                    tol: float) -> torch.Tensor:
    """The next PT rung: the largest beta in ``[beta_prev, 1]`` whose
    conditional ESS (Zhou, Johansen & Aston 2016) on the probe stays at
    least ``target * n``. With probe weights ``u ~ exp(log_base + beta_prev
    logL)`` (``log_base = logPi - log_q``) and ``v = exp((beta -
    beta_prev) logL)``, ``CESS = n (sum u v)^2 / sum u v^2``; the SMC
    ladder's bisection (:func:`~aspire_tpu_torch.samplers.kernels.
    monotone_beta_bisect`)."""
    lu = log_base + beta_prev * log_l
    lu = lu - torch.logsumexp(lu, dim=0)
    log_target = math.log(target)

    def ok(beta):
        lv = (beta - beta_prev) * log_l
        num = 2.0 * torch.logsumexp(lu + lv, dim=0)
        den = torch.logsumexp(lu + 2.0 * lv, dim=0)
        return num - den >= log_target

    return K.monotone_beta_bisect(ok, beta_prev, tol, log_l.dtype,
                                  log_l.device)


class MCMCSampler(Sampler):
    """Base for MCMC samplers: the posterior log-density in the
    preconditioned space, the chain's way back to data space, and the
    chain's checkpoint."""

    chain_checkpoint_path = "checkpoint"
    chain_dataset_name = "mcmc_chain"

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

    # -- chain checkpoints ---------------------------------------------------

    def _maybe_checkpoint_chain(self, chain, iteration: int,
                                file_path: str | None, every: int | None,
                                extra_attrs: dict | None = None) -> None:
        """Write the finished data-space chain (before burn-in and
        thinning) where a path was given, unless ``every <= 0``."""
        if file_path is None or (every is not None and every <= 0):
            return
        self.save_chain_checkpoint(to_numpy(chain), int(iteration),
                                   str(file_path), extra_attrs=extra_attrs)

    def save_chain_checkpoint(self, chain: np.ndarray, iteration: int,
                              file_path: str,
                              extra_attrs: dict | None = None) -> None:
        from ..io import AspireFile

        with AspireFile(file_path, "a") as f:
            grp = f.require_group(self.chain_checkpoint_path)
            if self.chain_dataset_name in grp:
                del grp[self.chain_dataset_name]
            ds = grp.create_dataset(self.chain_dataset_name,
                                    data=np.asarray(chain))
            ds.attrs["iteration"] = iteration
            ds.attrs["shape"] = chain.shape
            for key, value in (extra_attrs or {}).items():
                ds.attrs[key] = value

    def load_chain_checkpoint(self, file_path: str):
        """The chain and its iteration as saved (by either package)."""
        from ..io import h5py_module

        with h5py_module().File(file_path, "r") as f:
            ds = f[self.chain_checkpoint_path][self.chain_dataset_name]
            return np.asarray(ds[()]), int(ds.attrs["iteration"])

    def _finalize_chain(self, chain_z: torch.Tensor, burn_in: int,
                        thin: int, checkpoint_file_path: str | None = None,
                        checkpoint_every: int | None = None
                        ) -> MCMCSamples:
        """Invert the preconditioning over the whole chain (and write it
        where a checkpoint path was given), evaluate the target on it, then
        apply the burn-in and thinning."""
        n_steps, n_walkers, d = chain_z.shape
        x, _ = self.invert_preconditioning(chain_z.reshape(-1, d))
        chain = x.reshape(n_steps, n_walkers, d)
        self._maybe_checkpoint_chain(chain, n_steps, checkpoint_file_path,
                                     checkpoint_every)
        samples = MCMCSamples.from_chain(
            chain, parameters=self.parameters, dtype=self.dtype)
        samples.log_prior = self.evaluate_log_prior(samples.x)
        samples.log_likelihood = self.evaluate_log_likelihood(samples.x)
        return samples.post_process(burn_in=burn_in, thin=thin)

    @torch.no_grad()
    def _run(self, n_samples: int, n_steps: int, make_step: Callable,
             initial_step_size: float, burn_in: int, thin: int,
             checkpoint_file_path: str | None = None,
             checkpoint_every: int | None = None) -> MCMCSamples:
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
        samples = self._finalize_chain(chain, burn_in, thin,
                                       checkpoint_file_path,
                                       checkpoint_every)
        samples.acceptance_rate = acceptance
        return samples


class PCNSampler(MCMCSampler):
    """(t)pCN MCMC on the posterior (the reference's ``minipcn``)."""

    @track_calls
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
                         burn_in, thin, checkpoint_file_path,
                         checkpoint_every)


class EnsembleSampler(MCMCSampler):
    """Affine-invariant ensemble MCMC (the reference's ``emcee``)."""

    @track_calls
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
        generator = self.generator

        def make_step(log_prob_fn, z):
            return lambda s: K.stretch_step(s, generator, log_prob_fn, a=a)

        samples = self._run(n_samples, n_steps, make_step, 1.0, burn_in,
                            thin, checkpoint_file_path, checkpoint_every)
        samples.compute_autocorrelation_time()
        return samples


class ParallelTemperedSampler(MCMCSampler):
    """Parallel-tempered MCMC with replica exchange.

    One stretch-move ensemble per inverse temperature ``beta_t`` on the
    tempered posterior ``beta logL + logPi`` (the prior kept cold), all
    rungs advanced as one ``(T, n, d)`` batch: each red-black half-move
    evaluates the target once on ``T x n_move`` states. ``logL`` and
    ``logPi`` are carried through the moves and the even/odd swaps, so a
    swap never evaluates the target. Returns :class:`PTMCMCSamples`.
    Draws go through ``kernels._randint``/``_uniform`` in the JAX
    package's order: per half-move the partners, the stretch uniforms and
    the accept uniforms, each ``(T, n_move)``; per round then the even and
    the odd pass's swap uniforms, each ``(n_pairs, n)``.
    """

    def adaptive_beta_ladder(
        self,
        samples,
        target_efficiency: float = 0.9,
        max_n_temperatures: int = 32,
        min_n_temperatures: int = 2,
        min_beta_step: float = 1e-4,
        tol: float = 1e-8,
        ti_quadrature_tol: float = 0.1,
    ) -> np.ndarray:
        """Rungs where the tempered path steepens, descending, the hottest
        at 0. Each rung from 0 up by the conditional-ESS bisection
        (:func:`_bisect_pt_beta`) on the probe ``samples`` (entries with a
        non-finite logL or ``logPi - log_q`` dropped), at most
        ``max_n_temperatures`` (the last promoted to 1 at the cap); then
        segments split at their midpoints while a trapezoid-vs-midpoint
        discrepancy of the probe's importance-weighted rung means of logL
        passes ``ti_quadrature_tol`` nats or fewer than
        ``min_n_temperatures`` rungs exist, up to the cap."""
        log_l = samples.log_likelihood
        log_base = samples.log_prior - samples.log_q
        finite = torch.isfinite(log_l) & torch.isfinite(log_base)
        if not bool(finite.any()):
            raise ValueError(
                "adaptive_beta_ladder needs at least one probe sample "
                "with finite log_likelihood and finite "
                "log_prior - log_q; got none.")
        if not bool(finite.all()):
            log_l, log_base = log_l[finite], log_base[finite]
        betas = [0.0]
        while betas[-1] < 1.0 and len(betas) < max_n_temperatures:
            b = float(_bisect_pt_beta(
                log_l, log_base,
                torch.tensor(betas[-1], dtype=log_l.dtype,
                             device=log_l.device),
                target_efficiency, tol))
            betas.append(min(max(b, betas[-1] + min_beta_step), 1.0))
        if betas[-1] < 1.0:
            logger.warning(
                "Adaptive PT ladder hit max_n_temperatures=%d before "
                "reaching beta=1 (target_efficiency=%.3f); forcing the cold "
                "rung - consider raising the cap or lowering the target.",
                max_n_temperatures, target_efficiency)
            if len(betas) >= max_n_temperatures:
                betas[-1] = 1.0
            else:
                betas.append(1.0)
        log_l_np = log_l.detach().cpu().double().numpy()
        log_base_np = log_base.detach().cpu().double().numpy()

        def rung_mean(b: float) -> float:
            lw = log_base_np + b * log_l_np
            lw -= lw.max()
            w = np.exp(lw)
            return float(np.sum(w * log_l_np) / np.sum(w))

        def segment_error(lo: float, hi: float) -> float:
            e_mid = rung_mean(0.5 * (lo + hi))
            e_trap = 0.5 * (means[lo] + means[hi])
            return abs(e_trap - e_mid) * (hi - lo)

        means = {b: rung_mean(b) for b in betas}
        floor = min(min_n_temperatures, max_n_temperatures)
        while len(betas) < max_n_temperatures:
            gaps = np.diff(betas)
            splittable = np.nonzero(gaps >= 2 * min_beta_step)[0]
            if splittable.size == 0:
                break
            errs = np.array([segment_error(betas[i], betas[i + 1])
                             for i in splittable])
            if errs.max() > ti_quadrature_tol:
                i = int(splittable[np.argmax(errs)])
            elif len(betas) < floor:
                i = int(splittable[np.argmax(gaps[splittable])])
            else:
                break
            mid = 0.5 * (betas[i] + betas[i + 1])
            betas.insert(i + 1, mid)
            means[mid] = rung_mean(mid)
        return np.asarray(betas[::-1], dtype=float)

    def refine_ladder_from_run(
        self,
        samples: PTMCMCSamples,
        n_temperatures: int,
        discard_fraction: float = 0.5,
        min_beta_step: float = 1e-4,
        max_n_temperatures: int | None = None,
        swap_floor: float = 0.15,
    ) -> np.ndarray:
        """Rungs re-placed from a pilot run's measured rung means of logL
        (after dropping ``discard_fraction`` of its rounds), descending with
        the ends at 1 and 0: the betas where the monotone envelope of the
        means crosses ``n_temperatures`` equally spaced levels (equal-dE
        spacing, Calderhead & Girolami 2009), kept where they advance the
        integrand past every pilot rung by a quarter level, joined with the
        pilot's rungs and with the midpoint of every pair whose swap
        acceptance fell below ``swap_floor``; rungs closer than
        ``min_beta_step`` merged; at most ``max_n_temperatures``, by
        dropping the interior rung over the flattest span (a rescue
        midpoint last). A flat or unmeasurable integrand keeps the pilot's
        rungs, thinned evenly to the budget beside the rescues."""
        t_dim, r_dim, n_dim = samples.chain_shape
        ll = samples.log_likelihood.detach().cpu().double().numpy().reshape(
            t_dim, r_dim, n_dim)
        start = min(int(r_dim * discard_fraction), r_dim - 1)
        tail = ll[:, start:]
        finite = np.isfinite(tail)
        n_finite = finite.sum(axis=(1, 2))
        sums = np.where(finite, tail, 0.0).sum(axis=(1, 2))
        means = np.where(n_finite > 0, sums / np.maximum(n_finite, 1),
                         np.nan)
        betas_desc = np.asarray(samples.betas, dtype=np.float64)
        swap_acc = getattr(samples, "swap_acceptance", None)
        rescue = []
        if swap_acc is not None and len(swap_acc) == len(betas_desc) - 1:
            for i, acc in enumerate(np.asarray(swap_acc, dtype=float)):
                if np.isfinite(acc) and acc < swap_floor:
                    rescue.append(0.5 * (betas_desc[i] + betas_desc[i + 1]))
        rescue_set = {float(b) for b in rescue}
        order = np.argsort(betas_desc)
        b_asc = betas_desc[order]
        e_asc = means[order]
        valid = np.isfinite(e_asc)
        b_asc, e_asc = b_asc[valid], e_asc[valid]
        if len(b_asc) < 2 or e_asc[-1] - e_asc[0] < 1e-9:
            cap = (max(max_n_temperatures, 2)
                   if max_n_temperatures is not None else None)
            base = betas_desc
            resc = np.asarray([b for b in rescue if 0.0 < b < 1.0],
                              dtype=float)
            if cap is not None and len(base) > max(cap - resc.size, 2):
                idx = np.unique(np.round(np.linspace(
                    0, len(base) - 1, max(cap - resc.size, 2))).astype(int))
                base = base[idx]
            ladder = np.unique(np.concatenate([base, resc]))[::-1]
            if cap is not None and len(ladder) > cap:
                inner = ladder[1:-1]
                idx = np.unique(np.round(np.linspace(
                    0, len(inner) - 1, cap - 2)).astype(int))
                ladder = np.concatenate([ladder[:1], inner[idx],
                                         ladder[-1:]])
            return np.asarray(ladder, dtype=float)
        e_asc = np.maximum.accumulate(e_asc)
        levels = np.linspace(e_asc[0], e_asc[-1], n_temperatures)
        new_b = np.interp(levels[1:-1], e_asc, b_asc)
        e_step = (e_asc[-1] - e_asc[0]) / max(n_temperatures - 1, 1)
        keep_new = [b for b in new_b
                    if np.abs(np.interp(b, b_asc, e_asc) - e_asc).min()
                    > 0.25 * e_step]
        union = np.sort(np.concatenate([b_asc, keep_new, rescue]))
        ladder = [0.0]
        for b in union:
            if b - ladder[-1] >= min_beta_step and b <= 1.0 - min_beta_step:
                ladder.append(float(b))
        ladder.append(1.0)
        if max_n_temperatures is not None:
            while len(ladder) > max(max_n_temperatures, 2):
                e_lad = np.interp(ladder, b_asc, e_asc)
                spans = e_lad[2:] - e_lad[:-2]
                drop = None
                for j in np.argsort(spans):
                    if float(ladder[1 + int(j)]) not in rescue_set:
                        drop = 1 + int(j)
                        break
                if drop is None:
                    drop = 1 + int(np.argmin(spans))
                del ladder[drop]
        return np.asarray(ladder[::-1], dtype=float)

    def _sample_replicated(self, k: int, n_samples: int,
                           kwargs: dict) -> PTMCMCSamples:
        """``k`` independent runs, each going on with the sampler's
        generator and adapting its own ladder; the last run's samples with
        the replicates' stepping-stone log Z."""
        def run_one():
            s = self.sample(n_samples, **kwargs)
            lz, err = s.log_evidence_stepping_stone()
            return s, lz, err

        return self._replicate_evidence(k, run_one, "PT stepping-stone")

    #: HDF5 group holding the resumable mid-run PT state
    pt_state_path = "checkpoint/pt_state"

    def save_pt_state(self, file_path: str, *, betas, generator,
                      rounds_done: int, swap_every: int, n_steps: int,
                      n_samples: int, a: float, carry, chunks) -> None:
        """Write a resumable mid-run state: ``carry`` (z, logL, logPi, move
        and swap acceptance counts), ``chunks`` (the rounds so far, each a
        (chain, chain_ll, chain_lp) block) and ``generator``'s state after
        ``rounds_done`` rounds, so a resumed run draws what the
        uninterrupted one draws. Written to a sibling group first and moved
        into place, so a kill mid-save leaves one complete state (both
        places are read back)."""
        from ..io import AspireFile

        new_path = self.pt_state_path + "_new"
        z, ll, lp, move_acc, swap_acc = carry
        gen = generator_state(generator)
        with AspireFile(file_path, "a") as f:
            if new_path in f:
                del f[new_path]
            g = f.require_group(new_path)
            for name, value in (("z", z), ("ll", ll), ("lp", lp),
                                ("move_acc", move_acc),
                                ("swap_acc", swap_acc),
                                ("betas", np.asarray(betas, float)),
                                ("generator_state", gen["generator_state"])):
                g.create_dataset(name, data=to_numpy(value))
            for i, name in enumerate(("chain", "chain_ll", "chain_lp")):
                g.create_dataset(name, data=np.concatenate(
                    [to_numpy(c[i]) for c in chunks], axis=0))
            g.attrs["rounds_done"] = int(rounds_done)
            g.attrs["swap_every"] = int(swap_every)
            g.attrs["n_steps"] = int(n_steps)
            g.attrs["n_samples"] = int(n_samples)
            g.attrs["a"] = float(a)
            g.attrs["generator_device"] = gen["generator_device"]
            if self.pt_state_path in f:
                del f[self.pt_state_path]
            f.move(new_path, self.pt_state_path)

    def load_pt_state(self, file_path: str) -> dict:
        """A mid-run PT state (arrays as numpy, attributes as Python
        scalars), its generator state restored into the sampler's
        generator (:func:`~aspire_tpu_torch.samplers.base.
        restore_generator`; a JAX package state's round keys seed it by its
        rule, not the JAX stream)."""
        from ..io import h5py_module

        if not isinstance(file_path, (str, bytes, os.PathLike)):
            raise TypeError("PT resume_from expects a checkpoint file path; "
                            f"got {type(file_path).__name__}.")
        with h5py_module().File(file_path, "r") as f:
            path = self.pt_state_path
            if path not in f:
                if self.pt_state_path + "_new" not in f:
                    raise ValueError(
                        f"{file_path!r} holds no resumable PT state "
                        f"({self.pt_state_path} missing). Mid-run state "
                        "checkpoints are written only when sample() ran "
                        "with state_checkpoint_every > 0 and "
                        "preconditioning=None.")
                path = self.pt_state_path + "_new"
            g = f[path]
            state = {k: np.asarray(g[k][()]) for k in g.keys()}
            for k, v in g.attrs.items():
                if isinstance(v, np.floating):
                    v = float(v)
                elif isinstance(v, np.integer):
                    v = int(v)
                elif isinstance(v, bytes):
                    v = v.decode()
                state[k] = v
        if "generator_state" not in state and "round_keys" in state:
            state["key"] = state["round_keys"][state["rounds_done"]
                                               % len(state["round_keys"])]
        restore_generator(self.generator, state)
        return state

    @track_calls
    @torch.no_grad()
    def sample(
        self,
        n_samples: int,
        n_steps: int = 100,
        n_temperatures: int = 8,
        betas: np.ndarray | str | None = None,
        swap_every: int = 1,
        a: float = 2.0,
        burn_in: int = 0,
        thin: int = 1,
        ladder_target_efficiency: float = 0.9,
        max_n_temperatures: int = 32,
        ladder_probe_size: int = 4096,
        ladder_pilot_steps: int = 0,
        ladder_pilot_iterations: int = 1,
        checkpoint_file_path: str | None = None,
        checkpoint_every: int | None = None,
        state_checkpoint_every: int | None = None,
        resume_from: str | None = None,
        n_replicates: int | None = None,
        _init_x=None,
    ) -> PTMCMCSamples:
        """``n_samples`` walkers at each rung for ``n_steps`` stretch moves,
        a round of ``swap_every`` moves then one even and one odd swap pass.

        ``betas``: None for the geometric ladder ``(1/2)^t`` of
        ``n_temperatures`` rungs with the hottest at 0; an array; or
        ``"adaptive"`` (:meth:`adaptive_beta_ladder` on a probe of
        ``max(n_samples, ladder_probe_size)`` flow draws, at least
        ``n_temperatures`` rungs, the probe recycled as the first rungs'
        initial states). ``ladder_pilot_steps`` > 0 runs up to
        ``ladder_pilot_iterations`` pilots on the ladder, each re-placing
        it (:meth:`refine_ladder_from_run`) and warm-starting the next run
        from its nearest rung's final states, until the ladder stops
        moving. ``_init_x`` gives the ``(T n, d)`` initial states. The
        evaluations counted: ``T n`` at the start and ``T n`` per move,
        the pilots' too.

        ``checkpoint_file_path`` writes the finished chain with its ladder
        (unless ``checkpoint_every <= 0``) and, with
        ``state_checkpoint_every`` > 0 and no preconditioning, a resumable
        state every that many rounds and at the end (:meth:`save_pt_state`).
        ``resume_from`` (that file) continues the run from its last state:
        the result is the uninterrupted run's, bit for bit, and the
        finished rounds are not paid for again."""
        if n_steps < swap_every:
            raise ValueError(
                f"n_steps ({n_steps}) must be at least swap_every "
                f"({swap_every}) - fewer steps than one swap round would "
                "run no rounds at all.")
        if n_replicates is not None and n_replicates > 1:
            if resume_from is not None or checkpoint_file_path is not None:
                raise ValueError(
                    "n_replicates runs independent replicates; combine it "
                    "with checkpointing/resume per replicate manually "
                    "instead.")
            return self._sample_replicated(n_replicates, n_samples, dict(
                n_steps=n_steps, n_temperatures=n_temperatures, betas=betas,
                swap_every=swap_every, a=a, burn_in=burn_in, thin=thin,
                ladder_target_efficiency=ladder_target_efficiency,
                max_n_temperatures=max_n_temperatures,
                ladder_probe_size=ladder_probe_size,
                ladder_pilot_steps=ladder_pilot_steps,
                ladder_pilot_iterations=ladder_pilot_iterations))
        pt_resume = None
        if resume_from is not None:
            pt_resume = self.load_pt_state(resume_from)
            mismatches = {
                "n_steps": (int(pt_resume["n_steps"]), n_steps),
                "swap_every": (int(pt_resume["swap_every"]), swap_every),
                "n_samples": (int(pt_resume["n_samples"]), n_samples),
                "a": (float(pt_resume.get("a", a)), float(a)),
            }
            bad = {k: v for k, v in mismatches.items() if v[0] != v[1]}
            if bad:
                raise ValueError(
                    "resume_from state disagrees with this call's "
                    f"configuration: {bad} (saved, requested).")
            # The saved ladder is the run's: its adaptation and pilots ran.
            betas = np.asarray(pt_resume["betas"], dtype=float)
            ladder_pilot_steps = 0
            logger.info("Resuming PT sampling at round %d/%d from %s",
                        int(pt_resume["rounds_done"]),
                        n_steps // swap_every, resume_from)
        d = self.dims
        probe = probe_full = None
        if isinstance(betas, str):
            if betas != "adaptive":
                raise ValueError(
                    f"Unknown betas option {betas!r}: pass an array, None "
                    "(geometric ladder) or 'adaptive'.")
            probe_full = self.draw_initial_samples(
                max(n_samples, ladder_probe_size))
            betas = self.adaptive_beta_ladder(
                probe_full, target_efficiency=ladder_target_efficiency,
                max_n_temperatures=max_n_temperatures,
                min_n_temperatures=n_temperatures)
            probe = probe_full[:n_samples]
        elif betas is None:
            betas = np.concatenate(
                [0.5 ** np.arange(n_temperatures - 1), [0.0]])
        if ladder_pilot_steps > 0:
            betas = np.sort(np.asarray(betas, dtype=float))[::-1]
            need = n_samples * len(betas)
            probe_x = (probe_full.x if probe_full is not None else
                       torch.empty((0, d), device=self.device))
            if probe_x.shape[0] < need:
                extra = self.draw_initial_samples(need - probe_x.shape[0])
                probe_x = torch.cat([probe_x.to(extra.x.dtype), extra.x])
            pilot_init = probe_x[:need]
            for pilot_round in range(max(ladder_pilot_iterations, 1)):
                pilot = ParallelTemperedSampler.sample.__wrapped__(
                    self, n_samples, n_steps=ladder_pilot_steps,
                    betas=np.asarray(betas),
                    swap_every=min(swap_every, ladder_pilot_steps), a=a,
                    _init_x=pilot_init)
                pilot_betas = np.asarray(pilot.betas, dtype=float)
                refined = self.refine_ladder_from_run(
                    pilot, n_temperatures=max(n_temperatures, len(betas)),
                    max_n_temperatures=max_n_temperatures)
                logger.info("Pilot-refined PT ladder (cycle %d, %d rungs): "
                            "%s", pilot_round + 1, len(refined),
                            np.array2string(np.asarray(refined),
                                            precision=4))
                final = pilot.chain[:, -1]  # (T_pilot, n, d)
                betas_sorted = np.sort(np.asarray(refined))[::-1]
                nearest = np.argmin(np.abs(pilot_betas[None, :]
                                           - betas_sorted[:, None]), axis=1)
                pilot_init = final[torch.as_tensor(
                    nearest, device=final.device)].reshape(-1, d)
                converged = len(refined) == len(betas) and np.allclose(
                    np.sort(refined), np.sort(np.asarray(betas, dtype=float)),
                    atol=1e-4)
                betas = refined
                if converged:
                    break
            _init_x = pilot_init
            probe = None
        betas = np.sort(np.asarray(betas, dtype=float))[::-1].copy()
        n_temps = len(betas)

        if pt_resume is not None:
            # The saved states are data-space states (a state is written
            # only without preconditioning): a transform configured on
            # this sampler is not the run's.
            precond = self.preconditioning_transform
            if precond is not None:
                logger.warning(
                    "PT resume: the checkpointed run used no preconditioning "
                    "transform; ignoring the configured one for this call so "
                    "the saved states keep their meaning.")
                precond = None
            z = torch.as_tensor(pt_resume["z"], device=self.device)
        else:
            if _init_x is not None:
                init_x = torch.as_tensor(_init_x, device=self.device
                                         ).reshape(-1, d)
                if init_x.shape[0] != n_samples * n_temps:
                    raise ValueError(
                        f"_init_x supplies {init_x.shape[0]} states; the run "
                        f"needs n_temperatures * n_samples = "
                        f"{n_temps * n_samples}.")
            elif probe is not None and n_temps > 1:
                rest = self.draw_initial_samples(n_samples * (n_temps - 1))
                init_x = torch.cat([probe.x, rest.x])
            elif probe is not None:
                init_x = probe.x
            else:
                init_x = self.draw_initial_samples(n_samples * n_temps).x
            z = self.fit_preconditioning_transform(init_x).reshape(
                n_temps, n_samples, d)
            # fit_preconditioning_transform may have (re)fitted it.
            precond = self.preconditioning_transform
        dtype, device = z.dtype, z.device
        betas_t = torch.as_tensor(betas, dtype=dtype, device=device)

        def logl_logp(z_flat):
            if precond is None:
                x = z_flat
                log_j = torch.zeros(z_flat.shape[0], dtype=z_flat.dtype,
                                    device=device)
            else:
                x, log_j = precond.inverse(z_flat)
            view = self._make_view(x)
            log_l = torch.as_tensor(self.log_likelihood(view),
                                    device=device).reshape(-1)
            log_p = torch.as_tensor(self.log_prior(view),
                                    device=device).reshape(-1) + log_j
            return log_l, log_p

        def nan_to_neg_inf(v):
            return torch.where(torch.isnan(v), torch.full_like(v, -math.inf),
                               v)

        half = n_samples // 2
        blocks = ((0, half, half, n_samples), (half, n_samples, 0, half))
        lo_s, hi_s = math.sqrt(1 / a), math.sqrt(a)
        rungs = torch.arange(n_temps, device=device)[:, None]
        bt = betas_t[:, None]

        def one_move(z, ll, lp):
            """One tempered red-black stretch move of every rung."""
            n_acc = torch.zeros(n_temps, dtype=dtype, device=device)
            for m0, m1, o0, o1 in blocks:
                n_move = m1 - m0
                pick = K._randint(self.generator, 0, o1 - o0,
                                  (n_temps, n_move), z)
                u = K._uniform(self.generator, (n_temps, n_move), z)
                g = (u * (hi_s - lo_s) + lo_s) ** 2
                partners = z[rungs, o0 + pick]
                z_move = z[:, m0:m1]
                z_prop = partners + g[..., None] * (z_move - partners)
                ll_prop, lp_prop = logl_logp(z_prop.reshape(-1, d))
                ll_prop = ll_prop.reshape(n_temps, n_move)
                lp_prop = lp_prop.reshape(n_temps, n_move)
                t_prop = bt * ll_prop + lp_prop
                # A NaN current density (beta = 0 with logL = -inf) must
                # not freeze the walker: -inf accepts any finite proposal.
                t_curr = nan_to_neg_inf(bt * ll[:, m0:m1] + lp[:, m0:m1])
                log_alpha = nan_to_neg_inf(
                    (d - 1) * torch.log(g) + t_prop - t_curr)
                accept = torch.log(K._uniform(
                    self.generator, (n_temps, n_move), z)) < log_alpha
                z = torch.cat([z[:, :m0], torch.where(
                    accept[..., None], z_prop, z_move), z[:, m1:]], dim=1)
                ll = torch.cat([ll[:, :m0], torch.where(
                    accept, ll_prop, ll[:, m0:m1]), ll[:, m1:]], dim=1)
                lp = torch.cat([lp[:, :m0], torch.where(
                    accept, lp_prop, lp[:, m0:m1]), lp[:, m1:]], dim=1)
                n_acc = n_acc + accept.sum(dim=1).to(dtype)
            return z, ll, lp, n_acc

        # Even/odd (DEO) passes: all disjoint adjacent pairs of a parity
        # swap at once. Per pass: the pairs' hotter-side index, each
        # rung's partner and each rung's pair (n_pairs for none).
        passes = []
        for parity in (0, 1):
            lo = np.arange(parity, n_temps - 1, 2)
            if lo.size == 0:
                continue
            other = np.arange(n_temps)
            other[lo], other[lo + 1] = lo + 1, lo
            pair = np.full(n_temps, lo.size)
            pair[lo] = pair[lo + 1] = np.arange(lo.size)
            passes.append(tuple(torch.as_tensor(v, device=device)
                                for v in (lo, other, pair)))

        def swap_pass(z, ll, lp, swap_acc, lo, other, pair):
            d_beta = betas_t[lo] - betas_t[lo + 1]
            log_alpha = -d_beta[:, None] * (ll[lo] - ll[lo + 1])
            u = torch.log(K._uniform(self.generator,
                                     (lo.shape[0], n_samples), z))
            swap = u < log_alpha
            mask = torch.cat([swap, torch.zeros_like(swap[:1])])[pair]
            z = torch.where(mask[..., None], z[other], z)
            ll = torch.where(mask, ll[other], ll)
            lp = torch.where(mask, lp[other], lp)
            swap_acc = swap_acc.index_add(0, lo, swap.sum(dim=1).to(dtype))
            return z, ll, lp, swap_acc

        n_rounds = n_steps // swap_every
        # Mid-run states: only without preconditioning (the states live in
        # the transform's space, which a fresh fit would not reproduce).
        save_every = None
        if (checkpoint_file_path is not None and state_checkpoint_every
                and int(state_checkpoint_every) > 0):
            if precond is not None:
                logger.warning("Mid-run PT state checkpoints require "
                               "preconditioning=None; only the final chain "
                               "will be saved.")
            else:
                save_every = int(state_checkpoint_every)
        # Blocks of finished rounds, each (chain, chain_ll, chain_lp) of
        # shape (rounds, T, n, ...), and the rounds since the last block.
        chunks, pending = [], []
        if pt_resume is not None:
            rounds_done = int(pt_resume["rounds_done"])
            ll, lp, move_acc, swap_acc = (
                torch.as_tensor(pt_resume[k], device=device)
                for k in ("ll", "lp", "move_acc", "swap_acc"))
            if rounds_done:
                chunks.append(tuple(
                    torch.as_tensor(pt_resume[k], device=device)
                    for k in ("chain", "chain_ll", "chain_lp")))
            new_evals = 0
        else:
            rounds_done = 0
            ll, lp = logl_logp(z.reshape(-1, d))
            ll, lp = ll.reshape(n_temps, n_samples), lp.reshape(n_temps,
                                                                n_samples)
            move_acc = torch.zeros(n_temps, dtype=dtype, device=device)
            swap_acc = torch.zeros(max(n_temps - 1, 0), dtype=dtype,
                                   device=device)
            new_evals = n_temps * n_samples  # the initial pass

        def flush():
            if pending:
                chunks.append(tuple(torch.stack([r[i] for r in pending])
                                    for i in range(3)))
                pending.clear()

        for r in range(rounds_done, n_rounds):
            for _ in range(swap_every):
                z, ll, lp, n_acc = one_move(z, ll, lp)
                move_acc = move_acc + n_acc
            for lo, other, pair in passes:
                z, ll, lp, swap_acc = swap_pass(z, ll, lp, swap_acc, lo,
                                                other, pair)
            pending.append((z, ll, lp))
            # One tempered density pass per move.
            new_evals += swap_every * n_temps * n_samples
            if save_every is not None and ((r + 1) % save_every == 0
                                           or r + 1 == n_rounds):
                flush()
                self.save_pt_state(
                    checkpoint_file_path, betas=betas,
                    generator=self.generator, rounds_done=r + 1,
                    swap_every=swap_every, n_steps=n_steps,
                    n_samples=n_samples, a=a,
                    carry=(z, ll, lp, move_acc, swap_acc), chunks=chunks)
        flush()
        self.n_likelihood_evaluations += new_evals

        # (n_rounds, T, n, ...) -> (T, n_rounds, n, ...)
        chain, chain_ll, chain_lp = (
            torch.cat([c[i] for c in chunks]).transpose(0, 1)
            for i in range(3))
        flat = chain.reshape(-1, d)
        if precond is None:
            x = flat
            log_j = torch.zeros(flat.shape[0], dtype=dtype, device=device)
        else:
            x, log_j = precond.inverse(flat)
        samples = PTMCMCSamples(
            x=x, chain_shape=(n_temps, n_rounds, n_samples),
            parameters=self.parameters, dtype=self.dtype, device=device,
            betas=betas)
        # The carried densities are the chain's: no second evaluation. The
        # carried logPi is the z-space density; the Jacobian comes off.
        samples.log_likelihood = chain_ll.reshape(-1)
        samples.log_prior = chain_lp.reshape(-1) - log_j
        samples.burn_in = burn_in
        samples.thin = thin
        samples.move_acceptance = (
            move_acc / (n_rounds * swap_every * n_samples)).cpu().numpy()
        samples.swap_acceptance = (
            swap_acc / (n_rounds * n_samples)).cpu().numpy()
        if len(samples.swap_acceptance):
            logger.info(
                "PT acceptance: moves mean %.3f (min %.3f); swaps mean %.3f "
                "(min %.3f at pair %d)",
                float(samples.move_acceptance.mean()),
                float(samples.move_acceptance.min()),
                float(samples.swap_acceptance.mean()),
                float(samples.swap_acceptance.min()),
                int(samples.swap_acceptance.argmin()))
        # The finished (T, rounds, n, d) chain with its ladder (a pilot
        # passes no path, so it never writes).
        self._maybe_checkpoint_chain(
            samples.chain, n_rounds * swap_every, checkpoint_file_path,
            checkpoint_every,
            extra_attrs={"betas": np.asarray(betas, dtype=float)})
        return samples
