"""Sampler base class: problem definition, evaluation count, initial draws,
and the replicate tier's statistics.

Counterpart of ``aspire_tpu/samplers/base.py`` without checkpointing. The
sampler owns the user ``log_likelihood``/``log_prior`` callables (each
takes a view with ``.x`` of shape ``(n, d)`` and returns ``(n,)``), the
flow proposal, the preconditioning transform, its device and a
``torch.Generator`` seeded from ``rng``.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable

import numpy as np
import torch

from ..flows.bijectors import standard_normal_log_prob, standard_normal_sample
from ..samples import Samples
from ..utils import resolve_dtype

logger = logging.getLogger("aspire_tpu_torch")


def combine_replicates(result, logzs, errs, label: str):
    """Attach the replicates' mean log Z to ``result`` with the
    consistency-scaled error: the between-replicate spread over sqrt(k)
    where it agrees with the single-run errors (within 1.5 times their
    rms), the spread itself where the replicates scatter beyond them, and
    at least the single-run rms over sqrt(k). The one rule of every
    replicate tier (SMC, PT)."""
    k = len(logzs)
    between_sd = float(np.std(logzs, ddof=1))
    single_rms = float(np.sqrt(np.mean(np.square(errs))))
    consistent = between_sd <= 1.5 * single_rms
    between = between_sd / math.sqrt(k) if consistent else between_sd
    single = single_rms / math.sqrt(k)
    result.log_evidence = float(np.mean(logzs))
    result.log_evidence_error = max(between, single)
    result.log_evidence_replicates = np.asarray(logzs)
    result.log_evidence_error_single = single_rms
    logger.info(
        "Replicated %s log evidence: %.3f +/- %.3f (between-run %.3f, "
        "single-run rms %.3f)", label, result.log_evidence,
        result.log_evidence_error, between, single_rms)
    return result


class _SamplesView:
    """The ``samples.x`` view handed to user callables."""

    __slots__ = ("x", "parameters")

    def __init__(self, x, parameters=None):
        self.x = x
        self.parameters = parameters

    def __len__(self):
        return self.x.shape[0]


def make_generator(rng: Any, device) -> torch.Generator:
    """A generator on ``device`` seeded from an int, a numpy Generator or
    None (a fresh seed)."""
    if isinstance(rng, torch.Generator):
        return rng
    if rng is None:
        seed = int(np.random.default_rng().integers(2**31 - 1))
    elif isinstance(rng, np.random.Generator):
        seed = int(rng.integers(2**31 - 1))
    elif isinstance(rng, (int, np.integer)):
        seed = int(rng)
    else:
        raise TypeError(f"Cannot interpret rng of type {type(rng)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class Sampler:
    def __init__(
        self,
        log_likelihood: Callable,
        log_prior: Callable,
        dims: int,
        prior_flow,
        dtype: Any = None,
        parameters: list[str] | None = None,
        preconditioning_transform=None,
        rng: Any = None,
        device: Any = None,
    ):
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.dims = dims
        self.prior_flow = prior_flow
        self.dtype = resolve_dtype(dtype)
        self.parameters = parameters
        self.preconditioning_transform = preconditioning_transform
        self.device = torch.device(
            device if device is not None else prior_flow.device)
        self.generator = make_generator(rng, self.device)
        self.n_likelihood_evaluations = 0
        self._capturable_target = None
        self._differentiable_target = None

    def _make_view(self, x) -> _SamplesView:
        return _SamplesView(x, parameters=self.parameters)

    def _replicate_evidence(self, k: int, run_one: Callable, label: str):
        """The ``n_replicates`` tier: ``k`` runs of ``run_one()`` (each
        returning ``(samples, log Z, error)`` and continuing the sampler's
        generator), the last run's samples given the replicates' log Z
        (:func:`combine_replicates`)."""
        logzs, errs = [], []
        result = None
        for r in range(k):
            logger.info("%s replicate %d/%d", label, r + 1, k)
            result, lz, err = run_one()
            logzs.append(float(lz))
            errs.append(float(err))
        return combine_replicates(result, logzs, errs, label)

    def evaluate_log_likelihood(self, x) -> torch.Tensor:
        self.n_likelihood_evaluations += int(x.shape[0])
        out = self.log_likelihood(self._make_view(x))
        return torch.as_tensor(out, device=x.device).reshape(-1)

    def evaluate_log_prior(self, x) -> torch.Tensor:
        out = self.log_prior(self._make_view(x))
        return torch.as_tensor(out, device=x.device).reshape(-1)

    def target_is_capturable(self) -> bool:
        """True if the user ``log_likelihood``/``log_prior`` can run inside
        the device ladder: the port's counterpart of the JAX package's
        ``target_is_jittable``, decided once per sampler.

        On a CUDA device, one call of each on a ``(2, d)`` tensor is
        captured in a CUDA graph on a side stream, after one eager call
        (a host read or a pageable host-to-device copy fails the capture).
        On the CPU, each must take the view of a ``(2, d)`` tensor and
        return a tensor of shape ``(2,)``. Any error gives False, logged.
        """
        if self._capturable_target is None:
            x = torch.zeros((2, self.dims), dtype=self.prior_flow.dtype,
                            device=self.device)

            def probe():
                view = self._make_view(x)
                out = (self.log_likelihood(view), self.log_prior(view))
                if not all(isinstance(v, torch.Tensor) and v.shape == (2,)
                           for v in out):
                    raise TypeError("the target did not return (2,) tensors")

            try:
                probe()
                if x.is_cuda:
                    # capture_begin/end, not torch.cuda.graph: that one
                    # synchronises and empties the allocator's cache on
                    # entry, which a probe per sampler would pay for.
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(torch.cuda.Stream(x.device)):
                        graph.capture_begin()
                        try:
                            probe()
                        finally:
                            graph.capture_end()
                self._capturable_target = True
            except Exception as err:  # noqa: BLE001 - any capture failure
                logger.info(
                    "Target density cannot be captured in a CUDA graph (%s: "
                    "%s); the host ladder runs it.", type(err).__name__, err)
                self._capturable_target = False
        return self._capturable_target

    def target_is_differentiable(self) -> bool:
        """True if autograd can differentiate the user ``log_likelihood``/
        ``log_prior``: the port's counterpart of the JAX package's rule
        that a gradient kernel needs a traceable target, decided once per
        sampler. One call of each on a ``(2, d)`` tensor that requires
        grad must return tensors, and their gradient with respect to it
        must be computable (a target that leaves torch, say through
        ``.numpy()``, fails); a tensor that does not depend on it (a
        constant prior) passes. Any error gives False, logged."""
        if self._differentiable_target is None:
            x = torch.zeros((2, self.dims), dtype=self.prior_flow.dtype,
                            device=self.device, requires_grad=True)
            try:
                with torch.enable_grad():
                    view = self._make_view(x)
                    out = (self.log_likelihood(view), self.log_prior(view))
                    if not all(isinstance(v, torch.Tensor) for v in out):
                        raise TypeError("the target did not return tensors")
                    wrt = [v.sum() for v in out if v.requires_grad]
                    if wrt:
                        torch.autograd.grad(wrt, x, allow_unused=True)
                self._differentiable_target = True
            except Exception as err:  # noqa: BLE001 - any autograd failure
                logger.info("Target density cannot be differentiated (%s: "
                            "%s).", type(err).__name__, err)
                self._differentiable_target = False
        return self._differentiable_target

    # -- preconditioning ---------------------------------------------------

    def fit_preconditioning_transform(self, x) -> torch.Tensor:
        if self.preconditioning_transform is None:
            return x
        return self.preconditioning_transform.fit(x)

    def invert_preconditioning(self, z):
        if self.preconditioning_transform is None:
            return z, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        return self.preconditioning_transform.inverse(z)

    # -- initial sampling --------------------------------------------------

    def _draw_batch(self, n: int):
        """One proposal batch with its densities: ``z ~ N(0, I)``, the
        flow's sampling pass (the coupling kernel on a CUDA batch), the
        data transform's inverse and both target densities."""
        flow = self.prior_flow
        z = standard_normal_sample((n, self.dims), self.generator,
                                   dtype=flow.dtype, device=self.device)
        x_t, log_det = flow.architecture.inverse(flow.params, z)
        x, log_j = flow.data_transform.inverse(x_t)
        log_q = standard_normal_log_prob(z) - log_det - log_j
        return (x, log_q, self.evaluate_log_prior(x),
                self.evaluate_log_likelihood(x))

    def draw_initial_samples(self, n_samples: int,
                             max_attempts: int = 100) -> Samples:
        """``n_samples`` draws from the flow with finite target densities;
        invalid draws are discarded and redrawn."""
        collected, n_drawn = [], 0
        for _ in range(max_attempts):
            x, log_q, log_prior, log_likelihood = self._draw_batch(n_samples)
            if not bool(torch.isfinite(log_q).all()):
                raise ValueError(
                    "Proposal returned non-finite log probabilities. "
                    "The proposal must be a valid, normalized probability "
                    "distribution with finite log probabilities."
                )
            valid = torch.isfinite(log_prior) & torch.isfinite(log_likelihood)
            n_valid = int(valid.sum())
            if n_valid:
                sel = slice(None) if n_valid == n_samples else valid
                collected.append(Samples(
                    x=x[sel], log_q=log_q[sel], log_prior=log_prior[sel],
                    log_likelihood=log_likelihood[sel], dtype=self.dtype,
                    parameters=self.parameters, device=self.device,
                ))
                n_drawn += n_valid
            if n_drawn >= n_samples:
                break
        else:
            raise RuntimeError(
                f"Failed to draw {n_samples} valid samples in "
                f"{max_attempts} attempts"
            )
        samples = (collected[0] if len(collected) == 1
                   else Samples.concatenate(collected))
        return samples[:n_samples]
