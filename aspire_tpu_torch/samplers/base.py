"""Sampler base class: problem definition, evaluation count, initial draws.

Counterpart of ``aspire_tpu/samplers/base.py`` without checkpointing. The
sampler owns the user ``log_likelihood``/``log_prior`` callables (each
takes a view with ``.x`` of shape ``(n, d)`` and returns ``(n,)``), the
flow proposal, the preconditioning transform, its device and a
``torch.Generator`` seeded from ``rng``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch

from ..flows.bijectors import standard_normal_log_prob, standard_normal_sample
from ..samples import Samples
from ..utils import resolve_dtype

logger = logging.getLogger("aspire_tpu_torch")


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

    def _make_view(self, x) -> _SamplesView:
        return _SamplesView(x, parameters=self.parameters)

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
