"""The user-facing ``Aspire`` facade (counterpart of ``aspire_tpu/aspire.py``
without checkpointing, resume, pools or replicated evidence).

``device`` defaults to the card (``"cuda"``): the flow, the samplers and
every tensor they make live there. A caller who wants the CPU passes
``device="cpu"``. Nothing detects a missing GPU and moves to the CPU.
"""

from __future__ import annotations

import logging
from inspect import signature
from typing import Any, Callable

from .flows import Flow, default_architecture_for_backend, get_flow_class
from .history import FlowHistory
from .samplers import SMCSampler, get_sampler_class
from .samples import Samples
from .transforms import CompositeTransform, FlowTransform
from .utils import resolve_device

logger = logging.getLogger("aspire_tpu_torch")


class Aspire:
    """Sequential posterior inference via reuse, on one torch device.

    Parameters mirror the JAX package's ``Aspire``; ``device`` (the card,
    ``"cuda"``, by default; ``"cpu"`` on request) places the flow and the
    samplers; extra
    keyword arguments go to the flow constructor (``architecture``,
    ``n_layers``, ``n_hidden``, ...).
    """

    def __init__(
        self,
        *,
        log_likelihood: Callable,
        log_prior: Callable,
        dims: int,
        device: Any = "cuda",
        parameters: list[str] | None = None,
        periodic_parameters: list[str] | None = None,
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "logit",
        flow: Flow | None = None,
        flow_backend: str = "maf",
        eps: float = 1e-6,
        dtype: Any = None,
        seed: int | None = None,
        **kwargs: Any,
    ) -> None:
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.dims = dims
        self.device = resolve_device(device)
        self.parameters = (list(parameters) if parameters is not None
                           else [f"x_{i}" for i in range(dims)])
        self.periodic_parameters = periodic_parameters
        self.prior_bounds = prior_bounds
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.flow_backend = flow_backend
        self.flow_kwargs = kwargs
        self.eps = eps
        self.dtype = dtype
        self.seed = seed
        self.flow = flow
        self.sampler = None
        #: the last device ladder captured, kept across
        #: ``sample_posterior`` calls (each builds a fresh sampler): a run
        #: with the same shapes, options, target and flow parameters
        #: replays the graph an earlier call captured; any other run
        #: replaces it
        self.ladder_cache: dict = {}

    def init_flow(self) -> None:
        FlowClass = get_flow_class(self.flow_backend)
        data_transform = FlowTransform(
            parameters=self.parameters,
            prior_bounds=self.prior_bounds,
            bounded_to_unbounded=self.bounded_to_unbounded,
            bounded_transform=self.bounded_transform,
            eps=self.eps,
            dtype=self.dtype,
            device=self.device,
        )
        flow_kwargs = dict(self.flow_kwargs)
        flow_kwargs.setdefault(
            "architecture", default_architecture_for_backend(self.flow_backend))
        if self.dtype is not None:
            flow_kwargs.setdefault("dtype", str(self.dtype))
        if self.seed is not None:
            flow_kwargs.setdefault("seed", self.seed)
        self.flow = FlowClass(dims=self.dims, data_transform=data_transform,
                              device=self.device, **flow_kwargs)

    def fit(self, samples: Samples, **kwargs: Any) -> FlowHistory:
        """Fit the flow proposal to existing posterior samples."""
        if self.flow is None:
            self.init_flow()
        x = samples.x if hasattr(samples, "x") else samples
        return self.flow.fit(x, **kwargs)

    def sample_flow(self, n_samples: int = 1) -> Samples:
        if self.flow is None:
            self.init_flow()
        x, log_q = self.flow.sample_and_log_prob(n_samples)
        return Samples(x=x, log_q=log_q, parameters=self.parameters,
                       dtype=self.dtype, device=self.device)

    def init_sampler(self, sampler_type: str,
                     preconditioning: str | None = None,
                     preconditioning_kwargs: dict | None = None,
                     **kwargs: Any):
        """Build a sampler with its preconditioning transform ("none", or
        "default"/"standard": the masked periodic/bounded/affine
        composite, dropped when it is a no-op)."""
        SamplerClass = get_sampler_class(sampler_type)
        if sampler_type != "importance" and preconditioning is None:
            preconditioning = "default"
        preconditioning = preconditioning.lower() if preconditioning else None
        if preconditioning in (None, "none"):
            transform = None
        elif preconditioning in ("standard", "default"):
            pk = dict(preconditioning_kwargs or {})
            pk.setdefault("affine_transform", False)
            pk.setdefault("bounded_to_unbounded", False)
            pk.setdefault("bounded_transform", "logit")
            transform = CompositeTransform(
                parameters=self.parameters, prior_bounds=self.prior_bounds,
                periodic_parameters=self.periodic_parameters,
                dtype=self.dtype, device=self.device, **pk)
            if transform.is_identity:
                transform = None
        else:
            raise ValueError(
                f"Unknown or unported preconditioning: {preconditioning}")
        if self.seed is not None:
            kwargs.setdefault("rng", self.seed + 1)
        if issubclass(SamplerClass, SMCSampler):
            kwargs.setdefault("ladder_cache", self.ladder_cache)
        return SamplerClass(
            log_likelihood=self.log_likelihood,
            log_prior=self.log_prior,
            dims=self.dims,
            prior_flow=self.flow,
            dtype=self.dtype,
            preconditioning_transform=transform,
            parameters=self.parameters,
            device=self.device,
            **kwargs,
        )

    def sample_posterior(self, n_samples: int = 1000,
                         sampler: str = "importance",
                         return_history: bool = False,
                         preconditioning: str | None = None,
                         preconditioning_kwargs: dict | None = None,
                         **kwargs: Any):
        """Draw posterior samples with a fresh sampler (seeded from
        ``seed + 1``, so a fixed seed repeats the run). With
        ``return_history``, ``(samples, history)``: the sampler's history,
        or None for a sampler without one (importance), as in the JAX
        package. SMC takes ``device_ladder`` and ``device_ladder_max_iters``
        (:meth:`SMCSampler.sample`); its device ladder's graph stays in
        ``ladder_cache`` for the next call."""
        SamplerClass = get_sampler_class(sampler)
        init_params: dict = {}
        for klass in SamplerClass.__mro__:
            init = klass.__dict__.get("__init__")
            if init is not None:
                init_params.update(signature(init).parameters)
        reserved = {"self", "args", "kwargs", "log_likelihood", "log_prior",
                    "dims", "prior_flow", "dtype",
                    "preconditioning_transform", "parameters", "device"}
        init_kwargs = {k: v for k, v in kwargs.items()
                       if k in init_params and k not in reserved}
        sample_kwargs = {k: v for k, v in kwargs.items()
                         if k not in init_kwargs}
        self.sampler = self.init_sampler(
            sampler, preconditioning=preconditioning,
            preconditioning_kwargs=preconditioning_kwargs, **init_kwargs)
        samples = self.sampler.sample(n_samples, **sample_kwargs)
        samples.parameters = self.parameters
        if return_history:
            return samples, getattr(self.sampler, "history", None)
        return samples
