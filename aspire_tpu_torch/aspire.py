"""The user-facing ``Aspire`` facade (counterpart of ``aspire_tpu/aspire.py``
without pools or the flow-refit replicate tier).

``flow_matching=True`` makes the flow a CNF (:class:`~aspire_tpu_torch.
flows.FlowMatching`); ``preconditioning="flow"`` gives a sampler a flow
fitted to its particles as the transport map
(:class:`~aspire_tpu_torch.transforms.FlowPreconditioningTransform`).

Run files and the JAX package's three resume modes: ``fit`` and
``sample_posterior`` write the config, the flow, the sampler's
checkpoints and its record to ``checkpoint_path`` (HDF5, the JAX
package's layout); :meth:`Aspire.resume_from_file` rebuilds an ``Aspire``
from such a file and primes the next ``sample_posterior`` to continue the
run (mode 1); a sampler's ``resume_from`` continues from a file, bytes or
a state (mode 2); :meth:`Aspire.auto_checkpoint` scopes a file to a block
and, with ``resume=True``, loads its flow (skipping ``fit``) and primes the
continuation (mode 3).

``device`` defaults to the card (``"cuda"``): the flow, the samplers and
every tensor they make live there. A caller who wants the CPU passes
``device="cpu"``. Nothing detects a missing GPU and moves to the CPU.
"""

from __future__ import annotations

import json
import logging
from contextlib import contextmanager
from inspect import signature
from typing import Any, Callable

from .checkpointing import CheckpointPolicy, ResumeState, open_run_file
from .flows import Flow, default_architecture_for_backend, get_flow_class
from .history import FlowHistory
from .samplers import SMCSampler, get_sampler_class
from .samples import Samples
from .transforms import (
    CompositeTransform,
    FlowPreconditioningTransform,
    FlowTransform,
)
from .utils import function_id, resolve_device

logger = logging.getLogger("aspire_tpu_torch")

#: keywords of the JAX package's sampler constructors the port does not
#: implement: given to ``sample_posterior`` they raise, never dropped
UNPORTED_SAMPLER_INIT_KWARGS = ("mesh", "prng_impl", "resampling_impl")


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
        flow_matching: bool = False,
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
        self.flow_matching = flow_matching
        self.flow_kwargs = kwargs
        self.eps = eps
        self.dtype = dtype
        self.seed = seed
        self._flow = flow
        self._sampler = None
        #: the run-file state: a write policy for the current file and a
        #: primed continuation, swapped wholesale by ``auto_checkpoint``
        self._checkpoints: CheckpointPolicy | None = None
        self._resume: ResumeState | None = None
        self._skip_fit = False
        #: the last device ladder captured, kept across
        #: ``sample_posterior`` calls (each builds a fresh sampler): a run
        #: with the same shapes, options, target and flow parameters
        #: replays the graph an earlier call captured; any other run
        #: replaces it
        self.ladder_cache: dict = {}

    # -- properties -----------------------------------------------------------

    @property
    def flow(self) -> Flow | None:
        return self._flow

    @flow.setter
    def flow(self, flow: Flow) -> None:
        self._flow = flow

    @property
    def sampler(self):
        return self._sampler

    @property
    def n_likelihood_evaluations(self) -> int | None:
        if self._sampler is not None:
            return self._sampler.n_likelihood_evaluations
        return None

    def convert_to_samples(self, x, log_likelihood=None, log_prior=None,
                           log_q=None, evaluate: bool = True) -> Samples:
        """``x`` as :class:`Samples` of this problem, the target densities
        evaluated where not given (and the weights with a ``log_q``)."""
        samples = Samples(x=x, parameters=self.parameters,
                          log_likelihood=log_likelihood, log_prior=log_prior,
                          log_q=log_q, dtype=self.dtype, device=self.device)
        if evaluate:
            if log_prior is None:
                logger.info("Evaluating log prior")
                samples.log_prior = self.log_prior(samples)
            if log_likelihood is None:
                logger.info("Evaluating log likelihood")
                samples.log_likelihood = self.log_likelihood(samples)
            if samples.log_q is not None:
                samples.compute_weights()
        return samples

    def init_flow(self) -> None:
        """The flow, and its data transform in the flow's dtype: with
        ``dtype=None`` the flow's float32, not the float64 of the prior
        bounds as given, so its density is float32 on every route (as the
        whole-chain kernel's programs, lowered to float32, compute it)."""
        FlowClass = get_flow_class(self.flow_backend,
                                   flow_matching=self.flow_matching)
        flow_kwargs = dict(self.flow_kwargs)
        if FlowClass is Flow:
            flow_kwargs.setdefault(
                "architecture",
                default_architecture_for_backend(self.flow_backend))
        if self.dtype is not None:
            flow_kwargs.setdefault("dtype", str(self.dtype))
        if self.seed is not None:
            flow_kwargs.setdefault("seed", self.seed)
        self.flow = FlowClass(dims=self.dims, device=self.device,
                              **flow_kwargs)
        self.flow.data_transform = FlowTransform(
            parameters=self.parameters,
            prior_bounds=self.prior_bounds,
            bounded_to_unbounded=self.bounded_to_unbounded,
            bounded_transform=self.bounded_transform,
            eps=self.eps,
            dtype=self.flow.dtype,
            device=self.device,
        )

    def fit(self, samples: Samples, checkpoint_path: str | None = None,
            checkpoint_save_config: bool = True, overwrite: bool = False,
            **kwargs: Any) -> FlowHistory:
        """Fit the flow proposal to existing posterior samples; with
        ``checkpoint_path`` (or an ``auto_checkpoint`` file) the config and
        the flow go into the run file. In a resumed ``auto_checkpoint``
        context with a flow in hand the fit is skipped unless
        ``overwrite``."""
        if self.flow is None:
            self.init_flow()
        elif self._skip_fit and not overwrite:
            logger.info("Skipping flow training because a checkpointed flow "
                        "was loaded.")
            return FlowHistory()
        x = samples.x if hasattr(samples, "x") else samples
        history = self.flow.fit(x, **kwargs)

        policy = self._checkpoints
        if checkpoint_path is None and policy is not None:
            checkpoint_path = policy.path
            checkpoint_save_config = policy.owes("config")
        # Only the policy's own file settles its ledger.
        on_policy_file = (policy is not None
                          and str(checkpoint_path) == policy.path)
        if checkpoint_path is not None:
            from .io import AspireFile

            with AspireFile(checkpoint_path, "a") as h5_file:
                if checkpoint_save_config:
                    self.save_config(h5_file, "aspire_config")
                    if on_policy_file:
                        policy.settle("config")
                if "flow" in h5_file and overwrite:
                    del h5_file["flow"]
                if "flow" not in h5_file:
                    self.save_flow(h5_file)
                    if on_policy_file:
                        policy.settle("flow")
        return history

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
        """Build a sampler with its preconditioning transform ("none";
        "default"/"standard": the masked periodic/bounded/affine
        composite, dropped when it is a no-op; or "flow": a flow of this
        Aspire's backend, kwargs and ``flow_matching``, with no affine
        step, refitted to the particles at each use)."""
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
        elif preconditioning == "flow":
            pk = dict(affine_transform=False, parameters=self.parameters,
                      flow_backend=self.flow_backend,
                      flow_kwargs=self.flow_kwargs,
                      flow_matching=self.flow_matching,
                      periodic_parameters=self.periodic_parameters,
                      bounded_to_unbounded=self.bounded_to_unbounded,
                      prior_bounds=self.prior_bounds, dtype=self.dtype,
                      device=self.device)
            pk.update(preconditioning_kwargs or {})
            transform = FlowPreconditioningTransform(**pk)
        else:
            raise ValueError(
                f"Unknown preconditioning: {preconditioning}")
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

    def sample_posterior(self, n_samples: int | None = 1000,
                         sampler: str = "importance",
                         return_history: bool = False,
                         preconditioning: str | None = None,
                         preconditioning_kwargs: dict | None = None,
                         checkpoint_path: str | None = None,
                         checkpoint_every: int = 1,
                         checkpoint_save_config: bool = True,
                         **kwargs: Any):
        """Draw posterior samples with a fresh sampler (seeded from
        ``seed + 1``, so a fixed seed repeats the run). With
        ``return_history``, ``(samples, history)``: the sampler's history,
        or None for a sampler without one (importance), as in the JAX
        package. SMC takes ``device_ladder`` and ``device_ladder_max_iters``
        (:meth:`SMCSampler.sample`); its device ladder's graph stays in
        ``ladder_cache`` for the next call.

        ``checkpoint_path`` (or an ``auto_checkpoint`` file) gets the config
        and the flow before sampling, the sampler's checkpoints every
        ``checkpoint_every`` temperatures (SMC) or its chain (MCMC), and the
        config, the sampler's record and the flow after it. A primed
        continuation (``resume_from_file``, ``auto_checkpoint(resume=True)``)
        resumes the recorded sampler with the recorded ``n_samples``.

        As in the JAX package, keywords that neither the sampler's
        constructor nor its ``sample`` takes are dropped with a warning;
        the JAX package's constructor keywords the port lacks
        (``UNPORTED_SAMPLER_INIT_KWARGS``) raise ``TypeError``."""
        for name in UNPORTED_SAMPLER_INIT_KWARGS:
            if name in kwargs:
                raise TypeError(
                    f"sample_posterior() got {name!r}, which the port does "
                    "not implement")
        resume = self._resume
        if resume is not None:
            if sampler == "importance" and resume.sampler_type:
                # The default yields to the sampler the run used.
                sampler = resume.sampler_type
            if "resume_from" not in kwargs:
                kwargs["resume_from"] = resume.state
                kwargs.update(resume.sample_overrides)
                if resume.n_samples is not None and n_samples == 1000:
                    n_samples = resume.n_samples
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
        self._sampler = self.init_sampler(
            sampler, preconditioning=preconditioning,
            preconditioning_kwargs=preconditioning_kwargs, **init_kwargs)
        self._last_sampler_type = sampler
        sample_params = signature(SamplerClass.sample).parameters

        policy = self._checkpoints
        if checkpoint_path is None and policy is not None:
            checkpoint_path = policy.path
            checkpoint_every = policy.every
            checkpoint_save_config = policy.owes("config")
        on_policy_file = (policy is not None
                          and str(checkpoint_path) == policy.path)
        if checkpoint_path is not None:
            if not {"checkpoint_file_path",
                    "checkpoint_every"}.issubset(sample_params):
                logger.warning("Sampler %s does not support checkpointing. "
                               "Checkpoint will not be saved.", sampler)
            else:
                sample_kwargs.setdefault("checkpoint_file_path",
                                         checkpoint_path)
                sample_kwargs.setdefault("checkpoint_every",
                                         checkpoint_every)
            # The config and the flow go in before sampling, so a run
            # killed mid-flight can be resumed from the file.
            self._write_run_file(checkpoint_path, policy, on_policy_file,
                                 config=checkpoint_save_config)

        unknown = sorted(k for k in sample_kwargs if k not in sample_params)
        if unknown:
            logger.warning("Ignoring kwargs not supported by %s.sample: %s",
                           sampler, unknown)
            sample_kwargs = {k: v for k, v in sample_kwargs.items()
                             if k in sample_params}
        samples = self._sampler.sample(n_samples, **sample_kwargs)
        if checkpoint_path is not None:
            self._write_run_file(checkpoint_path, policy, on_policy_file,
                                 config=checkpoint_save_config, after=True)
        samples.parameters = self.parameters
        if return_history:
            return samples, getattr(self._sampler, "history", None)
        return samples

    def _write_run_file(self, path: str, policy, on_policy_file: bool, *,
                        config: bool, after: bool = False) -> None:
        """The run file's config (before sampling where it is absent; after
        sampling always, which settles the policy's), after sampling the
        sampler's record, and the flow once per policy."""
        from .io import AspireFile

        with AspireFile(path, "a") as h5_file:
            if config and (after or "aspire_config" not in h5_file):
                self.save_config(h5_file, "aspire_config")
                if after and on_policy_file:
                    policy.settle("config")
            if after:
                self.save_sampler_config(h5_file, include_sample_calls="last")
            if self.flow is not None and (not on_policy_file
                                          or policy.owes("flow")):
                if "flow" not in h5_file:
                    self.save_flow(h5_file)
                if on_policy_file:
                    policy.settle("flow")

    # -- config and persistence -------------------------------------------------

    def config_dict(self, include_sampler_config: bool = False, **kwargs):
        """The JAX package's problem record (callables by id)."""
        config = {
            "log_likelihood": function_id(self.log_likelihood),
            "log_prior": function_id(self.log_prior),
            "dims": self.dims,
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self.prior_bounds,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "flow_matching": self.flow_matching,
            "flow_backend": self.flow_backend,
            "flow_kwargs": self.flow_kwargs,
            "eps": self.eps,
            "dtype": str(self.dtype) if self.dtype else None,
        }
        if include_sampler_config:
            if hasattr(self, "_last_sampler_type"):
                config["sampler_type"] = self._last_sampler_type
            if self.sampler is None:
                raise ValueError("Sampler has not been initialized.")
            config["sampler_config"] = self.sampler.config_dict(**kwargs)
        return config

    def save_config(self, h5_file, path: str = "aspire_config", **kwargs):
        from .io import save_dict_to_hdf5

        save_dict_to_hdf5(h5_file, path, self.config_dict(**kwargs))

    def save_sampler_config(self, h5_file, path: str = "sampler_config",
                            **kwargs):
        from .io import save_dict_to_hdf5

        config = self.sampler.config_dict(**kwargs) if self.sampler else {}
        if hasattr(self, "_last_sampler_type"):
            config["sampler_type"] = self._last_sampler_type
        save_dict_to_hdf5(h5_file, path, config)

    def save_flow(self, h5_file, path: str = "flow") -> None:
        if self.flow is None:
            raise ValueError("Flow has not been initialized.")
        self.flow.save(h5_file, path=path)

    def load_flow(self, h5_file, path: str = "flow") -> None:
        """The flow saved at ``path`` (by either package), on this
        ``Aspire``'s device."""
        FlowClass = get_flow_class(self.flow_backend,
                                   flow_matching=self.flow_matching)
        self.flow = FlowClass.load(h5_file, path=path, device=self.device)

    def save_config_to_json(self, filename: str) -> None:
        with open(filename, "w") as f:
            json.dump(self.config_dict(), f, indent=4, default=str)

    # -- the three resume modes ---------------------------------------------------

    @classmethod
    def resume_from_file(cls, file_path: str, *, log_likelihood: Callable,
                         log_prior: Callable, sampler: str | None = None,
                         checkpoint_path: str = "checkpoint",
                         checkpoint_dset: str = "state",
                         flow_path: str = "flow",
                         config_path: str = "aspire_config",
                         resume_kwargs: dict | None = None,
                         device: Any = "cuda") -> "Aspire":
        """Mode 1: an ``Aspire`` rebuilt from a run file (either package's)
        on ``device``, the callables supplied again, the stored flow loaded,
        and the next ``sample_posterior()`` primed to continue the
        checkpointed run with the recorded sampler and ``n_samples``."""
        from .checkpointing import RunFile

        run = RunFile(file_path, config_group=config_path,
                      flow_group=flow_path, checkpoint_group=checkpoint_path,
                      state_dset=checkpoint_dset)
        aspire = cls(log_likelihood=log_likelihood, log_prior=log_prior,
                     device=device, **run.constructor_kwargs(cls))
        run.load_flow_into(aspire, required=True)
        aspire._resume = run.resume_state(sampler=sampler,
                                          overrides=resume_kwargs)
        # Later checkpoints go on into the same file, which has both.
        aspire._checkpoints = CheckpointPolicy(path=str(file_path),
                                               config=False, flow=False)
        return aspire

    @contextmanager
    def auto_checkpoint(self, path: str, every: int = 1,
                        save_config: bool = True, save_flow: bool = True,
                        resume: bool = False):
        """Mode 3: within the block ``fit`` and ``sample_posterior`` write
        to ``path``. With ``resume=True`` and an existing file its flow is
        loaded (``fit`` is then skipped) and its checkpoint primes the next
        ``sample_posterior``. On exit the previous policy, continuation and
        fit skip come back."""
        outer = (self._checkpoints, self._resume, self._skip_fit)
        self._checkpoints = CheckpointPolicy(path=str(path), every=every,
                                             config=save_config,
                                             flow=save_flow)
        if resume:
            run = open_run_file(str(path))
            if run is not None:
                logger.info("Resuming run file %s", path)
                self._resume = run.resume_state()
                if run.config is not None:
                    self._checkpoints.settle("config")
                if run.load_flow_into(self, required=False):
                    self._checkpoints.settle("flow")
                self._skip_fit = self.flow is not None
        try:
            yield self
        finally:
            self._checkpoints, self._resume, self._skip_fit = outer
