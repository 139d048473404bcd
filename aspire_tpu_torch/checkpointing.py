"""Run-file reading, checkpoint write policy, and resume state.

A *run file* is the single HDF5 artifact a checkpointed run produces:
problem config (``/aspire_config``), trained flow (``/flow``), the
latest sampler checkpoint (``/checkpoint/state`` plus shard-wise
particle arrays), and the sampler call record (``/sampler_config``).
This module owns both directions of that contract for the
orchestrator:

* :class:`CheckpointPolicy` — a context-scoped description of where a
  run writes its artifacts and which ones have been written already,
  so config/flow land in the file exactly once per run.
* :class:`ResumeState` — the decoded ingredients a primed
  ``sample_posterior`` call needs to continue an interrupted run.
* :class:`RunFile` — a one-pass reader that scans the file's groups on
  construction and exposes typed accessors for the pieces.

The three resume modes are the JAX package's (``aspire_tpu/
checkpointing.py``): file-level resume, primed call, and the
``auto_checkpoint`` context with its fit skip. The file is scanned once
and the orchestrator holds two slots (``_resume``, ``_checkpoints``)
swapped wholesale by the context manager. h5py is imported at first use.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .io import load_dict_from_hdf5

logger = logging.getLogger("aspire_tpu_torch")


@dataclass
class CheckpointPolicy:
    """Where the current run writes checkpoints, and what it still owes.

    ``config``/``flow`` toggle whether those artifacts belong in the
    file at all (a resumed run already has both, so they are off).
    ``written`` is the ledger of artifacts this policy has emitted;
    :meth:`owes` consults both so repeated ``fit``/``sample_posterior``
    calls inside one ``auto_checkpoint`` context write each artifact at
    most once.
    """

    path: str
    every: int = 1
    config: bool = True
    flow: bool = True
    written: set = field(default_factory=set)

    def owes(self, artifact: str) -> bool:
        enabled = getattr(self, artifact, True)
        return bool(enabled) and artifact not in self.written

    def settle(self, artifact: str) -> None:
        self.written.add(artifact)


@dataclass
class ResumeState:
    """Decoded continuation data for a primed ``sample_posterior``.

    ``state`` is the sampler checkpoint dict (samples, history, PRNG
    key, iteration, ...) exactly as ``Sampler.restore_from_checkpoint``
    accepts it — or None for parallel-tempering runs, whose
    ``resume_from`` file path rides in ``sample_overrides`` instead.
    The remaining fields steer the next call: which sampler registry
    name to use, the originally requested ``n_samples``, and any user
    overrides to merge into the ``sample()`` kwargs.
    """

    state: dict | None
    sampler_type: str | None = None
    n_samples: int | None = None
    sample_overrides: dict = field(default_factory=dict)


class RunFile:
    """One-pass reader for a run file (written by either package).

    Construction opens the HDF5 file once and records which groups are
    present plus the small config dictionaries; the heavyweight pieces
    (checkpoint state with its shard-wise arrays, flow weights) load on
    demand through :meth:`load_state` / :meth:`load_flow_into`.
    """

    def __init__(
        self,
        path: str,
        *,
        config_group: str = "aspire_config",
        sampler_group: str = "sampler_config",
        flow_group: str = "flow",
        checkpoint_group: str = "checkpoint",
        state_dset: str = "state",
    ) -> None:
        from .io import h5py_module

        h5py = h5py_module()
        self.path = str(path)
        self.config_group = config_group
        self.flow_group = flow_group
        self.checkpoint_group = checkpoint_group
        self.state_dset = state_dset

        with h5py.File(self.path, "r") as f:
            self.config = (
                load_dict_from_hdf5(f, config_group)
                if config_group in f
                else None
            )
            standalone = (
                load_dict_from_hdf5(f, sampler_group)
                if sampler_group in f
                else None
            )
            self.has_flow = flow_group in f
            self.has_checkpoint = (
                checkpoint_group in f and state_dset in f[checkpoint_group]
            )
            # Parallel-tempering runs persist a group-shaped state
            # instead of the SMC state blob (mcmc.py pt_state_path).
            # Its small attrs are read eagerly: a run killed mid-flight
            # has NO sampler record yet (the facade writes it after
            # sample() returns), so these attrs are the only source of
            # the continuation kwargs on genuine crash recovery.
            self.pt_state_attrs: dict | None = None
            for pt_name in ("pt_state", "pt_state_new"):
                group = f"{checkpoint_group}/{pt_name}"
                if group in f:
                    self.pt_state_attrs = dict(f[group].attrs)
                    break
            self.has_pt_state = self.pt_state_attrs is not None

        # The sampler record may live embedded in the aspire config or
        # as its own group; an embedded record wins because it was
        # written by the same sample_posterior call as the config.
        self.sampler_type: str | None = None
        self.sampler_config: dict | None = None
        if self.config is not None:
            self.sampler_type = self.config.get("sampler_type")
            self.sampler_config = self.config.get("sampler_config")
        if standalone is not None:
            self.sampler_type = self.sampler_type or standalone.get(
                "sampler_type"
            )
            if self.sampler_config is None:
                self.sampler_config = {
                    k: v
                    for k, v in standalone.items()
                    if k != "sampler_type"
                }

    # -- checkpoint state --------------------------------------------------

    def load_state(self) -> dict | None:
        """Decode the sampler checkpoint, or None when unusable.

        The particle arrays come back as host numpy
        (``Sampler.load_checkpoint_from_file``); the resumed sampler places
        them on its device when it restores.
        """
        if not self.has_checkpoint:
            logger.warning(
                "%s has no checkpoint at %s/%s — resuming with the flow "
                "and config only.",
                self.path,
                self.checkpoint_group,
                self.state_dset,
            )
            return None
        from .samplers.base import Sampler

        try:
            return Sampler.load_checkpoint_from_file(
                self.path, path=self.checkpoint_group
            )
        except Exception:
            logger.warning(
                "Could not decode the checkpoint in %s — treating the "
                "run file as flow/config only.",
                self.path,
                exc_info=True,
            )
            return None

    #: recorded sample() kwargs replayed when resuming a PT run — the
    #: resume validates n_steps/swap_every/n_samples/a against the
    #: file, so the replay makes a bare ``sample_posterior()`` after
    #: ``resume_from_file`` just work.
    _PT_RESUME_KWARGS = (
        "n_steps",
        "swap_every",
        "a",
        "n_temperatures",
        "burn_in",
        "thin",
        "checkpoint_file_path",
        "checkpoint_every",
        "state_checkpoint_every",
    )

    def resume_state(
        self,
        *,
        sampler: str | None = None,
        overrides: dict | None = None,
    ) -> ResumeState | None:
        """Bundle the checkpoint into a :class:`ResumeState` (or None).

        SMC runs resume from the decoded state blob; parallel-tempering
        runs resume from the file path itself (the PT sampler's
        ``resume_from`` contract) with the recorded sample kwargs
        replayed so the continuation call needs no arguments.
        """
        kind = sampler or self.sampler_type
        if self.has_pt_state and not self.has_checkpoint and kind in (
            # kind None: the run was killed before the facade's
            # post-sample sampler record was written — the PT state
            # group itself identifies the sampler.
            None,
            "ptmcmc",
            "parallel_tempered",
        ):
            # Continuation kwargs: the recorded sample call when the
            # run completed at least once, else the validated attrs
            # the PT state itself carries (crash recovery).
            recorded: dict = {}
            for k, v in (self.pt_state_attrs or {}).items():
                if k not in ("n_steps", "swap_every", "a"):
                    continue
                # numpy attr scalars -> Python scalars (a np.float64
                # `a` would strong-type the stretch proposal to f64).
                recorded[k] = (
                    float(v) if k == "a" else int(v)
                )
            calls = (self.sampler_config or {}).get("sample_calls")
            if isinstance(calls, dict) and isinstance(
                calls.get("kwargs"), dict
            ):
                recorded.update(
                    {
                        k: v
                        for k, v in calls["kwargs"].items()
                        if k in self._PT_RESUME_KWARGS
                    }
                )
            recorded["resume_from"] = self.path
            recorded.update(overrides or {})
            n_req = self.recorded_n_samples(None)
            if n_req is None:
                n_req = int((self.pt_state_attrs or {})["n_samples"])
            return ResumeState(
                state=None,
                sampler_type=kind or "ptmcmc",
                n_samples=n_req,
                sample_overrides=recorded,
            )
        state = self.load_state()
        if state is None:
            return None
        return ResumeState(
            state=state,
            sampler_type=sampler or self.sampler_type,
            n_samples=self.recorded_n_samples(state),
            sample_overrides=dict(overrides or {}),
        )

    def recorded_n_samples(self, state: dict | None = None) -> int | None:
        """The ``n_samples`` of the interrupted run.

        Preferred source: the recorded ``sample()`` call in the sampler
        config (first positional argument, else the ``n_samples``
        kwarg). Fallback: the checkpointed population size.
        """
        calls = (self.sampler_config or {}).get("sample_calls")
        if isinstance(calls, dict):
            for candidate in (
                _first_element(calls.get("args")),
                (calls.get("kwargs") or {}).get("n_samples")
                if isinstance(calls.get("kwargs"), dict)
                else None,
            ):
                try:
                    if candidate is not None:
                        return int(candidate)
                except (TypeError, ValueError):
                    continue
        if state is not None and state.get("samples") is not None:
            return len(state["samples"])
        return None

    # -- flow --------------------------------------------------------------

    def load_flow_into(self, aspire, *, required: bool) -> bool:
        """Load the stored flow into an orchestrator. True on success."""
        from .io import h5py_module

        if self.has_flow:
            logger.info(
                "Loading flow '%s' from %s", self.flow_group, self.path
            )
            with h5py_module().File(self.path, "r") as f:
                aspire.load_flow(f, path=self.flow_group)
            return True
        if required:
            raise ValueError(
                f"{self.path} does not contain a flow at "
                f"'{self.flow_group}'"
            )
        logger.warning(
            "%s has no flow at '%s'; the orchestrator keeps its current "
            "flow (if any).",
            self.path,
            self.flow_group,
        )
        return False

    # -- orchestrator reconstruction ---------------------------------------

    def constructor_kwargs(self, aspire_cls) -> dict:
        """Rebuild ``Aspire(**kwargs)`` from the stored config.

        The stored config is flat; callables are stored as id strings
        and must be re-supplied by the caller, flow kwargs were
        flattened into their own sub-dict, and anything the constructor
        does not name rides through ``**kwargs`` to the flow.
        """
        from inspect import signature

        if self.config is None:
            raise ValueError(
                f"{self.path} does not contain an aspire config at "
                f"'{self.config_group}'"
            )
        stored = dict(self.config)
        for derived in (
            "sampler_config",
            "sampler_type",
            "log_likelihood",
            "log_prior",
            # The JAX package's PRNG implementation: no port option.
            "prng_impl",
        ):
            stored.pop(derived, None)
        flow_kwargs = stored.pop("flow_kwargs", None) or {}

        named = set(signature(aspire_cls.__init__).parameters)
        kwargs = {k: v for k, v in stored.items() if k in named}
        # Unrecognized keys are forwarded — they were flow kwargs that a
        # newer/older version recorded at the top level.
        kwargs.update(
            {k: v for k, v in stored.items() if k not in named}
        )
        kwargs.update(flow_kwargs)
        return kwargs


def open_run_file(path: str, **layout: Any) -> RunFile | None:
    """RunFile for ``path`` if it exists and is readable, else None."""
    if not Path(path).is_file():
        return None
    try:
        return RunFile(path, **layout)
    except OSError:
        logger.warning(
            "Could not open run file %s; starting fresh.",
            path,
            exc_info=True,
        )
        return None


def _first_element(value: Any) -> Any:
    """First element of a stored args sequence (None when empty/absent)."""
    if value is None or isinstance(value, (str, bytes, dict)):
        return None
    try:
        return value[0] if len(value) else None
    except TypeError:
        return None
