"""Sampler base class: problem definition, evaluation count, initial draws,
the replicate tier's statistics, config capture and the checkpoint
protocol.

Counterpart of ``aspire_tpu/samplers/base.py``. The sampler owns the user
``log_likelihood``/``log_prior`` callables (each takes a view with ``.x``
of shape ``(n, d)`` and returns ``(n,)``), the flow proposal, the
preconditioning transform, its device and a ``torch.Generator`` seeded
from ``rng``. With a ``mesh`` (:mod:`aspire_tpu_torch.parallel.mesh`, whose
docstring gives the model of execution) the device is the mesh's and the
particle arrays are sharded over its ranks (:meth:`Sampler.shard_array`).

A checkpoint state is a dict of host data only (numpy arrays, Python
scalars, the port's history and samples with numpy fields), so it
unpickles without a card. It carries the generator's state
(``generator_state``, with ``generator_device``) in place of the JAX
package's PRNG key; a JAX package checkpoint's ``key`` seeds the generator
by :func:`seed_from_jax_key` (not the JAX stream). On file, the JAX
package's layout: ``checkpoint/state`` (the pickled state) and
``checkpoint/arrays/<field>`` (the particle arrays). On a mesh of more
than one rank every rank writes its own rows, as shard blocks, to its own
file (the main file on rank 0, ``<file>.proc<rank>`` elsewhere), rank 0
the state, and the ranks meet at a barrier; loading reassembles the arrays
across the files, so the reading mesh need not be the writing one.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import math
import pickle
from typing import Any, Callable

import numpy as np
import torch

from ..flows.bijectors import standard_normal_log_prob, standard_normal_sample
from ..samples import Samples
from ..utils import dtype_name, function_id, resolve_dtype

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


def seed_from_jax_key(key) -> int:
    """The generator seed for a JAX package checkpoint's ``key`` (its key
    data, any PRNG implementation): the first 8 bytes of the SHA-256 of the
    key data as little-endian uint32 words, read as a little-endian
    unsigned integer. A resumed run then draws a fixed stream of its own,
    not the JAX package's."""
    words = np.ascontiguousarray(np.asarray(key), dtype="<u4").tobytes()
    return int.from_bytes(hashlib.sha256(words).digest()[:8], "little")


def generator_state(generator: torch.Generator) -> dict:
    """A generator's state as host data: its bytes and its device type."""
    return {"generator_state": generator.get_state().numpy().copy(),
            "generator_device": generator.device.type}


def restore_generator(generator: torch.Generator, state: dict) -> None:
    """Set ``generator`` from a checkpoint: the port's own state (whose
    device type must be the generator's: a CPU state on a CUDA generator,
    or the reverse, raises ``ValueError``), else a JAX package ``key``
    (:func:`seed_from_jax_key`); a state with neither leaves it as it is."""
    if state.get("generator_state") is not None:
        saved = state.get("generator_device")
        if saved != generator.device.type:
            raise ValueError(
                f"the checkpoint's generator state was written on a {saved} "
                f"generator; this sampler's generator is on "
                f"{generator.device.type}: resume on a {saved} device")
        generator.set_state(torch.as_tensor(
            np.asarray(state["generator_state"], dtype=np.uint8)))
    elif state.get("key") is not None:
        generator.manual_seed(seed_from_jax_key(state["key"]))


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
        mesh: Any = None,
    ):
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.dims = dims
        self.prior_flow = prior_flow
        self.dtype = resolve_dtype(dtype)
        self.parameters = parameters
        self.preconditioning_transform = preconditioning_transform
        self.mesh = mesh
        self.device = torch.device(
            device if device is not None else prior_flow.device)
        if mesh is not None:
            self.device = self._mesh_device(mesh)
        self.generator = make_generator(rng, self.device)
        self.n_likelihood_evaluations = 0
        self._capturable_target = None
        self._differentiable_target = None
        self._call_history: dict = {}

    def _mesh_device(self, mesh) -> torch.device:
        """The mesh's device, which the flow's must be (a bare ``"cuda"``
        is the current card)."""
        def placed(d):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                return torch.device("cuda", torch.cuda.current_device())
            return d

        if placed(self.prior_flow.device) != mesh.device:
            raise ValueError(
                f"the flow is on {self.prior_flow.device} and the mesh's "
                f"rank {mesh.rank} on {mesh.device}: build the flow (the "
                "Aspire) on the mesh's device")
        return mesh.device

    # -- sharding ------------------------------------------------------------

    def shard_array(self, x):
        """This rank's rows of ``x`` where its leading (particle) axis
        divides by the mesh size; ``x`` itself otherwise or without a
        mesh."""
        if self.mesh is None or x.dim() < 1 or x.shape[0] % self.mesh.size:
            return x
        return self.mesh.local_rows(x)

    def multiprocess(self) -> bool:
        """True on a mesh of more than one rank."""
        return self.mesh is not None and self.mesh.size > 1

    def check_replicated_flow(self) -> None:
        """On a mesh of more than one rank: raise ``ValueError`` unless
        every rank's flow parameters and data transform (the tensors the
        device ladder's cache compares) are bit-identical. One all-gather
        of a float64 digest per tensor; nothing is broadcast."""
        if not self.multiprocess():
            return
        from ..flows.train import param_leaves
        from ..parallel.mesh import all_gather_rows
        from .smc import _tensors_of

        flow = self.prior_flow
        digests = [float(int.from_bytes(hashlib.sha256(
            t.detach().cpu().numpy().tobytes()).digest()[:6], "little"))
            for t in (*param_leaves(flow.params),
                      *_tensors_of(flow.data_transform))]
        mine = torch.tensor(digests, dtype=torch.float64,
                            device=self.device)
        every = all_gather_rows(mine[None], self.mesh)
        differ = [r for r in range(self.mesh.size)
                  if not torch.equal(every[r], every[0])]
        if differ:
            raise ValueError(
                f"the flow differs between ranks: ranks {differ} hold "
                "parameters or a data transform other than rank 0's (every "
                "rank must hold the same flow: fit it with the same seed "
                "and data, or load the same weights)")

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

    def apply_preconditioning(self, x):
        if self.preconditioning_transform is None:
            return x
        return self.preconditioning_transform.forward(x)[0]

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

    # -- config --------------------------------------------------------------

    #: sample() kwargs scrubbed from recorded calls: they point at
    #: artifacts of a previous run a replayed call must not open again
    _scrub_sample_kwargs: tuple = ("resume_from",)

    def config_dict(self, include_sample_calls: str | bool = "last") -> dict:
        """The JAX package's sampler record: class, dims, names, dtype, the
        callables' ids, the evaluations and the last (or every) recorded
        ``sample`` call."""
        config = {
            "class": type(self).__name__,
            "dims": self.dims,
            "parameters": self.parameters,
            "dtype": dtype_name(self.dtype),
            "log_likelihood": function_id(self.log_likelihood),
            "log_prior": function_id(self.log_prior),
            "n_likelihood_evaluations": self.n_likelihood_evaluations,
        }
        history = self._call_history.get("sample")
        if history and include_sample_calls:
            calls = history.to_dict()
            if include_sample_calls == "last":
                config["sample_calls"] = calls[str(len(history.calls) - 1)]
                recorded = [config["sample_calls"]]
            else:
                config["sample_calls"] = calls
                recorded = list(calls.values())
            for call in recorded:
                for key in self._scrub_sample_kwargs:
                    call["kwargs"].pop(key, None)
        return config

    # -- checkpoint protocol -----------------------------------------------

    @staticmethod
    def _history_snapshot(samples: Samples, mesh) -> Samples:
        """A host snapshot of the population for ``sample_history`` and the
        checkpoints (the JAX package's ``_history_snapshot``): all of it,
        or on a mesh of more than one rank this rank's rows, tagged with
        their global offset (``shard_starts``, ``shard_sizes``,
        ``global_n``), which :meth:`Sampler.save_checkpoint_to_hdf` writes
        as this rank's shard blocks. No gather."""
        snap = samples.to_numpy()
        if mesh is not None and mesh.size > 1:
            m = len(snap.x)
            snap.shard_starts = [mesh.rank * m]
            snap.shard_sizes = [m]
            snap.global_n = m * mesh.size
        return snap

    #: array fields of the samples written as arrays of their own on file
    _CHECKPOINT_ARRAY_FIELDS = ("x", "log_likelihood", "log_prior", "log_q")

    def build_checkpoint_state(self, samples, iteration: int,
                               meta: dict | None = None,
                               generator: torch.Generator | None = None,
                               evaluations: int | None = None, mesh=None,
                               **extra) -> dict:
        """A checkpoint of host data: the samples as a host copy (on
        ``mesh``, the mesh the rows are sharded over, this rank's rows:
        :meth:`_history_snapshot`), the config, ``generator``'s state (the
        sampler's by default), the evaluations (the sampler's count by
        default) and what the sampler adds (:meth:`_checkpoint_extra_state`,
        given ``extra``)."""
        state = {
            "sampler_class": type(self).__name__,
            "iteration": iteration,
            "samples": (self._history_snapshot(samples, mesh)
                        if samples is not None else None),
            "config": self.config_dict(),
            "parameters": self.parameters,
            "meta": meta or {},
            **generator_state(generator or self.generator),
            "n_likelihood_evaluations": (self.n_likelihood_evaluations
                                         if evaluations is None
                                         else evaluations),
        }
        state.update(self._checkpoint_extra_state(**extra))
        return state

    def _checkpoint_extra_state(self) -> dict:
        return {}

    @staticmethod
    def serialize_checkpoint_state(state: dict) -> bytes:
        """The bytes of a checkpoint state (host data: they unpickle
        without a card)."""
        return pickle.dumps(state)

    def save_checkpoint_to_hdf(self, state: dict, file_path: str,
                               path: str = "checkpoint") -> None:
        """Write ``state`` (the JAX package's sharded writer): the particle
        arrays at ``{path}/arrays/<field>`` as shard datasets, the rest
        pickled at ``{path}/state`` with the samples' class, names and beta
        (``samples_spec``). Every process writes to its own file
        (:func:`~aspire_tpu_torch.io.process_checkpoint_path`): its rows
        where the samples are a shard-local snapshot, else the whole
        arrays; a history of shard-local snapshots goes in as each rank's
        blocks of every rung (``{path}/history/sample_history/<i>``), the
        blob keeping their class and beta (``history_shard_snapshots``).
        Only rank 0 writes the state; then every process waits at the
        barrier (:func:`~aspire_tpu_torch.io.checkpoint_barrier`)."""
        from ..io import (
            AspireFile,
            checkpoint_barrier,
            process_checkpoint_path,
            save_shard_blocks,
            save_sharded_array,
            save_state_bytes,
        )
        from ..parallel.mesh import process_index

        state = dict(state)
        samples = state.pop("samples", None)
        history = state.get("history")
        snaps = list(getattr(history, "sample_history", None) or [])
        shard_snaps = None
        if any(getattr(s, "shard_starts", None) is not None for s in snaps):
            shard_snaps = snaps
            hist_copy = copy.copy(history)
            hist_copy.sample_history = []
            state["history"] = hist_copy
            state["history_shard_snapshots"] = [
                {"class": type(s).__name__, "beta": getattr(s, "beta", None)}
                for s in snaps]
        with AspireFile(process_checkpoint_path(file_path), "a") as f:
            if samples is not None:
                for name in self._CHECKPOINT_ARRAY_FIELDS:
                    value = getattr(samples, name, None)
                    if value is not None:
                        save_sharded_array(
                            f, f"{path}/arrays/{name}", value,
                            *_shard_of(samples))
            for i, snap in enumerate(shard_snaps or ()):
                for name in self._CHECKPOINT_ARRAY_FIELDS:
                    value = getattr(snap, name, None)
                    if value is None:
                        continue
                    value = np.asarray(value)
                    starts, n = _shard_of(snap) or ([0], len(value))
                    save_shard_blocks(
                        f, f"{path}/history/sample_history/{i}/{name}",
                        value, (n,) + value.shape[1:], starts,
                        getattr(snap, "shard_sizes", None) or [len(value)])
            if process_index() == 0:
                if samples is not None:
                    state["samples_spec"] = {
                        "class": type(samples).__name__,
                        "parameters": samples.parameters,
                        "beta": getattr(samples, "beta", None)}
                save_state_bytes(f, pickle.dumps(state), path=path)
        checkpoint_barrier()

    def default_file_checkpoint_callback(
            self, file_path: str | None) -> Callable[[dict], None]:
        if file_path is None:
            raise ValueError(
                "checkpoint_file_path must be provided to use the default "
                "file checkpoint callback")

        def callback(state: dict) -> None:
            self.save_checkpoint_to_hdf(state, file_path)

        return callback

    @classmethod
    def load_checkpoint_from_file(cls, file_path: str,
                                  path: str = "checkpoint") -> dict:
        """A checkpoint written by either package, on any number of
        processes: its particle arrays reassembled across the main file and
        its ``.proc<rank>`` siblings (:func:`~aspire_tpu_torch.io.
        checkpoint_shard_files`) as host numpy in the samples (of the
        port's class the file names), and a shard-local sample history's
        populations rung by rung. A region no file covers raises."""
        from .. import samples as samples_module
        from ..io import (
            checkpoint_shard_files,
            h5py_module,
            load_pickle,
            load_sharded_array,
            load_state_bytes,
        )

        h5py = h5py_module()
        with h5py.File(file_path, "r") as f:
            state = load_pickle(load_state_bytes(f, path=path))
        spec = state.pop("samples_spec", None)
        snap_specs = state.pop("history_shard_snapshots", None)
        if spec is None and snap_specs is None:
            return state  # the samples rode in the blob

        def build(klass_name, arrays, parameters, beta):
            klass = getattr(samples_module, klass_name)
            kwargs = dict(arrays, parameters=parameters)
            if beta is not None and "beta" in klass.__dataclass_fields__:
                kwargs["beta"] = beta
            built = klass(**kwargs)
            # The saved bytes, not the constructor's conversions.
            for name, value in arrays.items():
                setattr(built, name, value)
            return built

        files = [h5py.File(p, "r") for p in checkpoint_shard_files(file_path)]
        try:
            def fields(base):
                return {name: load_sharded_array(files, f"{base}/{name}")
                        for name in cls._CHECKPOINT_ARRAY_FIELDS
                        if any(f"{base}/{name}" in f for f in files)}

            if spec is not None:
                state["samples"] = build(spec["class"],
                                         fields(f"{path}/arrays"),
                                         spec.get("parameters"),
                                         spec.get("beta"))
            if snap_specs is not None and state.get("history") is not None:
                for i, sp in enumerate(snap_specs):
                    state["history"].sample_history.append(build(
                        sp.get("class", "SMCSamples"),
                        fields(f"{path}/history/sample_history/{i}"),
                        state.get("parameters"), sp.get("beta")))
        finally:
            for f in files:
                f.close()
        return state

    def restore_from_checkpoint(self, source: str | bytes | dict
                                ) -> tuple[Samples, dict]:
        """The samples and state of a checkpoint given as a file path, the
        bytes of :meth:`serialize_checkpoint_state`, or the state dict; the
        generator and the evaluation count restored from it."""
        if isinstance(source, str):
            from ..io import checkpoint_barrier

            state = self.load_checkpoint_from_file(source)
            # Every process has read the files before any writes to them.
            checkpoint_barrier()
        elif isinstance(source, bytes):
            from ..io import load_pickle

            state = load_pickle(source)
        elif isinstance(source, dict):
            state = source
        else:
            raise TypeError(
                f"Cannot restore from object of type {type(source)}")
        restore_generator(self.generator, state)
        self.n_likelihood_evaluations = state.get(
            "n_likelihood_evaluations", self.n_likelihood_evaluations)
        return state["samples"], state


def _shard_of(samples) -> tuple:
    """``(starts, global rows)`` of a shard-local snapshot (its rows' offset
    and the whole population's size), ``()`` for a whole population: the
    trailing arguments :func:`~aspire_tpu_torch.io.save_sharded_array`
    takes."""
    starts = getattr(samples, "shard_starts", None)
    if starts is None:
        return ()
    return list(starts), int(samples.global_n)
