"""Adaptive-tempered Sequential Monte Carlo: the host ladder and the device
ladder.

Counterpart of ``aspire_tpu/samplers/smc.py``: ``SMCSampler`` and its
mutation kernels, ``PCNSMC`` (tpCN / pCN), ``EnsembleSMC`` (the stretch
move) and ``GradientSMC`` (RWMH, MALA, HMC, NUTS).
Two ladders walk the temperatures, as in the JAX package:

- the **host ladder** (``device_ladder=False``): per temperature one batch
  of device work bisects for the next beta and computes the ESS and
  evidence increment (fetched in one transfer), then the population is
  resampled and mutated;
- the **device ladder** (``_run_device_ladder``, the JAX package's
  ``while_loop`` ladder): one rung (bisection, statistics, resampling,
  mutation, lineage, history) is one function of a dict of device tensors
  (:meth:`SMCSampler._ladder_body`). On the card it is captured once in a
  CUDA graph (:class:`DeviceLadder`) and replayed once per temperature,
  each replay followed by one small read of the rung's flags; on the CPU
  the same body runs eagerly. ``sample`` selects it by the JAX package's
  rule.

Each mutation runs either the whole-chain CUDA kernel
(:func:`aspire_tpu_torch.ops.fused_mutation.fused_mh_chain`; its plain
torch version on a CPU tensor) or the per-step ("split") chain of
:mod:`.kernels`, chosen by :meth:`SMCSampler._fused_chain_spec` exactly as
the JAX package's ``_fused_chain_spec`` chooses between its TPU kernel and
its XLA chain. History records which ran. A gradient kernel's chain
differentiates the tempered density with autograd
(:func:`value_and_grad_batch`), through the flow kernels' backward.

Either ladder checkpoints every ``checkpoint_every`` temperatures (host
data only: :meth:`Sampler.build_checkpoint_state`), the device ladder
between replays (nothing is added to the captured rung), and a run resumes
from a checkpoint's file, bytes or dict on either ladder.

On a mesh (``mesh=``, :mod:`aspire_tpu_torch.parallel.mesh`) both ladders
run SPMD over the ranks: each holds a block of the population's rows, the
statistics and the resampling index are computed by every rank alike from
gathered vectors, ``resampling_impl`` moves the resampled rows, and every
mutation takes the split chain (as the JAX package's does on a mesh). The
device ladder's rung is captured where the mesh's backend can be captured
(NCCL on the card) and runs eagerly every rung where it cannot (gloo, which
stages CUDA tensors through the host): :attr:`DeviceLadder.mode`. Each rank
writes its own rows of a checkpoint, and of the sample history, to its own
file (:meth:`Sampler.save_checkpoint_to_hdf`); a run resumes from them on a
mesh of any size. The stretch move gathers the population once a
half-move, NUTS all-reduces its loops' flags.
"""

from __future__ import annotations

import copy
import gc
import logging
import math
import time
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..flows.architectures import Coupling
from ..flows.bijectors import standard_normal_sample
from ..flows.train import param_leaves
from ..history import SMCHistory
from ..models.targets import KernelSource
from ..ops import fused_coupling as FC
from ..ops import fused_mutation as FM
from ..ops._build import add_launches, launch_counts, load_user_library
from ..ops.resampling import get_resampler
from ..ops.special import effective_sample_size
from ..ops.resampling import alltoall_move, ring_move
from ..parallel import mesh as M
from ..parallel.mesh import all_gather_rows, all_reduce
from ..samples import Samples, SMCSamples, incremental_log_weights
from ..transforms import BaseTransform, get_transform_class
from ..utils import track_calls
from .base import Sampler
from . import kernels as K

logger = logging.getLogger("aspire_tpu_torch")

DEFAULT_BETA_TOLERANCE = 1e-8
#: walkers of the strided subset a windowed tau is estimated on when the
#: chain is not stored (``sampler_kwargs["tau_walkers"]``)
DEFAULT_TAU_WALKERS = 1024
#: the rung flags the device ladder reads back after each rung, in order
LADDER_FLAGS = ("it", "done", "stalled", "running", "nan_q", "nonfinite",
                "nan_target", "chol_info")
#: its history buffers, one entry per rung (``_replay_ladder_history``)
LADDER_HISTORY = ("beta_h", "ess_h", "ess1_h", "ratio_h", "var_h", "acc_h",
                  "tau_h", "lin_h")
_UNSET = object()


class BetaScheduleError(RuntimeError):
    """The adaptive beta ladder stalled."""


def checkpoint_due(iteration: int, every: int | None) -> bool:
    """The cadence of both ladders' checkpoints: every ``every``-th
    temperature (``every <= 0`` or None: none but the final one)."""
    return every is not None and every > 0 and iteration % every == 0


def _scalar(value, like: dict) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype and device; a tensor is
    used as it is (a number fills on the device, with no host copy)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, **like)


def bisect_beta(delta: torch.Tensor, beta_prev, target_eff,
                tol) -> torch.Tensor:
    """Largest beta whose incremental weights ``(beta - beta_prev) delta``
    keep ESS / n >= ``target_eff`` (fixed-trip bisection on the device)."""
    n = delta.shape[0]

    def ok(beta):
        return effective_sample_size((beta - beta_prev) * delta) / n >= target_eff

    return K.monotone_beta_bisect(ok, beta_prev, tol, delta.dtype,
                                  delta.device)


def iteration_stats(log_l, log_pi, log_q, beta_prev, beta_fixed, target_eff,
                    tol, min_beta_step, max_beta_step, *, adaptive: bool,
                    adaptive_min_step: bool):
    """Next beta, the step floor, the bisected beta, both ESS values and the
    evidence increment with its variance, as one ``(7,)`` tensor. The
    scalars are numbers (the host ladder) or 0-d device tensors (the device
    ladder); nothing reads back to the host."""
    delta = log_l + log_pi - log_q
    dt = dict(dtype=delta.dtype, device=delta.device)
    if adaptive:
        beta_star = bisect_beta(delta, beta_prev, target_eff, tol)
        floor = _scalar(min_beta_step, dt)
        if adaptive_min_step:
            min_step = torch.where(
                beta_star < 1.0,
                min_beta_step * (1 - beta_prev) / (1 - beta_star), floor)
        else:
            min_step = floor
        beta = torch.maximum(beta_star, beta_prev + min_step)
        beta = torch.clamp(torch.clamp(beta, max=beta_prev + max_beta_step),
                           max=1.0)
    else:
        beta_star = beta = _scalar(beta_fixed, dt)
        min_step = _scalar(min_beta_step, dt)
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


def _tensors_of(transform) -> list:
    """The tensors a transform holds, its sub-transforms' included, in the
    order they were set (none for None)."""
    out = []
    for v in vars(transform).values() if transform is not None else ():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, BaseTransform):
            out += _tensors_of(v)
    return out


def value_and_grad_batch(log_prob_fn: Callable, x: torch.Tensor):
    """Batched value and gradient of a summed log-density (the JAX
    package's ``_value_and_grad_batch``): ``torch.autograd.grad`` with
    autograd on, also inside the device ladder's ``no_grad`` body. A flow
    kernel's pass differentiates through its plain recompute."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        lp = log_prob_fn(xg)
        grad, = torch.autograd.grad(lp.sum(), xg)
    return lp.detach(), grad


class Mutation(NamedTuple):
    """One mutation's outputs, all on the device: the particles and their
    densities, the acceptance rate, the chain's autocorrelation time and
    mixing ratio, the adapted step size(s), ``cholesky_ex``'s info of the
    Gaussian reference, and the target evaluations it made (a number, or a
    0-d int64 tensor on the device for the split chain)."""

    x: torch.Tensor
    lq: torch.Tensor
    lpi: torch.Tensor
    ll: torch.Tensor
    acceptance: torch.Tensor
    tau: torch.Tensor
    mixing: torch.Tensor
    step: torch.Tensor
    info: torch.Tensor
    evals: int | torch.Tensor


def mutation_faults(m: Mutation) -> tuple:
    """``(nan_q, nonfinite, nan_target)`` counts of a mutation's outputs:
    NaN proposal densities, non-finite and NaN target densities."""
    return (torch.isnan(m.lq).sum(),
            (~torch.isfinite(m.lpi) | ~torch.isfinite(m.ll)).sum(),
            (torch.isnan(m.lpi) | torch.isnan(m.ll)).sum())


def raise_mutation_faults(nan_q, nan_target, info, where: str = "") -> None:
    """The port's rule for a mutation's faults (NaN is raised, not carried
    as the JAX package does): a covariance that did not factorise, NaN
    proposal densities, NaN target densities."""
    K.check_factorised(info, where)
    if nan_q:
        raise ValueError(f"{where}Log proposal contains {int(nan_q)} NaN "
                         "values")
    if nan_target:
        raise ValueError(
            f"{where}log_prior/log_likelihood returned NaN for mutated "
            "particles (return -inf for invalid points instead)")


class DeviceLadder:
    """One rung of the device ladder: its body (a function of the state
    dict, :meth:`SMCSampler._ladder_body`), its state, and on the card the
    rung captured in a CUDA graph.

    ``mode`` is ``"captured"`` on the card without a mesh or on a mesh whose
    backend a CUDA graph can capture (NCCL), and ``"eager"`` elsewhere: on
    the CPU, and on the card over gloo, whose collectives stage CUDA tensors
    through the host. It is chosen from the mesh's backend before the first
    rung, never by trying a capture.

    Captured, the first rung runs eagerly on a side stream (the capture's
    warm-up, which also fills the kernels' packed-weight caches and opens
    NCCL's communicator) and the next is captured; from then on every rung,
    in this call and in later calls that find the ladder in the cache, is
    one replay. The graph draws from ``generator``, registered with it,
    whose state the sampler loads before a run and takes back after it. A
    replay runs no Python, so it adds the launches and the collectives the
    capture counted to their counters (``captured``, ``collectives``).
    Eager, the body runs every rung.

    A graph that captured NCCL's all-to-all (``resampling_impl="ring"`` or
    ``"alltoall"``) keeps the communicator from shutting down: drop the
    cached ladders (``Aspire.ladder_cache.clear()``, then ``gc.collect()``)
    before ``torch.distributed.destroy_process_group()``, which otherwise
    waits forever.
    """

    def __init__(self, body: Callable, state: dict,
                 generator: torch.Generator, keep=(), mesh=None):
        self.body, self.state, self.generator = body, state, generator
        self.on_card = state["x"].is_cuda
        self.mesh = mesh
        self.mode = ("captured" if self.on_card and (
            mesh is None or mesh.backend == "nccl") else "eager")
        #: what the graph reads and nothing else holds: the flow's
        #: parameters, the run's chain spec and the packed weights
        self.keep = keep
        self.graph = None
        self.captured: tuple = ()
        self.collectives: dict = {}
        self.replays = 0
        self.capture_s = None
        self._pinned = (torch.empty(len(LADDER_FLAGS), dtype=torch.int64,
                                    pin_memory=True)
                        if self.on_card else None)

    def rung(self) -> None:
        """Run one rung: a replay, the warm-up on a side stream, or the
        body eagerly."""
        if self.graph is not None:
            self.graph.replay()
            add_launches(self.captured)
            M.add_collectives(self.collectives)
            self.replays += 1
        elif self.mode == "captured":
            device = self.state["x"].device
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.body(self.state)
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            self.body(self.state)

    def capture(self) -> None:
        """Capture the body in a CUDA graph (the launches and collectives
        it records are not counted: a capture runs nothing). Unreachable
        objects are collected first: a ladder a run replaced sits in a
        reference cycle (its body closes over its sampler), and the garbage
        collector, left to itself, may free its graph in the middle of this
        capture, which a capture does not allow (it fails). On a mesh the
        card is synchronised first and the capture is the thread's own
        (``capture_error_mode="thread_local"``): NCCL's watchdog thread
        queries CUDA events while the rung is captured."""
        t0 = time.perf_counter()
        gc.collect()
        before = launch_counts()
        collectives = dict(M.collective_counts)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        mode = "global"
        if self.mesh is not None:
            torch.cuda.synchronize()
            mode = "thread_local"
        with torch.cuda.graph(graph, capture_error_mode=mode):
            self.body(self.state)
        self.captured = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launches(tuple(-k for k in self.captured))
        self.collectives = M.captured_collectives(collectives)
        self.keep = (*self.keep, *FC.kept_packings())
        self.graph = graph
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        logger.info("Captured the device ladder's rung in a CUDA graph in "
                    "%.3f s (%d kernel-wrapper launches and %d collectives "
                    "per replay)", self.capture_s, sum(self.captured),
                    sum(self.collectives.values()))

    def read_flags(self) -> dict:
        """The rung's flags (``LADDER_FLAGS``): one small device-to-host
        read, into pinned memory on the card, waited on."""
        flags = self.state["flags"]
        if self.on_card:
            self._pinned.copy_(flags, non_blocking=True)
            torch.cuda.current_stream(flags.device).synchronize()
            flags = self._pinned
        return dict(zip(LADDER_FLAGS, flags.tolist()))


class SMCSampler(Sampler):
    """Adaptive-tempered SMC; subclasses provide the mutation kernel.

    ``ladder_cache`` holds the last device ladder captured, under its key,
    across runs (``Aspire`` passes its own, so a sampler built per call
    replays the graph an earlier call captured); by default the sampler's
    own. A run with another key replaces it.
    """

    default_sampler_kwargs: dict = {}

    def __init__(self, *args, resampling_method: str = "systematic",
                 resampling_impl: str = "auto",
                 ladder_cache: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.resampling_method = resampling_method
        #: how a mesh's resampling moves rows: "auto" (a gather), "ring"
        #: or "alltoall" (:meth:`SMCSamples.resample`)
        self.resampling_impl = resampling_impl
        self.ladder_cache = {} if ladder_cache is None else ladder_cache
        self.history = SMCHistory()
        self.sampler_kwargs: dict = {}
        self._adaptive_target_efficiency = False
        self._step_size_carry = None
        self._step_size_carry_fused = None
        self._lineage_fraction = 1.0
        self._last_chain_stats = None
        self._last_waste_free = False
        #: particle-steps of the mutations (a waste-free rung runs n / k
        #: chains of k steps), the JAX package's profiler counter
        self.particle_steps = 0
        self._kernel_target_value = _UNSET
        self.ladder = None

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

    def determine_beta(self, delta, beta: float, beta_step: float,
                       min_beta_step: float, max_beta_step: float = 1.0,
                       beta_tolerance: float = DEFAULT_BETA_TOLERANCE
                       ) -> tuple[float, float]:
        """The next beta and the step floor for the log-density increments
        ``delta`` (the JAX package's ``determine_beta``): the ladder's own
        :func:`iteration_stats` with ``delta`` as the whole increment, and
        its stall check."""
        delta = torch.as_tensor(delta)
        zeros = torch.zeros_like(delta)
        target_eff = float(self.current_target_efficiency(beta))
        beta_new, min_step, beta_star = iteration_stats(
            delta, zeros, zeros, beta, min(beta + beta_step, 1.0), target_eff,
            beta_tolerance, min_beta_step, max_beta_step,
            adaptive=self.adaptive,
            adaptive_min_step=self.adaptive_min_beta_step)[:3].tolist()
        _check_beta_progress(beta_new, beta_star, beta, target_eff,
                             beta_tolerance, min_step, self.adaptive)
        return beta_new, min_step

    # -- tempered target ---------------------------------------------------

    def tempered_log_prob(self, z: torch.Tensor, beta):
        """``(1-beta) log q + beta (logL + logPi) + log|J|`` in the
        preconditioned space, NaN -> -inf."""
        x, log_j = self.invert_preconditioning(z)
        log_q = self.prior_flow.log_prob(x)
        view = self._make_view(x)
        log_pi = torch.as_tensor(self.log_prior(view),
                                 device=x.device).reshape(-1)
        log_l = torch.as_tensor(self.log_likelihood(view),
                                device=x.device).reshape(-1)
        log_p = (1 - beta) * log_q + beta * (log_l + log_pi) + log_j
        return torch.where(torch.isnan(log_p),
                           torch.full_like(log_p, -math.inf), log_p).to(z.dtype)

    # -- mutation ----------------------------------------------------------

    def _kernel_step_builder(self, log_prob_fn, ref, generator, mesh=None):
        """Return ``(step_fn, init_step, needs_grad)``, the steps drawing
        and reducing over ``mesh`` (this rank's rows); overridden."""
        raise NotImplementedError

    def _fused_kernel_config(self, kwargs) -> dict | None:
        return None

    def _kernel_target(self):
        """The chain kernel's target, built once per run: ``(id,
        constants)`` when both user callables are bound to one problem
        object whose ``kernel_target`` gives an in-kernel id, ``(UserTarget,
        constants)`` when it gives a ``KernelSource`` (the callables its
        plain version), or when both bare callables carry the same
        ``kernel_target`` attribute (``models/targets.py``); else None."""
        if self._kernel_target_value is _UNSET:
            owner = getattr(self.log_likelihood, "__self__", None)
            fn = getattr(owner, "kernel_target", None)
            if (fn is None
                    or getattr(self.log_prior, "__self__", None) is not owner):
                fn = getattr(self.log_likelihood, "kernel_target", None)
                if getattr(self.log_prior, "kernel_target", None) is not fn:
                    fn = None
            value = fn(self.device) if fn is not None else None
            if value is not None and isinstance(value[0], KernelSource):
                value = (FM.UserTarget(value[0], self._user_target_plain),
                         value[1])
            self._kernel_target_value = value
        return self._kernel_target_value

    def _user_target_plain(self, x: torch.Tensor):
        """A user target's plain version for the chain: ``(log_prior,
        log_likelihood)`` of the user's callables on a view of ``x``."""
        view = self._make_view(x)
        return self.log_prior(view), self.log_likelihood(view)

    def _fused_chain_spec(self, kwargs, n: int, dtype,
                          waste_free: bool = False,
                          windowed_tau: bool = False) -> dict | None:
        """Dispatch predicate for the whole-chain kernel (None -> split).

        Mirrors the JAX package's ``_fused_chain_spec``: no waste-free
        pooling, windowed tau or flow moves (the kernel stores no chain and
        has no flow draw), no mesh, a coupling flow
        (a MAF always takes the split chain, on every device), float32, a
        data transform and a preconditioning transform (or none) that lower
        to programs (``FM.canonicalize_transform``: identity, affine,
        logit, probit, periodic and their masked composites), a target with
        an in-kernel id or a user's source, an integer ``nu + d`` for tpCN,
        whole tiles, and on a CUDA device a kernel compiled for the flow's
        shape. A user's source is built into its instance here, at first
        use (outside any CUDA graph capture); a failed build raises. The spec holds
        both programs, the preconditioning's from the transform as fitted
        when the spec is made (``mutate`` makes one per mutation, after the
        fit), and both lowered for the kernel (``blocks``), here, outside
        any CUDA graph capture.
        """
        if (kwargs.get("fused_chain", "auto") in (False, "off")
                or waste_free or windowed_tau or kwargs.get("flow_moves")
                or self.mesh is not None):
            return None
        arch = self.prior_flow.architecture
        if not isinstance(arch, Coupling):
            return None
        kcfg = self._fused_kernel_config(kwargs)
        if kcfg is None or dtype != torch.float32 or n % FM.TILE:
            return None
        if kcfg["kernel"] == "tpcn":
            k2 = kcfg["nu"] + self.dims
            if abs(k2 - round(k2)) > 1e-9:
                return None
            kcfg = dict(kcfg, gamma_m=int(round(k2)) // 2,
                        gamma_odd=int(round(k2)) % 2)
        else:
            kcfg = dict(kcfg, gamma_m=0, gamma_odd=0)
        kcfg["data_transform"] = FM.canonicalize_transform(
            self.prior_flow.data_transform, self.dims)
        kcfg["precond"] = FM.canonicalize_transform(
            self.preconditioning_transform, self.dims)
        if kcfg["data_transform"] is None or kcfg["precond"] is None:
            return None
        kcfg["target"] = self._kernel_target()
        if kcfg["target"] is None:
            return None
        cfg = FM.ChainConfig(
            arch, kcfg["kernel"], 1, nu=kcfg["nu"],
            gamma_m=kcfg["gamma_m"], gamma_odd=kcfg["gamma_odd"])
        if self.device.type == "cuda":
            if not FM.kernel_supports(cfg, kcfg["target"][0]):
                return None
            if isinstance(kcfg["target"][0], FM.UserTarget):
                load_user_library(kcfg["target"][0].source,
                                  FC.config_id(arch))
        kcfg["blocks"] = tuple(
            FM.program_block(kcfg[k], self.dims, self.device)
            for k in ("data_transform", "precond"))
        return kcfg

    def _mutate_fused(self, z, beta, n_steps, spec, step0,
                      generator) -> Mutation:
        """The whole-chain kernel at ``beta`` from per-tile step sizes
        ``step0`` (entries <= 0 take the initial step size), on ``z`` in the
        preconditioned space; returns the particles in data space (the
        preconditioning's inverse), as the JAX package does. Its seed is
        drawn on the device, so nothing here reads back to the host."""
        n, d = z.shape
        ref, info = K.gaussian_reference_info(z)
        seed = torch.randint(0, 2**32, (2,), generator=generator,
                             device=z.device)
        cfg = FM.ChainConfig(
            self.prior_flow.architecture, spec["kernel"], n_steps,
            nu=spec["nu"], target_acceptance=spec["target_acceptance"],
            adaptation_rate=spec["adaptation_rate"],
            gamma_m=spec["gamma_m"], gamma_odd=spec["gamma_odd"])
        step0 = torch.where(step0 > 0, step0, spec["init_step"])
        z, lq, lpi, ll, nacc, steps, stats = FM.fused_mh_chain(
            cfg, self.prior_flow.params, z, beta, seed, step0, ref.mean,
            ref.chol, ref.inv_chol, spec["target"],
            data_transform=spec["data_transform"], precond=spec["precond"],
            blocks=spec["blocks"])
        precond = self.preconditioning_transform
        x = precond.inverse(z)[0] if precond is not None else z
        tau, mixing = FM.combine_tile_stats(stats, d, FM.TILE)
        acceptance = torch.mean(nacc) / max(n_steps, 1)
        return Mutation(x, lq, lpi, ll, acceptance, tau, mixing, steps, info,
                        (n_steps + 1) * n)

    def _make_flow_imh_step(self, local_step: Callable, log_prob_fn,
                            beta, flow_moves: int, needs_grad: bool,
                            generator, mesh=None) -> Callable:
        """The local kernel mixed with the flow's independence move (the
        JAX package's ``_make_flow_imh_step``; :func:`K.mix_flow_moves`):
        the proposal is a fresh draw of the flow (its sampling pass, the
        coupling kernel on a CUDA batch), scored by :func:`K.flow_imh_move`.
        Runs without preconditioning, so the chain's space is the data
        space. On a mesh the latent normals and the uniforms are drawn for
        the whole population and the rank's rows kept."""
        flow = self.prior_flow

        def target_fn(x):
            view = self._make_view(x)
            return (torch.as_tensor(self.log_prior(view),
                                    device=x.device).reshape(-1)
                    + torch.as_tensor(self.log_likelihood(view),
                                      device=x.device).reshape(-1))

        vg = partial(value_and_grad_batch, log_prob_fn) if needs_grad else None

        def imh_step(state):
            n = state.x.shape[0]
            if mesh is None:
                x_prop, lq_prop = flow.sample_and_log_prob(
                    n, generator=generator)
            else:
                x_prop, lq_prop = flow.from_latent(mesh.local_rows(
                    standard_normal_sample(
                        (n * mesh.size, flow.dims), generator,
                        dtype=flow.dtype, device=flow.device)))
            u = K._uniform_rows(generator, n, state.x, mesh)
            return K.flow_imh_move(state, x_prop, lq_prop, u, beta, target_fn,
                                   flow.log_prob, vg)

        return K.mix_flow_moves(local_step, imh_step, generator, flow_moves)

    def _mutate_split(self, z, beta, n_steps, step0, generator,
                      waste_free: bool = False,
                      windowed_tau: bool = False, mesh=None) -> Mutation:
        """The per-step chain at ``beta`` from the step size ``step0``
        (<= 0 takes the initial step size), started from the densities and,
        for a gradient kernel, their gradients; then the densities
        refreshed. ``sampler_kwargs["flow_moves"]`` mixes in the flow's
        independence move; ``windowed_tau`` records the windowed Sokal tau
        (from ``tau_walkers`` walkers unless the chain is stored);
        ``waste_free`` runs ``z``'s M chains, stores them and pools every
        state, ancestor-major (``(k, M, d) -> (M, k, d) -> (M k, d)``, the
        JAX package's order), as the population whose densities are
        refreshed. On a mesh ``z`` is this rank's rows (its chains' pooled
        states are its block of the pooled population: ancestor-major, the
        ancestors in rank order) and the evaluation count is this rank's."""
        kwargs = self._mutation_kwargs()
        ref, info = K.gaussian_reference_info(z, mesh=mesh)

        def log_prob_fn(zz):
            return self.tempered_log_prob(zz, beta)

        step_fn, init_step, needs_grad = self._kernel_step_builder(
            log_prob_fn, ref, generator, mesh)
        if kwargs.get("flow_moves"):
            step_fn = self._make_flow_imh_step(
                step_fn, log_prob_fn, beta, int(kwargs["flow_moves"]),
                needs_grad, generator, mesh)
        if needs_grad:
            lp, grad = value_and_grad_batch(log_prob_fn, z)
        else:
            lp, grad = log_prob_fn(z), None
        state = K.ChainState(
            x=z, log_prob=lp,
            step_size=torch.where(step0 > 0, step0, float(init_step)),
            n_accept=torch.zeros_like(z[:, 0]), grad=grad)
        final, stats, *chain = K.run_chain(
            step_fn, state, n_steps, store_chain=waste_free,
            windowed_tau=windowed_tau,
            tau_walkers=int(kwargs.get("tau_walkers")
                            or DEFAULT_TAU_WALKERS), mesh=mesh)
        z_out = K.pool_chain(chain[0]) if waste_free else final.x
        x, _ = self.invert_preconditioning(z_out)
        log_q = self.prior_flow.log_prob(x)
        log_pi = self.evaluate_log_prior(x)
        view = self._make_view(x)
        log_l = torch.as_tensor(self.log_likelihood(view),
                                device=x.device).reshape(-1)
        acceptance = torch.mean(K._gathered(final.n_accept, mesh)
                                / max(n_steps, 1))
        return Mutation(x, log_q, log_pi, log_l, acceptance, stats.tau,
                        stats.mixing, final.step_size, info,
                        final.n_evals + z.shape[0] + x.shape[0])

    def _chain_options(self, kwargs: dict, waste_free=None,
                       windowed_tau=None) -> tuple[bool, bool]:
        """``(waste_free, windowed_tau)`` of a mutation: the arguments where
        given, else ``sampler_kwargs``; waste-free pooling stores the chain,
        so it records the windowed tau, as in the JAX package."""
        if waste_free is None:
            waste_free = bool(kwargs.get("waste_free", False))
        if windowed_tau is None:
            windowed_tau = bool(kwargs.get("windowed_tau", False)) or waste_free
        return waste_free, windowed_tau

    def _mutation_kwargs(self) -> dict:
        kwargs = dict(self.default_sampler_kwargs)
        kwargs.update(self.sampler_kwargs or {})
        return kwargs

    @torch.no_grad()
    def mutate(self, samples: SMCSamples, beta: float,
               n_steps: int | None = None, waste_free: bool | None = None,
               windowed_tau: bool | None = None, mesh=None) -> SMCSamples:
        """Fit the preconditioning, run the chain at ``beta``, and return
        the mutated particles with refreshed densities. Autograd is off
        (as in the device ladder's body): no density holds a graph over a
        chain, a CNF's 64 ODE steps included; a gradient kernel turns it
        on for its own evaluations (:func:`value_and_grad_batch`) and a
        flow preconditioning's fit for its training.

        ``waste_free`` and ``windowed_tau`` default to ``sampler_kwargs``'
        (:meth:`_chain_options`). As in the JAX package, waste-free pooling
        needs a target a CUDA graph can capture, a windowed tau on any
        other target falls back to the AR(1) surrogate with a warning, and
        ``flow_moves`` needs such a target and no preconditioning.

        ``mesh``: ``samples`` holds this rank's rows of a population
        sharded over it; the preconditioning is fitted to the gathered
        population, the chain draws and reduces over the mesh, and the
        recorded statistics and counts are the whole population's."""
        kwargs = self._mutation_kwargs()
        n_steps = int(n_steps or kwargs.get("n_steps") or 5 * self.dims)
        waste_free, windowed_tau = self._chain_options(kwargs, waste_free,
                                                       windowed_tau)
        if kwargs.get("flow_moves"):
            if self.preconditioning_transform is not None:
                raise ValueError(
                    "flow_moves independence steps propose in the flow's own "
                    "space; run with preconditioning=None.")
            if not self.target_is_capturable():
                raise ValueError("flow_moves requires a target a CUDA graph "
                                 "can capture (see target_is_capturable).")
        if waste_free and not self.target_is_capturable():
            raise ValueError("waste_free mutation requires a target a CUDA "
                             "graph can capture (see target_is_capturable).")
        if windowed_tau and not self.target_is_capturable():
            logger.warning(
                "windowed_tau requires a target a CUDA graph can capture to "
                "store the mutation chains; recording the AR(1) surrogate "
                "tau instead.")
            windowed_tau = False
        if mesh is None or self.preconditioning_transform is None:
            z = self.fit_preconditioning_transform(samples.x)
        else:
            z = mesh.local_rows(self.fit_preconditioning_transform(
                all_gather_rows(samples.x, mesh)))
        spec = self._fused_chain_spec(kwargs, z.shape[0], z.dtype, waste_free,
                                      windowed_tau)
        unset = dict(dtype=z.dtype, device=z.device)
        if spec is not None:
            carry, nt = self._step_size_carry_fused, z.shape[0] // FM.TILE
            step0 = (carry if carry is not None and carry.shape == (nt,)
                     else torch.full((nt,), -1.0, **unset))
            m = self._mutate_fused(z.contiguous(), beta, n_steps, spec, step0,
                                   self.generator)
            self._step_size_carry_fused = m.step
            route = "fused_kernel"
        else:
            carry = self._step_size_carry
            step0 = carry if carry is not None else torch.full((), -1.0,
                                                               **unset)
            m = self._mutate_split(z, beta, n_steps, step0, self.generator,
                                   waste_free, windowed_tau, mesh)
            self._step_size_carry = m.step
            route = "split"
        faults = mutation_faults(m)
        evals = m.evals
        if mesh is not None:
            *faults, evals = all_reduce(torch.stack([
                torch.as_tensor(v, device=z.device).to(torch.int64)
                for v in (*faults, evals)]), mesh).unbind()
        (acceptance, tau, mixing, nan_q, nonfinite, nan_target,
         info) = torch.stack([
             v.double() for v in (m.acceptance, m.tau, m.mixing,
                                  *faults, m.info)]).tolist()
        self.n_likelihood_evaluations += int(evals)
        self.history.mcmc_acceptance.append(acceptance)
        self.history.mcmc_autocorr.append(tau)
        self.history.mutation_route.append(route)
        self.history.nonfinite_target.append(int(nonfinite))
        self._last_chain_stats = (tau, mixing)
        self._last_waste_free = waste_free
        raise_mutation_faults(nan_q, nan_target, info)
        new = SMCSamples(x=m.x, beta=beta, dtype=self.dtype,
                         parameters=self.parameters, device=self.device)
        new.log_q = m.lq
        new.log_prior = m.lpi
        new.log_likelihood = m.ll
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
        if self._last_waste_free:
            # The pooled chain states hold at most ~k / tau effectively
            # independent draws per ancestor.
            self._lineage_fraction /= max(min(tau, k), 1.0)

    # -- a mesh ----------------------------------------------------------------

    @staticmethod
    def _on_mesh(mesh) -> dict:
        """``mutate``'s keyword for a population sharded over ``mesh``
        (none for one held whole, so ``mutate`` is called as ever)."""
        return {} if mesh is None else {"mesh": mesh}

    def _whole_densities(self, samples: SMCSamples, mesh) -> tuple:
        """``(log_likelihood, log_prior, log_q)`` of the whole population:
        this rank's gathered over ``mesh`` (one gather), or as they are."""
        return self._gathered_densities(
            (samples.log_likelihood, samples.log_prior, samples.log_q), mesh)

    @staticmethod
    def _gathered_densities(fields: tuple, mesh) -> tuple:
        """The density vectors ``fields`` of the whole population: this
        rank's gathered over ``mesh`` (one gather for vectors of one
        dtype), or as they are."""
        if mesh is None:
            return fields
        if len({f.dtype for f in fields}) > 1:
            return tuple(all_gather_rows(f, mesh) for f in fields)
        return tuple(v.contiguous() for v in all_gather_rows(
            torch.stack(fields, dim=1), mesh).unbind(1))

    def _whole_population(self, samples: SMCSamples, mesh) -> SMCSamples:
        """The whole population from every rank's rows (the run's result on
        every rank)."""
        if mesh is None:
            return samples
        return SMCSamples(
            **{name: all_gather_rows(getattr(samples, name), mesh)
               for name in ("x", "log_likelihood", "log_prior", "log_q")},
            beta=samples.beta, dtype=self.dtype,
            parameters=self.parameters, device=self.device)

    # -- the device ladder ---------------------------------------------------

    def _ladder_refusal(self) -> str | None:
        """Why this run cannot take the device ladder, or None: the JAX
        package's three conditions, and a chain that reads back from the
        device (tpCN's Gamma variate by rejection, for a non-integer
        ``nu + d`` on the split chain)."""
        if not self.adaptive:
            return "device_ladder requires adaptive=True"
        if self.preconditioning_transform is not None:
            return ("device_ladder does not support preconditioning "
                    "transforms; use preconditioning=None")
        if not self.target_is_capturable():
            return ("device_ladder requires a log_likelihood/log_prior that "
                    "a CUDA graph can capture (see target_is_capturable)")
        kwargs = self._mutation_kwargs()
        if kwargs.get("step_fn", "tpcn") == "tpcn" and "nu" in kwargs:
            k2 = float(kwargs["nu"]) + self.dims
            if abs(k2 - round(k2)) > 1e-9:
                return ("device_ladder cannot capture tpCN's Gamma variate "
                        f"for a non-integer nu + d ({k2}): it is drawn by "
                        "rejection, which reads back from the device")
        return None

    def _ladder_body(self, spec: dict | None, n_steps: int,
                     generator: torch.Generator, mesh=None) -> Callable:
        """One rung of the device ladder as a function of its state dict,
        the JAX package's ``while_loop`` body (``smc.py:1754-2024``) in
        its order: the target efficiency at the previous beta, the
        statistics and the bisection, the stall flag, the incremental
        weights, resampling, the mutation (``spec``: the whole-chain
        kernel, None: the split chain), the lineage recursion, the history
        buffers at index ``it`` and the flags. The new state is copied into
        the state's own tensors, so a CUDA graph of the body reads and
        writes the same memory on every replay; nothing reads back.
        Waste-free SMC resamples n / k ancestors and pools their chains
        back to the n rows of the state, so the graph keeps its shapes.

        On ``mesh`` the state holds this rank's rows: the statistics and
        the incremental weights are computed on the gathered densities
        (one gather), every rank draws the same global index, the
        sampler's ``resampling_impl`` moves the rows (the all-to-all's
        overflow decided on the device), the split chain draws and reduces
        over the mesh, and the faults and evaluations are all-reduced as
        integers: every rank writes the same history and flags."""
        resampler = get_resampler(self.resampling_method)
        impl = self.resampling_impl
        ranks = mesh.size if mesh is not None else 1
        adaptive_min_step = self.adaptive_min_beta_step
        waste_free, windowed_tau = self._chain_options(
            self._mutation_kwargs())

        def body(s: dict) -> None:
            with torch.no_grad():
                n = s["x"].shape[0] * ranks
                beta_prev = s["beta"]
                target_eff = (s["eff_lo"] + (s["eff_hi"] - s["eff_lo"])
                              * beta_prev.double() ** s["eff_rate"]
                              ).to(beta_prev.dtype)
                ll, lpi, lq = self._gathered_densities(
                    (s["ll"], s["lpi"], s["lq"]), mesh)
                (beta, min_step, _, ess, ess1, ratio,
                 var) = iteration_stats(
                    ll, lpi, lq, beta_prev, 1.0, target_eff,
                    s["tol"], s["min_step"], s["max_step"], adaptive=True,
                    adaptive_min_step=adaptive_min_step).unbind()
                stalled = beta <= beta_prev
                log_w = incremental_log_weights(lq, ll, lpi, beta_prev, beta)
                n_chains = n // n_steps if waste_free else n
                idx = resampler(generator, log_w, n_chains)
                if mesh is None:
                    x_r = s["x"][idx]
                elif impl == "ring":
                    x_r = ring_move(idx, s["x"], mesh)
                elif impl == "alltoall":
                    x_r = alltoall_move(idx, s["x"], mesh, on_device=True)[0]
                else:
                    x_r = mesh.local_rows(all_gather_rows(s["x"], mesh)[idx])
                f_lin = torch.clamp(
                    s["f_lin"] * torch.clamp(ess.double(), min=1.0) / n,
                    min=1.0 / n, max=1.0)
                if spec is not None:
                    m = self._mutate_fused(x_r, beta, n_steps, spec,
                                           s["step"], generator)
                else:
                    m = self._mutate_split(x_r, beta, n_steps, s["step"],
                                           generator, waste_free,
                                           windowed_tau, mesh)
                faults, evals = mutation_faults(m), m.evals
                if mesh is not None:
                    *faults, evals = all_reduce(torch.stack([
                        torch.as_tensor(v, device=s["x"].device).to(
                            torch.int64) for v in (*faults, evals)]),
                        mesh).unbind()
                tau, mixing = m.tau.double(), m.mixing.double()
                rho = torch.clamp((tau - 1.0) / (tau + 1.0), min=0.0)
                f_lin = f_lin + (1.0 - f_lin) * (
                    (1.0 - rho ** (2 * n_steps)) * mixing)
                if waste_free:
                    f_lin = f_lin / torch.clamp(
                        torch.clamp(tau, max=float(n_steps)), min=1.0)
                i = s["it"]
                for name, v in zip(LADDER_HISTORY, (
                        beta, ess, ess1, ratio, var.double() / s["f_lin"],
                        m.acceptance, tau, s["f_lin"])):
                    s[name].index_copy_(0, i, v.double().reshape(1))
                if isinstance(evals, torch.Tensor):
                    s["ev_h"].index_copy_(0, i, evals.reshape(1))
                else:
                    s["ev_h"].index_fill_(0, i, evals)
                done = beta >= 1.0
                it = i + 1
                running = ~done & ~stalled & (it < s["iter_cap"])
                s["flags"].copy_(torch.stack([
                    v.reshape(()).to(torch.int64) for v in (
                        it, done, stalled, running, *faults, m.info)]))
                for name, v in (("x", m.x), ("lq", m.lq), ("lpi", m.lpi),
                                ("ll", m.ll), ("beta", beta),
                                ("min_step", min_step), ("step", m.step),
                                ("it", it), ("done", done),
                                ("stalled", stalled), ("f_lin", f_lin)):
                    s[name].copy_(v)

        return body

    def _ladder_state(self, samples: SMCSamples, spec, max_iters: int
                      ) -> dict:
        """The device ladder's state tensors (contents set by
        :meth:`_load_ladder`)."""
        x = samples.x
        n, dt = x.shape[0], dict(dtype=x.dtype, device=x.device)
        f64 = dict(dtype=torch.float64, device=x.device)
        step_shape = (n // FM.TILE,) if spec is not None else ()
        return {
            "x": torch.empty_like(x), "ll": torch.empty(n, **dt),
            "lpi": torch.empty(n, **dt), "lq": torch.empty(n, **dt),
            "beta": torch.empty((), **dt), "min_step": torch.empty((), **dt),
            "step": torch.empty(step_shape, **dt),
            "it": torch.empty(1, dtype=torch.int64, device=x.device),
            "done": torch.empty((), dtype=torch.bool, device=x.device),
            "stalled": torch.empty((), dtype=torch.bool, device=x.device),
            "f_lin": torch.empty((), **f64),
            **{name: torch.empty(max_iters, **f64)
               for name in LADDER_HISTORY},
            "ev_h": torch.empty(max_iters, dtype=torch.int64,
                                device=x.device),
            "flags": torch.empty(len(LADDER_FLAGS), dtype=torch.int64,
                                 device=x.device),
            "max_step": torch.empty((), **dt), "tol": torch.empty((), **dt),
            "eff_lo": torch.empty((), **f64), "eff_hi": torch.empty((), **f64),
            "eff_rate": torch.empty((), **f64),
            "iter_cap": torch.empty(1, dtype=torch.int64, device=x.device),
        }

    def _load_ladder(self, state: dict, samples: SMCSamples, *,
                     min_beta_step, max_beta_step, beta_tolerance,
                     max_iters) -> None:
        """Write this run's population and scalars into the ladder's state:
        the values that change from call to call are never part of a
        graph."""
        if self._adaptive_target_efficiency:
            eff_lo, eff_hi = self._target_efficiency
        else:
            eff_lo = eff_hi = float(self._target_efficiency)
        for name, value in (("x", samples.x), ("ll", samples.log_likelihood),
                            ("lpi", samples.log_prior), ("lq", samples.log_q)):
            state[name].copy_(value)
        for name, value in (
                ("beta", samples.beta or 0.0), ("min_step", min_beta_step),
                ("step", -1.0), ("it", 0), ("done", False),
                ("stalled", False), ("f_lin", self._lineage_fraction),
                ("ev_h", 0), ("flags", 0), ("max_step", max_beta_step),
                ("tol", beta_tolerance), ("eff_lo", eff_lo),
                ("eff_hi", eff_hi),
                ("eff_rate", float(self.target_efficiency_rate)),
                ("iter_cap", max_iters),
                *((name, 0.0) for name in LADDER_HISTORY)):
            state[name].fill_(value)

    def _ladder_key(self, spec, n_steps: int, max_iters: int, samples,
                    mesh=None):
        """What a captured rung depends on besides the state it reads: the
        JAX package's cache key (``smc.py:1623-1630``) and the population's
        size and dtype, the resampler, the target and the flow, and the
        mesh its collectives run on (its size, this rank, its backend and
        device) with the resampling's movement."""
        return ("ladder", type(self), n_steps, max_iters,
                self.adaptive_min_beta_step,
                "fused_kernel" if spec is not None else "split",
                repr(sorted(self.sampler_kwargs.items())),
                self.resampling_method, tuple(samples.x.shape),
                samples.x.dtype, str(samples.x.device), self.log_likelihood,
                self.log_prior, id(self.prior_flow),
                None if mesh is None else (
                    mesh.size, mesh.rank, mesh.backend, str(mesh.device),
                    id(mesh.group)),
                self.resampling_impl)

    def _device_ladder(self, samples, spec, n_steps: int,
                       max_iters: int, mesh=None) -> DeviceLadder:
        """This run's ladder: on the card the cached one while its key, the
        flow's parameters and its data transform's tensors (the same
        tensors at the same versions, on either route: the graph reads
        them) hold, else a new one, which takes the cached one's place; on
        the CPU a new one on the sampler's generator. ``mesh``: the rows
        are this rank's of a population sharded over it."""
        if not samples.x.is_cuda:
            return DeviceLadder(
                self._ladder_body(spec, n_steps, self.generator, mesh),
                self._ladder_state(samples, spec, max_iters), self.generator,
                mesh=mesh)
        leaves = [*param_leaves(self.prior_flow.params),
                  *_tensors_of(self.prior_flow.data_transform)]
        params = tuple((t, t._version) for t in leaves)
        key = self._ladder_key(spec, n_steps, max_iters, samples, mesh)
        kept, ladder = self.ladder_cache.get(key, ((), None))
        if ladder is not None and len(kept) == len(params) and all(
                a is b and v == w for (a, v), (b, w) in zip(kept, params)):
            return ladder
        # One ladder at a time: the one it replaces (its graph, the graph's
        # memory pool and its state) is dropped here and collected before
        # the new one's capture (DeviceLadder.capture).
        self.ladder_cache.clear()
        generator = torch.Generator(device=samples.x.device)
        ladder = DeviceLadder(
            self._ladder_body(spec, n_steps, generator, mesh),
            self._ladder_state(samples, spec, max_iters), generator,
            keep=(self.prior_flow, spec), mesh=mesh)
        self.ladder_cache[key] = (params, ladder)
        return ladder

    def _replay_ladder_history(self, history: SMCHistory, it: int,
                               buffers: dict) -> None:
        """Append ``it`` rungs of the device ladder's history buffers to
        ``history`` (the JAX package's ``_replay_ladder_history``)."""
        for i in range(it):
            beta = buffers["beta_h"][i]
            history.beta.append(beta)
            history.eff_target.append(
                float(self.current_target_efficiency(beta)))
            history.ess.append(buffers["ess_h"][i])
            history.ess_target.append(buffers["ess1_h"][i])
            history.log_norm_ratio.append(buffers["ratio_h"][i])
            history.log_norm_ratio_var.append(buffers["var_h"][i])
            history.mcmc_acceptance.append(buffers["acc_h"][i])
            history.mcmc_autocorr.append(buffers["tau_h"][i])
            history.lineage_fraction.append(buffers["lin_h"][i])

    def _run_device_ladder(self, samples: SMCSamples, *, min_beta_step,
                           max_beta_step, beta_tolerance, max_iters: int,
                           store_history: bool = False,
                           checkpoint_callback: Callable | None = None,
                           checkpoint_every: int | None = None, mesh=None
                           ) -> tuple[SMCSamples, int]:
        """Run the adaptive ladder rung by rung on the device: a replay of
        the captured rung per temperature on the card, the body eagerly on
        the CPU (and over gloo), each followed by one read of the rung's
        flags; at most ``max_iters`` rungs. The history buffers are fetched
        once, at the end (or at a fault, which raises after the rungs that
        ran are in the history), and at a rung whose checkpoint is due
        (:meth:`_ladder_checkpoint`: the run's iterations so far counted
        from the history it started with, as the host ladder counts).

        On ``mesh`` the rows are this rank's and every rank runs the same
        rungs. The ladder comes back to the host after every rung, so a
        checkpoint is written between two rungs, shard-local (each rank's
        rows to its own file), and the sample history is each rank's rows:
        the port needs no counterpart of the JAX package's
        ``_run_device_ladder_chunked``, which runs its compiled ladder in
        chunks to reach the host at all on a mesh of many processes."""
        reason = self._ladder_refusal()
        if reason is not None:
            raise ValueError(reason)
        kwargs = self._mutation_kwargs()
        n_steps = int(kwargs.get("n_steps") or 5 * self.dims)
        n = len(samples)
        spec = self._fused_chain_spec(kwargs, n, samples.x.dtype,
                                      *self._chain_options(kwargs))
        route = "fused_kernel" if spec is not None else "split"
        ladder = self._device_ladder(samples, spec, n_steps, max_iters, mesh)
        self.ladder = ladder
        logger.info("Device ladder mode: %s (%s)", ladder.mode,
                    "a mesh over " + mesh.backend if mesh is not None
                    else "one process")
        self._load_ladder(ladder.state, samples, min_beta_step=min_beta_step,
                          max_beta_step=max_beta_step,
                          beta_tolerance=beta_tolerance, max_iters=max_iters)
        if ladder.on_card:
            ladder.generator.set_state(self.generator.get_state())
        state = ladder.state
        base_iteration = len(self.history.beta)
        base_evals = self.n_likelihood_evaluations
        while True:
            ladder.rung()
            flags = ladder.read_flags()
            it = flags["it"]
            self.history.mutation_route.append(route)
            self.history.nonfinite_target.append(flags["nonfinite"])
            if store_history:
                self.history.sample_history.append(self._history_snapshot(
                    self._ladder_samples(state, float(state["beta"]),
                                         clone=False), mesh))
            if flags["nan_q"] or flags["nan_target"] or flags["chol_info"]:
                self._finish_ladder(ladder, it, mesh)
                raise_mutation_faults(flags["nan_q"], flags["nan_target"],
                                      flags["chol_info"],
                                      where=f"device ladder rung {it}: ")
            if checkpoint_callback is not None and checkpoint_due(
                    base_iteration + it, checkpoint_every):
                checkpoint_callback(self._ladder_checkpoint(
                    ladder, it, base_iteration, base_evals, mesh))
            if not flags["running"]:
                break
            if ladder.mode == "captured" and ladder.graph is None:
                ladder.capture()
        beta = self._finish_ladder(ladder, it, mesh)
        n_all = n * (mesh.size if mesh is not None else 1)
        self.particle_steps += it * n_steps * (
            n_all // n_steps if self._chain_options(kwargs)[0] else n_all)
        if flags["stalled"]:
            raise BetaScheduleError(
                "Device ladder stalled: beta did not increase. Consider "
                f"adjusting beta_tolerance ({beta_tolerance}), "
                f"min_beta_step ({min_beta_step}) or the target "
                "efficiency.")
        return self._ladder_samples(state, beta, clone=True), it

    def _ladder_checkpoint(self, ladder: DeviceLadder, it: int,
                           base_iteration: int, base_evals: int,
                           mesh=None) -> dict:
        """The checkpoint at rung ``it`` of a device-ladder run (the JAX
        package's ``_ladder_checkpoint_host``): the population cloned to the
        host, the history the run started with (and the rungs' routes and
        snapshots, appended as they ran) plus the first ``it`` rows of the
        history buffers, the lineage fraction, the evaluations so far and
        the state of the ladder's own generator, which the rungs draw
        from; on ``mesh`` this rank's rows of the population."""
        buffers, f_lin, evals = self._ladder_rows(ladder.state, it)
        history = copy.deepcopy(self.history)
        self._replay_ladder_history(history, it, buffers)
        beta = buffers["beta_h"][-1]
        return self.build_checkpoint_state(
            self._ladder_samples(ladder.state, beta, clone=False),
            base_iteration + it, meta={"beta": beta},
            generator=ladder.generator, evaluations=base_evals + evals,
            mesh=mesh, history=history, lineage_fraction=f_lin)

    @staticmethod
    def _ladder_rows(state: dict, it: int) -> tuple[dict, float, int]:
        """The first ``it`` rows of the history buffers, the lineage
        fraction and the rungs' evaluations, in one transfer."""
        rows = torch.cat([
            torch.stack([state[name][:it] for name in LADDER_HISTORY]
                        ).reshape(-1),
            torch.stack([state["f_lin"], state["ev_h"][:it].sum().double()]),
        ]).tolist()
        buffers = {name: rows[k * it:(k + 1) * it]
                   for k, name in enumerate(LADDER_HISTORY)}
        return buffers, rows[-2], int(rows[-1])

    def _finish_ladder(self, ladder: DeviceLadder, it: int,
                       mesh=None) -> float:
        """Fetch the ``it`` rungs' history buffers, the lineage fraction and
        the evaluation count in one transfer, replay them into the history
        and the sampler, keep the step-size carry, and give the
        generator's state back to the sampler. Returns the last beta."""
        state = ladder.state
        if ladder.on_card:
            self.generator.set_state(ladder.generator.get_state())
        buffers, self._lineage_fraction, evals = self._ladder_rows(state, it)
        self._replay_ladder_history(self.history, it, buffers)
        n = state["x"].shape[0] * (mesh.size if mesh is not None else 1)
        for i in range(it):
            logger.info("it %d - beta %.6g, ESS %.1f (%.2f eff), log ratio "
                        "%.3f", i + 1, buffers["beta_h"][i],
                        buffers["ess_h"][i], buffers["ess_h"][i] / n,
                        buffers["ratio_h"][i])
        self.n_likelihood_evaluations += evals
        step = state["step"].clone()
        if step.dim():
            self._step_size_carry_fused = step
        else:
            self._step_size_carry = step
        return buffers["beta_h"][-1]

    def _ladder_samples(self, state: dict, beta: float,
                        clone: bool) -> SMCSamples:
        """The ladder's population as samples at ``beta``; cloned out of
        the state, which a later run of a cached ladder overwrites."""
        take = (lambda t: t.clone()) if clone else (lambda t: t)
        new = SMCSamples(x=take(state["x"]), beta=beta,
                         dtype=self.dtype, parameters=self.parameters,
                         device=self.device)
        new.log_q = take(state["lq"])
        new.log_prior = take(state["lpi"])
        new.log_likelihood = take(state["ll"])
        return new

    # -- main loop ---------------------------------------------------------

    @track_calls
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
        checkpoint_callback: Callable[[dict], None] | None = None,
        checkpoint_every: int | None = None,
        checkpoint_file_path: str | None = None,
        resume_from: str | bytes | dict | None = None,
        store_sample_history: bool | None = None,
        beta_tolerance: float = DEFAULT_BETA_TOLERANCE,
        device_ladder: bool | None = None,
        device_ladder_max_iters: int = 256,
        n_replicates: int | None = None,
    ) -> Samples:
        """Run adaptive-tempered SMC; returns posterior samples with the
        log evidence and its error. ``n_steps`` fixes the beta ladder
        (``1 / n_steps`` increments); the mutation length is
        ``sampler_kwargs["n_steps"]``.

        ``device_ladder=True`` runs the temperatures on the device ladder
        (one CUDA graph replay per temperature on the card), ``False`` on
        the host ladder; None selects the device ladder when the schedule
        is adaptive, there is no preconditioning and no sample history,
        and the target can be captured, as the JAX package does.
        ``device_ladder_max_iters`` sizes its history buffers: a run that
        needs more rungs continues on the host ladder (``max_n_steps``, a
        cumulative cap, takes its place when set).

        ``checkpoint_callback`` receives a checkpoint state (host data) every
        ``checkpoint_every`` temperatures (every one by default) and once at
        the end; ``checkpoint_every`` alone writes them to
        ``checkpoint_file_path`` (HDF5, the JAX package's layout).
        ``resume_from`` (a file path, the bytes of
        :meth:`serialize_checkpoint_state` or a state dict) continues a run
        from its checkpoint on either ladder: its population, beta,
        history, lineage fraction, generator, evaluations and mutation
        options; the step sizes re-adapt from their defaults, as in the JAX
        package, so a resumed run is not the uninterrupted one. A
        checkpoint at beta 1 skips the loop. ``max_n_steps`` counts the
        iterations the checkpoint had.

        ``n_replicates`` > 1 runs that many independent runs, each going on
        with the sampler's generator, and gives the last run's samples the
        replicates' log Z (:func:`~aspire_tpu_torch.samplers.base.
        combine_replicates`).

        With a mesh (the sampler's ``mesh``) the population is drawn whole
        on every rank and sharded over the ranks (where ``n_samples``
        divides by their number), either ladder runs SPMD (the device
        ladder's mode, captured or eager, by the mesh's backend:
        :class:`DeviceLadder`), ``resampling_impl`` moves the resampled
        rows, and every rank returns the whole population with the same
        log Z. Each rank writes its own rows of a checkpoint and of the
        sample history (which defaults to False on a mesh of more than one
        rank); ``resume_from`` reads the whole arrays (a checkpoint's
        files, from a mesh of any size) and each rank keeps its rows.
        ``checkpoint_every=0`` writes no checkpoint but the final one on
        either ladder (the JAX package's chunked ladder on a mesh of many
        processes reads 0 as every rung)."""
        if n_replicates is not None and n_replicates > 1:
            if (resume_from is not None or checkpoint_callback is not None
                    or checkpoint_file_path is not None):
                raise ValueError(
                    "n_replicates runs independent replicates; combine it "
                    "with checkpointing/resume per replicate manually "
                    "instead.")
            return self._sample_replicated(n_replicates, n_samples, dict(
                n_steps=n_steps, adaptive=adaptive,
                min_beta_step=min_beta_step, max_beta_step=max_beta_step,
                max_n_steps=max_n_steps, target_efficiency=target_efficiency,
                target_efficiency_rate=target_efficiency_rate,
                n_final_samples=n_final_samples,
                sampler_kwargs=sampler_kwargs,
                store_sample_history=store_sample_history,
                beta_tolerance=beta_tolerance, device_ladder=device_ladder,
                device_ladder_max_iters=device_ladder_max_iters))
        self.sampler_kwargs = dict(self.default_sampler_kwargs)
        self.sampler_kwargs.update(sampler_kwargs or {})
        if self.resampling_impl != "auto" and self.mesh is None:
            raise ValueError(
                f"resampling_impl={self.resampling_impl!r} needs a "
                "mesh-sharded population (pass mesh=... to the "
                "sampler); use 'auto' for single-device runs.")
        self.check_replicated_flow()
        if store_sample_history is None:
            # One host copy of the population per temperature: by default
            # only at plot sizes, as in the JAX package, and never on a
            # mesh of more than one rank.
            store_sample_history = (n_samples <= 10_000
                                    and not self.multiprocess())
        n_final_steps = self.sampler_kwargs.pop("n_final_steps", None)
        self._step_size_carry = None
        self._step_size_carry_fused = None
        self._lineage_fraction = 1.0
        self._last_waste_free = False
        self._kernel_target_value = _UNSET
        self.ladder = None

        resumed = resume_from is not None
        if resumed:
            logger.info("Resuming SMC sampling from checkpoint: %s",
                        resume_from if isinstance(resume_from, str)
                        else "checkpoint data")
            samples, beta, iterations = self.restore_smc_checkpoint(
                resume_from)
            logger.info("Resumed SMC sampling at iteration %d with "
                        "beta=%.4f", iterations, beta)
        else:
            init = self.draw_initial_samples(n_samples)
            samples = SMCSamples.from_samples(init, beta=0.0,
                                              dtype=self.dtype)
            beta = 0.0
            iterations = 0
            self.history = SMCHistory()
        for name in ("log_q", "log_prior", "log_likelihood"):
            if bool(torch.isnan(getattr(samples, name)).any()):
                raise ValueError(
                    f"{name.replace('_', ' ').capitalize()} contains NaN "
                    "values")
        # The rows on a mesh: a block per rank where the population tiles
        # it (``mesh`` below), else the whole population on every rank.
        mesh = None
        if getattr(samples, "shard_local", False):
            mesh = self.mesh
        elif self.mesh is not None and len(samples) % self.mesh.size == 0:
            mesh = self.mesh
            for name in ("x", "log_q", "log_prior", "log_likelihood"):
                setattr(samples, name, self.shard_array(getattr(samples,
                                                                name)))
        ranks = mesh.size if mesh is not None else 1
        if store_sample_history:
            self.history.sample_history.append(
                self._history_snapshot(samples, mesh))
        waste_free = bool(self.sampler_kwargs.get("waste_free", False))
        k_steps = int(self.sampler_kwargs.get("n_steps") or 5 * self.dims)
        if waste_free:
            if not self.target_is_capturable():
                raise ValueError(
                    "waste_free SMC requires a target a CUDA graph can "
                    "capture (the pooled chain states are gathered on the "
                    "device; see target_is_capturable).")
            n_now = len(samples) * ranks
            if n_now % k_steps:
                raise ValueError(
                    "waste_free SMC pools k * (n/k) states back into the "
                    f"population: n_samples ({n_now}) must be "
                    f"divisible by the mutation n_steps ({k_steps}); got "
                    f"remainder {n_now % k_steps}. Adjust n_samples "
                    "or sampler_kwargs['n_steps'].")
            if self.mesh is not None and (n_now // k_steps) % self.mesh.size:
                raise ValueError(
                    "waste_free SMC on a mesh shards the M = n/k ancestor "
                    f"population: M ({n_now // k_steps}) must be divisible "
                    f"by the mesh size ({self.mesh.size}).")

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

        if checkpoint_callback is None and checkpoint_every is not None:
            checkpoint_callback = self.default_file_checkpoint_callback(
                checkpoint_file_path)
        if checkpoint_callback is not None and checkpoint_every is None:
            checkpoint_every = 1

        def maybe_checkpoint(force: bool = False, rows=None) -> None:
            """The checkpoint due at this iteration; ``rows``: the mesh
            the population's rows are sharded over (each rank writes its
            own)."""
            if checkpoint_callback is not None and (
                    force or checkpoint_due(iterations, checkpoint_every)):
                checkpoint_callback(self.build_checkpoint_state(
                    samples, iterations, meta={"beta": beta}, mesh=rows))

        run_host_ladder = True
        last_beta = self.history.beta[-1] if self.history.beta else beta
        if resumed and last_beta >= 1.0:
            run_host_ladder = False
            logger.info("Checkpoint beta %.4f indicates the SMC loop already "
                        "completed; skipping to the final mutation steps",
                        last_beta)

        if device_ladder is None:
            device_ladder = (self.adaptive
                             and self.preconditioning_transform is None
                             and not store_sample_history
                             and self._ladder_refusal() is None)
            if device_ladder:
                logger.info(
                    "Auto-selected the device ladder (a target a CUDA graph "
                    "can capture, no preconditioning; pass "
                    "device_ladder=False to force the host ladder).")

        if run_host_ladder and device_ladder:
            samples, ladder_iters = self._run_device_ladder(
                samples, min_beta_step=min_beta_step,
                max_beta_step=max_beta_step, beta_tolerance=beta_tolerance,
                # max_n_steps is a cumulative cap, as in the JAX package.
                max_iters=(max(max_n_steps - iterations, 1)
                           if max_n_steps is not None
                           else device_ladder_max_iters),
                store_history=store_sample_history,
                checkpoint_callback=checkpoint_callback,
                checkpoint_every=checkpoint_every, mesh=mesh)
            iterations += ladder_iters
            beta = samples.beta
            if beta < 1.0 and max_n_steps is None:
                logger.warning(
                    "Device ladder hit its %d-iteration buffer at beta=%.4f; "
                    "continuing on the host ladder (raise "
                    "device_ladder_max_iters to keep such runs on the "
                    "device).", device_ladder_max_iters, beta)
            else:
                run_host_ladder = False

        while run_host_ladder:
            iterations += 1
            beta_prev = samples.beta
            target_eff = float(self.current_target_efficiency(beta_prev))
            stats = iteration_stats(
                *self._whole_densities(samples, mesh),
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
            eff = ess / (len(samples) * ranks)
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
            n_before = len(samples) * ranks
            # Waste-free SMC (Dau & Chopin 2020) resamples M = n/k
            # ancestors; the mutation pools their k-step chains back to n.
            samples = samples.resample(
                beta, self.generator,
                n_samples=max(n_before // k_steps, 1) if waste_free else None,
                method=self.resampling_method, impl=self.resampling_impl,
                mesh=mesh)
            self._update_lineage_after_resample(ess, n_before)
            samples = self.mutate(samples, beta, **self._on_mesh(mesh))
            self._update_lineage_after_mutation()
            n_after = len(samples) * ranks
            self.particle_steps += k_steps * (
                n_after // k_steps if waste_free else n_after)
            if store_sample_history:
                self.history.sample_history.append(
                    self._history_snapshot(samples, mesh))
            maybe_checkpoint(rows=mesh)
            if beta == 1.0 or (max_n_steps is not None
                               and iterations >= max_n_steps):
                break

        if (n_final_samples is not None
                and len(samples) * ranks != n_final_samples):
            if float(samples.beta or 0.0) < 1.0:
                self.history.log_norm_ratio.append(
                    float(samples.log_evidence_ratio(1.0, mesh)))
                self.history.log_norm_ratio_var.append(
                    float(samples.log_evidence_ratio_variance(1.0, mesh))
                    / self._lineage_fraction)
            # The collective schedule where the final size tiles the mesh,
            # else the gather (the JAX package's rule).
            final_impl = self.resampling_impl
            if (final_impl != "auto" and self.mesh is not None
                    and n_final_samples % self.mesh.size):
                logger.debug(
                    "n_final_samples (%d) does not tile the %d-device "
                    "mesh; the final draw uses the GSPMD gather "
                    "instead of resampling_impl=%r.", n_final_samples,
                    self.mesh.size, final_impl)
                final_impl = "auto"
            final = samples.resample(1.0, self.generator,
                                     n_samples=n_final_samples,
                                     method=self.resampling_method,
                                     impl=final_impl, mesh=mesh)
            if mesh is not None and n_final_samples % mesh.size:
                mesh = None  # the gather left the whole draw on every rank
            # The returned samples' recorded tau: the windowed estimate on
            # a capturable target (from the tau_walkers subset, affordable
            # at any n), as in the JAX package; an explicit windowed_tau
            # wins either way.
            user_tau = self.sampler_kwargs.get("windowed_tau")
            samples = self.mutate(
                final, 1.0, n_steps=n_final_steps, waste_free=False,
                windowed_tau=(bool(user_tau) if user_tau is not None
                              else self.target_is_capturable()),
                **self._on_mesh(mesh))

        samples = self._whole_population(samples, mesh)
        samples.log_evidence = float(np.sum(self.history.log_norm_ratio))
        samples.log_evidence_error = float(
            np.sqrt(np.sum(self.history.log_norm_ratio_var)))
        maybe_checkpoint(force=True)
        out = samples.to_standard_samples()
        logger.info("Log evidence: %.3f +/- %.3f", out.log_evidence,
                    out.log_evidence_error)
        return out

    # -- config and checkpoints ----------------------------------------------

    def config_dict(self, include_sample_calls: str | bool = "last") -> dict:
        config = super().config_dict(include_sample_calls)
        config["resampling_method"] = self.resampling_method
        config["resampling_impl"] = self.resampling_impl
        return config

    def _checkpoint_extra_state(self, history: SMCHistory | None = None,
                                lineage_fraction: float | None = None
                                ) -> dict:
        """The history (a copy of the sampler's by default), the mutation
        options, the lineage fraction and a fitted flow preconditioning's
        transport map (``checkpoint_payload``)."""
        extra = {
            "history": (copy.deepcopy(self.history) if history is None
                        else history),
            "sampler_kwargs": self.sampler_kwargs,
            "lineage_fraction": (self._lineage_fraction
                                 if lineage_fraction is None
                                 else lineage_fraction),
        }
        payload_fn = getattr(self.preconditioning_transform,
                             "checkpoint_payload", None)
        if payload_fn is not None:
            extra["preconditioning_state"] = payload_fn()
        return extra

    def restore_smc_checkpoint(self, source) -> tuple[SMCSamples, float,
                                                       int]:
        """The population, beta and iteration of a checkpoint; the
        sampler's history, mutation options, lineage fraction and a fitted
        flow preconditioning restored from it. A state whose samples are a
        shard-local snapshot (a checkpoint callback's dict on a mesh of
        more than one rank) holds this rank's rows: it resumes on a mesh
        of that layout only (a checkpoint's files resume on any), and the
        samples come back marked ``shard_local``."""
        samples, state = self.restore_from_checkpoint(source)
        starts = getattr(samples, "shard_starts", None)
        if starts is not None:
            m = len(samples.x)
            if not (self.mesh is not None and list(starts)
                    == [self.mesh.rank * m]
                    and samples.global_n == m * self.mesh.size):
                raise ValueError(
                    f"the checkpoint holds rows {list(starts)} (+{m}) of "
                    f"{samples.global_n}, one rank's shard: resume it on "
                    "the mesh that wrote it, or resume from its files, "
                    "which any mesh reads whole")
        meta = state.get("meta") or {}
        beta = meta.get("beta") if isinstance(meta, dict) else None
        if beta is None:
            beta = state.get("beta", 0.0)
        self.history = copy.deepcopy(state.get("history") or SMCHistory())
        if state.get("sampler_kwargs"):
            self.sampler_kwargs = dict(state["sampler_kwargs"])
        self._lineage_fraction = float(state.get("lineage_fraction", 1.0))
        payload = state.get("preconditioning_state")
        if payload is not None:
            self.preconditioning_transform = get_transform_class(
                payload["class"]).from_checkpoint_payload(
                    payload, device=self.device)
            logger.info("Restored the fitted preconditioning transport map "
                        "from the checkpoint.")
        samples = SMCSamples.from_samples(samples, beta=beta,
                                          dtype=self.dtype,
                                          device=self.device)
        samples.shard_local = starts is not None
        return samples, beta, int(state.get("iteration", 0))

    def _sample_replicated(self, k: int, n_samples: int,
                           kwargs: dict) -> Samples:
        """``k`` independent runs (``sample(n_samples, **kwargs)``), each
        going on with the sampler's generator; their histories in
        ``replicate_histories``."""
        histories = []

        def run_one():
            s = self.sample(n_samples, **kwargs)
            histories.append(self.history)
            return s, s.log_evidence, s.log_evidence_error

        result = self._replicate_evidence(k, run_one, "SMC")
        self.replicate_histories = histories
        return result


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

    def _kernel_step_builder(self, log_prob_fn: Callable, ref,
                             generator: torch.Generator, mesh=None):
        kwargs = self._mutation_kwargs()
        step_name = kwargs.get("step_fn", "tpcn")
        common = dict(
            target_acceptance=kwargs.get("target_acceptance_rate", 0.234),
            adaptation_rate=kwargs.get("adaptation_rate", 0.1), mesh=mesh)
        gen = generator
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
        return step, kwargs.get("initial_step_size", 0.5), False


class EnsembleSMC(SMCSampler):
    """SMC with the affine-invariant ensemble (stretch) move, red-black
    halves (the JAX package's ``EnsembleSMC``; ``n_steps = 5 d``, scale
    ``a = 2``)."""

    @property
    def default_sampler_kwargs(self):
        return {"n_steps": 5 * self.dims, "a": 2.0}

    def _kernel_step_builder(self, log_prob_fn, ref, generator, mesh=None):
        # on a mesh the halves span the ranks: each half-move gathers the
        # population for the partners (K.stretch_step)
        return (partial(K.stretch_step, generator=generator,
                        log_prob_fn=log_prob_fn,
                        a=self._mutation_kwargs().get("a", 2.0), mesh=mesh),
                1.0, False)


#: why the device ladder cannot run NUTS
NUTS_LADDER_REFUSAL = (
    "device_ladder cannot capture NUTS: its doubling loop ends when every "
    "particle's tree has stopped, which a CUDA graph cannot do (it would "
    "run all 2^max_depth - 1 leapfrogs every step); the host ladder runs "
    "it, with one read per doubling and per leaf")


class GradientSMC(SMCSampler):
    """SMC with RWMH, MALA, HMC or NUTS mutation (the JAX package's
    ``GradientSMC``; ``kernel`` in ``sampler_kwargs``, by default the
    class's). Defaults: ``n_steps = 5 d``, initial step size 0.1,
    adaptation rate 0.05, target acceptance 0.234 (RWMH), 0.574 (MALA),
    0.651 (HMC, ``n_leapfrog`` 10) and 0.8 (NUTS, ``max_depth`` 8).

    RWMH runs on the whole-chain kernel where its predicate holds. MALA,
    HMC and NUTS differentiate the tempered density with autograd
    (:func:`value_and_grad_batch`): on the card every value goes through
    the coupling or MAF kernel and its gradient through that kernel's
    plain recompute. NUTS runs on the host ladder only
    (``NUTS_LADDER_REFUSAL``)."""

    kernel_name = "hmc"

    @property
    def default_sampler_kwargs(self):
        return {
            "n_steps": 5 * self.dims,
            "kernel": self.kernel_name,
            "step_size": 0.1,
            "n_leapfrog": 10,  # hmc only
            "max_depth": 8,  # nuts only
            "adaptation_rate": 0.05,
        }

    def _kernel(self, kwargs=None) -> str:
        return (kwargs or self._mutation_kwargs()).get("kernel",
                                                       self.kernel_name)

    def _fused_kernel_config(self, kwargs):
        if self._kernel(kwargs) != "rwmh":
            return None
        return {
            "kernel": "rwmh",
            "nu": 5.0,
            "target_acceptance": float(
                kwargs.get("target_acceptance_rate", 0.234)),
            "adaptation_rate": float(kwargs.get("adaptation_rate", 0.05)),
            "init_step": float(kwargs.get("step_size", 0.1)),
        }

    def _ladder_refusal(self) -> str | None:
        if self._kernel() == "nuts":
            return NUTS_LADDER_REFUSAL
        return super()._ladder_refusal()

    def _kernel_step_builder(self, log_prob_fn, ref, generator, mesh=None):
        kwargs = self._mutation_kwargs()
        kernel = self._kernel(kwargs)
        init_step = kwargs.get("step_size", 0.1)
        rate = kwargs.get("adaptation_rate", 0.05)
        if kernel == "rwmh":
            return (partial(K.rwmh_step, generator=generator,
                            log_prob_fn=log_prob_fn, ref=ref,
                            target_acceptance=kwargs.get(
                                "target_acceptance_rate", 0.234),
                            adaptation_rate=rate, mesh=mesh),
                    init_step, False)
        if kernel not in ("mala", "hmc", "nuts"):
            raise ValueError(f"Unknown gradient kernel: {kernel}")
        if not self.target_is_differentiable():
            raise ValueError(
                "Gradient-based mutation kernels require a differentiable "
                "log-likelihood/log-prior (torch operations autograd can "
                "differentiate; see target_is_differentiable).")
        common = dict(generator=generator,
                      value_and_grad_fn=partial(value_and_grad_batch,
                                                log_prob_fn),
                      adaptation_rate=rate)
        if kernel == "mala":
            step = partial(K.mala_step, target_acceptance=kwargs.get(
                "target_acceptance_rate", 0.574), mesh=mesh, **common)
        elif kernel == "hmc":
            step = partial(
                K.hmc_step, n_leapfrog=kwargs.get("n_leapfrog", 10),
                target_acceptance=kwargs.get("target_acceptance_rate", 0.651),
                jitter_trajectory=kwargs.get("jitter_trajectory", False),
                mesh=mesh, **common)
        else:
            # a data-dependent number of draws: its loops end on the whole
            # population's flags on a mesh (an integer all-reduce a trip)
            step = partial(
                K.nuts_step, max_depth=kwargs.get("max_depth", 8),
                target_acceptance=kwargs.get("target_acceptance_rate", 0.8),
                mesh=mesh, **common)
        return step, init_step, True


class RWMHSMC(GradientSMC):
    kernel_name = "rwmh"


class MALASMC(GradientSMC):
    kernel_name = "mala"


class HMCSMC(GradientSMC):
    kernel_name = "hmc"


class NUTSSMC(GradientSMC):
    kernel_name = "nuts"
