"""Wrapper for the CUDA whole-chain Metropolis kernel, and its plain version.

Counterpart of ``aspire_tpu/ops/fused_mutation.py``. One launch of the
kernel (``csrc/chain.cu``) runs an entire k-step tpCN / pCN / RWMH chain;
each 256-particle tile adapts its own step size. The kernel runs the flow's
conditioner products on the tensor cores, 32 particles per warp, in the
packed layout of the coupling kernel (:func:`prepare_chain_params` is
``fused_coupling.prepare_mma_params``: mma fragments of split-TF32
weights); this module checks the packing against the library's and
launches. A shape in the wide form (``fused_coupling.mma_wide``, BASELINE
config 5's d = 32 flow) keeps its chain state in shared memory and its
per-particle running sums in a scratch tensor the wrapper allocates. :func:`chain_plain` is the same algorithm in
torch: the version a CPU tensor runs and the one the kernel is held
against on the card.

The chain's tempered density runs the preconditioning inverse and the
flow's data transform as transform programs (:class:`TDProgram`,
:func:`canonicalize_transform`, :func:`td_apply`: the JAX package's "TD
programs"): identity, affine, logit, probit and periodic maps, masked
per dimension in a composite. The kernel reads a program as per-dimension
op codes and coefficients in its constant block (:func:`program_block`).

The target is an in-kernel id with its constants, or a user's own
(:class:`UserTarget`: a ``KernelSource`` and its plain version, the
user's torch callables), which runs on an instance of the kernel built
with its source at first use (``_build.load_user_library``).

Semantics deltas against the JAX package's XLA chain, as for its TPU
kernel: per-tile step-size adaptation (over this port's 256-particle
tile); proposal noise from Philox4x32-10 (:func:`philox_uniforms`, the
same stream in torch and in the kernel) instead of the TPU's on-core
generator; ``(n_steps + 1) * n`` target evaluations per chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from collections.abc import Callable

import numpy as np
import torch

from .. import transforms as T
from ..flows.architectures import Coupling
from ..models.targets import KernelSource, target_densities
from . import fused_coupling as FC
from ._build import LaunchCounter, check, load_library, load_user_library

# The chain kernel's weight layout is the tensor-core pass's it shares with
# the coupling kernel (csrc/coupling_mma.cuh), under the chain's names.
from .fused_coupling import mma_conditioner_plain as chain_conditioner_plain
from .fused_coupling import mma_group as chain_group
from .fused_coupling import mma_layout as chain_layout
from .fused_coupling import mma_sections as chain_sections
from .fused_coupling import prepare_mma_params as prepare_chain_params

TILE = 256
KERNELS = {"tpcn": 0, "pcn": 1, "rwmh": 2}
#: configuration id the chain kernel is compiled for -> the in-kernel
#: target ids it compiles (ASPIRE_CHAIN_CONFIGS and its TARGETS column:
#: ids 4 and 5 only at d = 2 and d = 5, so the d = 4 and d = 32 kernels
#: keep the code they had before them)
CHAIN_CONFIGS = {0: (1, 2, 3), 2: (1, 2, 3), 3: (1, 2, 3, 4, 5),
                 4: (1, 2, 3, 4, 5)}
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
#: the user target's id in an instance built with its source (chain.cu
#: ``kUser``)
USER_TARGET = 6

launches = LaunchCounter()
#: launches of a user target's evaluation entry (:func:`user_target_eval`)
user_target_launches = LaunchCounter()


@dataclasses.dataclass(frozen=True, eq=False)
class UserTarget:
    """A user's target for the chain: ``source``, its CUDA body, and
    ``plain``, its plain version, ``x (n, d)`` in data space ->
    ``(log_prior, log_likelihood)`` (the user's torch callables). A
    chain's ``target`` is then ``(UserTarget, constants)``, the constants
    the source reads."""

    source: KernelSource
    plain: Callable


def _densities(target_id, consts, x):
    """``(log_prior, log_likelihood)`` of the chain's target at ``x``, in
    x's dtype, NaN -> -inf: an in-kernel id's arithmetic, or a user
    target's plain version."""
    if not isinstance(target_id, UserTarget):
        return target_densities(target_id, consts, x)
    lpi, ll = target_id.plain(x)
    return tuple(_neg_inf_if_nan(torch.as_tensor(v).reshape(-1).to(x))
                 for v in (lpi, ll))


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of one chain."""

    arch: Coupling
    kernel: str  # "tpcn" | "pcn" | "rwmh"
    n_steps: int
    nu: float = 5.0
    target_acceptance: float = 0.234
    adaptation_rate: float = 0.1
    gamma_m: int = 0
    gamma_odd: int = 0

    @property
    def max_log_step(self) -> float:
        return 2.3 if self.kernel == "rwmh" else 0.0

    @property
    def noise_rows(self) -> int:
        """Uniform rows per step: d normals, the tpCN Gamma rows, accept."""
        rows = self.arch.dims + 1
        if self.kernel == "tpcn":
            rows += self.gamma_m + (1 if self.gamma_odd else 0)
        return rows


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch (the kernel's generator, bit for bit)
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of ``a * b`` for 32-bit ``a``, ``b``,
    in int64 arithmetic that never overflows."""
    t1 = a * (b & 0xFFFF)
    t2 = a * (b >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return ((t2 >> 16) + (s >> 32)) & _MASK, s & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK
            k1 = (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed, step: int, rows: int, n: int, device,
                    tile: int = TILE) -> torch.Tensor:
    """The ``(rows, n)`` uniforms of one chain step, as the kernel draws
    them: counter (particle in tile, step, row group, tile), key = seed,
    23 random bits per uniform."""
    p = torch.arange(n, dtype=torch.int64, device=device)
    local, tile_id = p % tile, p // tile
    step_c = torch.full_like(p, step)
    out = []
    for g in range(-(-rows // 4)):
        words = philox4x32_10(local, step_c, torch.full_like(p, g), tile_id,
                              int(seed[0]) & _MASK, int(seed[1]) & _MASK)
        out.extend(words)
    bits = torch.stack(out[:rows])
    return (bits >> 9).to(torch.float32) * 2.0**-23


def _normal(u: torch.Tensor) -> torch.Tensor:
    return math.sqrt(2.0) * torch.erfinv(2.0 * (u + 2.0**-24) - 1.0)


def _neg_inf_if_nan(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(v), torch.full_like(v, -math.inf), v)


# ---------------------------------------------------------------------------
# Transform programs ("TD programs", the JAX package's fused_mutation.py)
# ---------------------------------------------------------------------------


class TDProgram:
    """Static op list and parameter tensors of one elementwise transform.

    ``ops`` is a tuple of ``(kind, has_mask)``, kind one of ``"affine"``,
    ``"logit"``, ``"probit"`` and ``"periodic"``; ``params`` the flat list
    :func:`td_apply` consumes in order: a 0/1 float mask first where
    ``has_mask``, then the op's own (affine mean, std; logit and probit
    lower, upper, eps; periodic lower, upper), each a ``(d,)`` tensor but
    eps, ``(1,)``.
    """

    def __init__(self, ops=(), params=(), n_params_per_op=()):
        self.ops = tuple(ops)
        self.params = list(params)
        self.n_params_per_op = tuple(n_params_per_op)


def _col(v, d: int, dtype) -> torch.Tensor:
    a = torch.as_tensor(v).to(dtype=dtype).reshape(-1)
    return (a.expand(d) if a.numel() == 1 and d > 1 else a).reshape(d)


def _expand_masked(values, mask, fill: float, d: int, dtype) -> torch.Tensor:
    """Masked sub-transform parameters scattered back to a full ``(d,)``
    column, ``fill`` where the mask is off."""
    values = torch.as_tensor(values)
    out = torch.full((d,), fill, dtype=dtype, device=values.device)
    out[torch.as_tensor(np.nonzero(mask)[0], device=values.device)] = (
        values.to(dtype).reshape(-1))
    return out


def _mask_col(mask, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask, dtype=np.float32), device=device)


def affine_program(mean, std) -> TDProgram:
    """The program of the affine map ``(x - mean) / std``."""
    return TDProgram((("affine", False),), (mean, std), (2,))


def canonicalize_transform(t, dims: int,
                           dtype=torch.float32) -> TDProgram | None:
    """Lower a fitted transform of ``aspire_tpu_torch.transforms`` to a
    program (None: it does not lower). Parameters in ``dtype``, float32 by
    default as in the JAX package; masked ops fill the unmasked dims with
    lower 0 and upper 1."""
    if t is None or isinstance(t, T.IdentityTransform):
        return TDProgram()
    if isinstance(t, T.AffineTransform):
        if t._mean is None:
            return TDProgram()
        return affine_program(_col(t._mean, dims, dtype),
                              _col(t._std, dims, dtype))
    if isinstance(t, (T.LogitTransform, T.ProbitTransform)):
        kind = "logit" if isinstance(t, T.LogitTransform) else "probit"
        lower, upper = _col(t.lower, dims, dtype), _col(t.upper, dims, dtype)
        eps = torch.full((1,), t.eps, dtype=dtype, device=lower.device)
        return TDProgram(((kind, False),), (lower, upper, eps), (3,))
    if isinstance(t, T.PeriodicTransform):
        return TDProgram((("periodic", False),),
                         (_col(t.lower, dims, dtype),
                          _col(t.upper, dims, dtype)), (2,))
    if isinstance(t, T.CompositeTransform):
        ops, params, nper = [], [], []
        if t._periodic_transform is not None:
            mask = np.asarray(t._periodic_mask, bool)
            sub = t._periodic_transform
            ops.append(("periodic", True))
            params += [_mask_col(mask, sub.lower.device),
                       _expand_masked(sub.lower, mask, 0.0, dims, dtype),
                       _expand_masked(sub.upper, mask, 1.0, dims, dtype)]
            nper.append(3)
        if t._bounded_transform is not None:
            mask = np.asarray(t._bounded_mask, bool)
            sub = t._bounded_transform
            ops.append(("logit" if isinstance(sub, T.LogitTransform)
                        else "probit", True))
            params += [_mask_col(mask, sub.lower.device),
                       _expand_masked(sub.lower, mask, 0.0, dims, dtype),
                       _expand_masked(sub.upper, mask, 1.0, dims, dtype),
                       torch.full((1,), sub.eps, dtype=dtype,
                                  device=sub.lower.device)]
            nper.append(4)
        if t._affine_transform is not None:
            sub = t._affine_transform
            if sub._mean is None:
                return None
            ops.append(("affine", False))
            params += [_col(sub._mean, dims, dtype),
                       _col(sub._std, dims, dtype)]
            nper.append(2)
        return TDProgram(ops, params, nper)
    return None


def _floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a mod b`` with the sign of the divisor, as ``jnp.mod``: the
    truncated remainder, plus ``b`` where the two signs differ."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _masked_logj(mask, per_dim: torch.Tensor) -> torch.Tensor:
    if mask is not None:
        per_dim = torch.where(mask, per_dim, torch.zeros_like(per_dim))
    return torch.sum(per_dim, dim=-1)


def td_apply(prog: TDProgram, params, x: torch.Tensor, inverse: bool):
    """Apply a program to ``(n, d)`` points: ``(y, log_j (n,))``. Forward
    maps data to the flow's space (``CompositeTransform.forward``); inverse
    runs the ops reversed. Terms of the parameters alone are computed in
    the parameters' type, as in the JAX package."""
    log_j = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    offs = [0, *itertools.accumulate(prog.n_params_per_op)]
    order = range(len(prog.ops))
    for i in (reversed(order) if inverse else order):
        kind, has_mask = prog.ops[i]
        p = list(params[offs[i]:offs[i + 1]])
        mask = p.pop(0) > 0.5 if has_mask else None
        if kind == "affine":
            mean, std = p
            if not inverse:
                x, lj = (x - mean) / std, -torch.log(torch.abs(std))
            else:
                x, lj = x * std + mean, torch.log(torch.abs(std))
            log_j = log_j + torch.sum(lj)
            continue
        if kind == "periodic":
            lower, upper = p
            y = lower + _floor_mod(x - lower, upper - lower)
            x = torch.where(mask, y, x) if mask is not None else y
            continue
        if kind not in ("logit", "probit"):
            raise ValueError(f"unknown transform op {kind!r}")
        lower, upper, eps = p
        denom = upper - lower
        if not inverse:
            u = torch.minimum(torch.maximum((x - lower) / denom, eps),
                              1.0 - eps)
            if kind == "logit":
                y = torch.log(u) - torch.log1p(-u)
                lj = -(torch.log(u) + torch.log1p(-u))
            else:
                y = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
                lj = 0.5 * math.log(2 * math.pi) + 0.5 * y**2
            lj = lj - torch.log(denom)
        else:
            if kind == "logit":
                u = torch.sigmoid(x)
                lj = (torch.nn.functional.logsigmoid(x)
                      + torch.nn.functional.logsigmoid(-x))
            else:
                u = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
                lj = -(0.5 * math.log(2 * math.pi) + 0.5 * x**2)
            y = denom * u + lower
            lj = lj + torch.log(denom)
        x = torch.where(mask, y, x) if mask is not None else y
        log_j = log_j + _masked_logj(mask, lj)
    return x, log_j


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def chain_plain(cfg: ChainConfig, params: dict, z0: torch.Tensor, beta,
                step0: torch.Tensor, ref_mean, ref_chol, ref_ichol,
                target, data_transform=None, precond=None, noise=None,
                seed=None, return_acc_probs: bool = False):
    """The whole chain in torch, tile by tile in lockstep.

    ``target`` is ``(id, constants)`` of an in-kernel target, or
    ``(UserTarget, constants)``;
    ``data_transform`` and ``precond`` are the programs (:class:`TDProgram`,
    None for the identity) of the flow's data transform and of the
    preconditioning. The chain runs in the preconditioned space: its state,
    proposals, statistics and the returned z; the tempered density maps a
    point to data space by the preconditioning's inverse (adding its
    log-Jacobian), evaluates the target there and the flow after the data
    transform, as the JAX package's kernel does. Uniforms come from
    ``noise`` (``(n_steps, rows, n)``) when given, else from
    :func:`philox_uniforms` with ``seed``. Returns ``(z, lq, lpi, ll,
    n_accept, step_sizes (n_tiles,), stats (n_tiles, 4d + 1))``, plus the
    per-step acceptance probabilities when ``return_acc_probs``.
    """
    arch = cfg.arch
    n, d = z0.shape
    nt = n // TILE
    if nt * TILE != n:
        raise ValueError(f"n={n} is not a multiple of the tile {TILE}")
    target_id, consts = target
    consts = consts.to(z0)
    needs_r2 = cfg.kernel != "rwmh"
    alpha_g = 0.5 * (cfg.nu + d)

    dt = data_transform if data_transform is not None else TDProgram()
    pc = precond if precond is not None else TDProgram()

    def tempered(z):
        x, pc_lj = (td_apply(pc, pc.params, z, inverse=True) if pc.ops
                    else (z, 0.0))
        xf, dt_lj = (td_apply(dt, dt.params, x, inverse=False) if dt.ops
                     else (x, 0.0))
        zl, ld = arch.forward_plain(params, xf)
        lq = (-0.5 * torch.sum(zl * zl, dim=-1) - d * _HALF_LOG_2PI + ld
              + dt_lj)
        lpi, ll = _densities(target_id, consts, x)
        lp = _neg_inf_if_nan((1.0 - beta) * lq + beta * (ll + lpi) + pc_lj)
        return lp, lq, lpi, ll

    def mahal2(x):
        y = (x - ref_mean) @ ref_ichol.T
        return torch.sum(y * y, dim=-1)

    x = z0
    lp, lq, lpi, ll = tempered(x)
    r2 = mahal2(x) if needs_r2 else torch.zeros_like(lp)
    s = step0.to(z0).reshape(nt).clone()
    nacc = torch.zeros_like(lp)
    zeros = torch.zeros_like(z0)
    prev, s1, s2, c1 = zeros, zeros, zeros, zeros
    acc_history = []
    for t in range(cfg.n_steps):
        u = (noise[t] if noise is not None else
             philox_uniforms(seed, t, cfg.noise_rows, n, z0.device))
        u = u.to(z0)
        lxi = _normal(u[:d]).T @ ref_chol.T
        sp = s.repeat_interleave(TILE)[:, None]
        if cfg.kernel == "rwmh":
            xp = x + sp * lxi
        else:
            s_c = torch.clamp(sp, max=1.0)
            rot = torch.sqrt(torch.clamp(1.0 - s_c * s_c, min=0.0))
            scale = s_c
            if cfg.kernel == "tpcn":
                w_raw = torch.zeros_like(lp)
                row = d
                for j in range(0, cfg.gamma_m - 1, 2):
                    w_raw = w_raw - torch.log(
                        (1.0 - u[row + j]) * (1.0 - u[row + j + 1]))
                if cfg.gamma_m % 2:
                    w_raw = w_raw - torch.log(1.0 - u[row + cfg.gamma_m - 1])
                row += cfg.gamma_m
                if cfg.gamma_odd:
                    g = _normal(u[row])
                    w_raw = w_raw + 0.5 * g * g
                wg = w_raw / (0.5 * (cfg.nu + r2))
                scale = s_c / torch.sqrt(wg)[:, None]
            xp = ref_mean + rot * (x - ref_mean) + scale * lxi
        if needs_r2:
            r2n = mahal2(xp)
            corr = (0.5 * (r2n - r2) if cfg.kernel == "pcn" else
                    alpha_g * torch.log((cfg.nu + r2n) / (cfg.nu + r2)))
        else:
            r2n, corr = r2, 0.0
        lp_p, lq_p, lpi_p, ll_p = tempered(xp)
        log_alpha = _neg_inf_if_nan(lp_p - lp + corr)
        acc_p = torch.exp(torch.clamp(log_alpha, max=0.0))
        accept = u[-1] < acc_p
        x = torch.where(accept[:, None], xp, x)
        lp = torch.where(accept, lp_p, lp)
        lq = torch.where(accept, lq_p, lq)
        lpi = torch.where(accept, lpi_p, lpi)
        ll = torch.where(accept, ll_p, ll)
        r2 = torch.where(accept, r2n, r2)
        nacc = nacc + accept.to(nacc.dtype)
        delta = x - z0
        s1, s2, c1, prev = s1 + delta, s2 + delta * delta, c1 + delta * prev, delta
        acc_mean = acc_p.reshape(nt, TILE).sum(dim=1) / TILE
        s = torch.exp(torch.clamp(
            torch.log(s) + cfg.adaptation_rate
            * (acc_mean - cfg.target_acceptance),
            -10.0, cfg.max_log_step))
        acc_history.append(acc_p)
    stats = tile_stats(z0, s1, s2, c1, cfg.n_steps, s)
    out = (x, lq, lpi, ll, nacc, s, stats)
    if return_acc_probs:
        return out + (torch.stack(acc_history),)
    return out


def tile_stats(x0, s1, s2, c1, n_steps: int, steps: torch.Tensor):
    """Per-tile ``[step, rho_sum (d), within_sum (d), wm_sum (d),
    wm_m2 (d)]`` rows (the layout of the JAX package's ``_stats_rows``)."""
    n, d = x0.shape
    nt = n // TILE
    m = n_steps + 1
    dev_mean = s1 / m
    var = s2 / m - dev_mean**2
    cov1 = c1 / n_steps - dev_mean**2
    rho = torch.where(var > 1e-12, cov1 / torch.clamp(var, min=1e-12),
                      torch.ones_like(var))
    wm = (x0 + dev_mean).reshape(nt, TILE, d)
    wm_sum = wm.sum(dim=1)
    wm_m2 = ((wm - (wm_sum / TILE)[:, None]) ** 2).sum(dim=1)
    return torch.cat([
        steps.reshape(nt, 1),
        rho.reshape(nt, TILE, d).sum(dim=1),
        var.reshape(nt, TILE, d).sum(dim=1),
        wm_sum,
        wm_m2,
    ], dim=1)


def combine_tile_stats(stats: torch.Tensor, d: int, tile: int = TILE):
    """Reduce per-tile stats rows to ``(tau, mixing)``, as
    ``kernels.lag1_autocorr_time``/``chain_mixing_ratio`` over all walkers."""
    n = stats.shape[0] * tile
    rho_dim = torch.clamp(torch.sum(stats[:, 1:1 + d], dim=0) / n,
                          -0.9999, 0.9999)
    tau = torch.mean(torch.clamp((1.0 + rho_dim) / (1.0 - rho_dim), min=1.0))
    within = torch.sum(stats[:, 1 + d:1 + 2 * d], dim=0) / n
    wm_sum = stats[:, 1 + 2 * d:1 + 3 * d]
    wm_m2 = stats[:, 1 + 3 * d:1 + 4 * d]
    grand = torch.sum(wm_sum, dim=0) / n
    between = (torch.sum(wm_m2, dim=0)
               + tile * torch.sum((wm_sum / tile - grand) ** 2, dim=0)) / n
    pooled = within + between
    ratio = torch.where(pooled > 1e-12,
                        within / torch.clamp(pooled, min=1e-12),
                        torch.ones_like(pooled))
    return tau, torch.clamp(torch.min(ratio), 0.0, 1.0)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------


def kernel_supports(cfg: ChainConfig, target_id=None) -> bool:
    """Whether the chain kernel is compiled for this flow configuration
    (and, given, for the in-kernel target ``target_id``; a
    :class:`UserTarget` is built for any configuration)."""
    arch = cfg.arch
    return (isinstance(arch, Coupling) and len(arch.n_hidden) == 2
            and FC.config_id(arch) in CHAIN_CONFIGS
            and cfg.kernel in KERNELS
            and (target_id is None or isinstance(target_id, UserTarget)
                 or int(target_id) in CHAIN_CONFIGS[FC.config_id(arch)]))


#: a lowered program's per-dimension op codes, and the ops-present flag
#: of the affine map (csrc/chain.cu ``ProgOp``)
PROG_CODES = {"periodic": 1, "logit": 2, "probit": 4, "affine": 8}
# The kernel applies a program's ops forward in this order, inverse in the
# reverse: the order canonicalize_transform gives a composite's.
_PROG_ORDER = ("periodic", "bounded", "affine")


def program_floats(d: int) -> int:
    """Floats of one lowered program (csrc/chain.cu ``Prog<D>::SIZE``)."""
    return 8 * d + 3


def consts_layout(d: int) -> tuple[int, ...]:
    """The chain kernel's constant block at ``d``, as the library's
    ``aspire_consts_layout`` gives it: the offsets of the data-transform
    program, the preconditioning program, the target constants, beta, the
    seed pair and the programs' constant log-Jacobians (the last three
    written by the kernel), then the block's size in floats. Before the
    programs: the reference mean, its Cholesky factor and the factor's
    inverse."""
    dt = d + 2 * d * d
    pc = dt + program_floats(d)
    target = pc + program_floats(d)
    beta = target + 2 * d + 2
    return dt, pc, target, beta, beta + 1, beta + 3, 4 * -(-(beta + 5) // 4)


def program_block(prog: TDProgram | None, d: int, device) -> torch.Tensor:
    """A program as the kernel reads it (``Prog<D>``): per dimension its op
    code (``PROG_CODES``: 0 where no op touches the dimension), the
    periodic lower bound and width, the bounded lower bound, width and the
    width's reciprocal, the affine mean and std; then the ops present (the
    codes' union, 8 for affine), the bounded op's eps and its dimensions'
    log-widths summed; zeros (no op present) for no program. Device
    operations only. Raises for ops out of the kernel's order."""
    f32 = dict(dtype=torch.float32, device=device)
    if prog is None or not prog.ops:
        return torch.zeros(program_floats(d), **f32)
    zeros, ones = torch.zeros(d, **f32), torch.ones(d, **f32)
    code, p_lo, p_w, b_lo, b_w, mean, std = (zeros, zeros, ones, zeros, ones,
                                             zeros, ones)
    eps, log_w = torch.zeros(1, **f32), torch.zeros(1, **f32)
    offs = [0, *itertools.accumulate(prog.n_params_per_op)]
    flags, last = 0, -1
    for i, (kind, has_mask) in enumerate(prog.ops):
        rank = _PROG_ORDER.index(
            "bounded" if kind in ("logit", "probit") else kind)
        if rank <= last:
            raise ValueError(f"the chain kernel takes a program's ops once "
                             f"each, in the order {_PROG_ORDER}: {prog.ops}")
        last, flags = rank, flags | PROG_CODES[kind]
        p = [q.to(**f32) for q in prog.params[offs[i]:offs[i + 1]]]
        mask = p.pop(0) if has_mask else ones
        if kind == "affine":
            mean, std = p
        elif kind == "periodic":
            code, p_lo, p_w = code + PROG_CODES[kind] * mask, p[0], p[1] - p[0]
        else:
            code, b_lo, b_w = code + PROG_CODES[kind] * mask, p[0], p[1] - p[0]
            eps = p[2].reshape(1)
            log_w = torch.sum(mask * torch.log(b_w)).reshape(1)
    return torch.cat([code, p_lo, p_w, b_lo, b_w, 1.0 / b_w, mean, std,
                      torch.full((1,), float(flags), **f32), eps, log_w])


def program_level(data_transform: TDProgram | None,
                  precond: TDProgram | None) -> int:
    """The kernel instance the two programs need (csrc/chain.cu
    ``ProgramLevel``): 0 for none, 1 for an affine data transform alone
    (the instance without programs), 2 for any other."""
    if precond is not None and precond.ops:
        return 2
    ops = data_transform.ops if data_transform is not None else ()
    if not ops:
        return 0
    return 1 if ops == (("affine", False),) else 2


def chain_consts(d: int, ref_mean, ref_chol, ref_ichol, dt_block, pc_block,
                 consts) -> torch.Tensor:
    """The kernel's constant block (``consts_layout(d)``): reference mean,
    Cholesky factor and its inverse, the data transform's and the
    preconditioning's programs as :func:`program_block` lowers them, the
    target constants, zero-padded; the kernel writes beta, the seed and
    the programs' constant log-Jacobians itself."""
    dev = ref_mean.device
    parts = [ref_mean.reshape(d), ref_chol.reshape(-1), ref_ichol.reshape(-1),
             dt_block, pc_block, consts.reshape(-1)]
    flat = torch.cat([p.to(device=dev, dtype=torch.float32) for p in parts])
    beta, size = consts_layout(d)[3], consts_layout(d)[-1]
    if flat.numel() > beta:
        raise ValueError("target constants exceed the kernel's block")
    return torch.nn.functional.pad(flat, (0, size - flat.numel())).contiguous()


def chain_shared_bytes(arch, consts_floats: int) -> int:
    """Shared memory of a chain kernel block: the constant block, two
    rows of tile-sum scratch, a warp buffer per warp, and every layer's
    weights, or in the wide form two ``(d, TILE)`` state arrays and the
    weight stream's buffers (:func:`FC.mma_weight_buffers`)."""
    layout = chain_layout(arch)
    warps = TILE // 32
    state = (2 * arch.dims * TILE + FC.mma_weight_buffers(arch)
             if FC.mma_wide(arch) else arch.n_layers * layout[0])
    return 4 * (state + consts_floats + 2 * warps + warps * layout[8])


@functools.lru_cache(maxsize=None)
def _chain_library_layout(lib, cfg: int) -> tuple[int, ...]:
    """Library ``lib``'s layout of chain configuration ``cfg``
    (``aspire_chain_layout``), read once per process."""
    out = (ctypes.c_int * 16)()
    count = lib.aspire_chain_layout(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"chain configuration {cfg} has no layout table")
    return tuple(out[:count])


@functools.lru_cache(maxsize=None)
def _consts_library_layout(lib, d: int) -> tuple[int, ...]:
    """Library ``lib``'s constant block at ``d`` (``aspire_consts_layout``),
    read once per process."""
    out = (ctypes.c_int * 8)()
    count = lib.aspire_consts_layout(d, out, len(out))
    if not 0 <= count <= len(out):
        raise ValueError(f"no chain kernel compiled for d={d}")
    return tuple(out[:count])


def _device_scalars(values, dtype, device) -> torch.Tensor:
    """``values`` (a tensor, a number or a sequence of numbers) as a
    contiguous tensor of ``dtype`` on ``device``; a tensor already there is
    used as it is. Numbers are filled in on the device: a pageable
    host-to-device copy would wait for the work before it."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=dtype).reshape(-1).contiguous()
    values = list(values) if isinstance(values, (tuple, list)) else [values]
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def fused_mh_chain(cfg: ChainConfig, params: dict, z0: torch.Tensor, beta,
                   seed, step0: torch.Tensor, ref_mean, ref_chol, ref_ichol,
                   target, data_transform=None, precond=None, noise=None,
                   blocks=None):
    """Run the whole chain: the kernel on a CUDA tensor, the plain version
    (:func:`chain_plain`) on a CPU tensor. Same arguments and returns as
    ``chain_plain``; ``blocks``, the two programs as :func:`program_block`
    lowers them on the card, when the caller has them (the sampler lowers
    them once per spec, outside any CUDA graph capture), else they are
    lowered here.

    ``beta`` is a number or a one-element tensor; ``seed`` a pair of
    32-bit integers or a two-element integer tensor (ignored with
    ``noise``); ``step0`` the ``(n_tiles,)`` initial step sizes. The kernel
    reads ``beta`` and ``seed`` from device memory when it runs, so a
    launch captured in a CUDA graph takes each replay's values from the
    tensors passed at capture.
    """
    if z0.device.type == "cpu":
        return chain_plain(cfg, params, z0, beta, step0, ref_mean, ref_chol,
                           ref_ichol, target, data_transform=data_transform,
                           precond=precond, noise=noise, seed=seed)
    if not z0.is_cuda:
        raise ValueError(f"unsupported device {z0.device}")
    lib = load_library()
    arch = cfg.arch
    n, d = z0.shape
    target_id, tconsts = target
    user = isinstance(target_id, UserTarget)
    if not kernel_supports(cfg, target_id):
        raise ValueError(f"no chain kernel compiled for {arch}/{cfg.kernel} "
                         f"with target {target_id}")
    # A user target runs on its own instance: the chain entry and layouts
    # of the library built with its source for this configuration.
    chain_lib = (load_user_library(target_id.source, FC.config_id(arch))
                 if user else lib)
    if z0.dtype != torch.float32 or not z0.is_contiguous():
        raise TypeError("the chain kernel takes a contiguous float32 z0")
    if d != arch.dims or n % TILE or chain_lib.aspire_chain_tile() != TILE:
        raise ValueError(f"z0 must be (k * {TILE}, {arch.dims}); got {tuple(z0.shape)}")
    if cfg.n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    nt = n // TILE
    step0 = step0.to(device=z0.device, dtype=torch.float32).contiguous()
    if step0.shape != (nt,):
        raise ValueError(f"step0 must have shape ({nt},)")
    if noise is not None:
        noise = noise.to(device=z0.device, dtype=torch.float32).contiguous()
        if noise.shape != (cfg.n_steps, cfg.noise_rows, n):
            raise ValueError(f"noise must have shape "
                             f"{(cfg.n_steps, cfg.noise_rows, n)}")
    layout = chain_layout(arch)
    if _chain_library_layout(chain_lib, FC.config_id(arch)) != layout:
        raise RuntimeError("chain weight layout disagrees with the kernel "
                           "library")
    if _consts_library_layout(chain_lib, d) != consts_layout(d):
        raise RuntimeError("chain constant block disagrees with the kernel "
                           "library")
    weights = FC.packed_coupling_params(arch, params, z0.device)
    smem = chain_shared_bytes(arch, consts_layout(d)[-1])
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(f"chain kernel needs {smem} bytes of shared memory")
    if blocks is None:
        blocks = (program_block(data_transform, d, z0.device),
                  program_block(precond, d, z0.device))
    if user:
        user_consts = tconsts.to(device=z0.device,
                                 dtype=torch.float32).contiguous()
        tconsts = user_consts[:0]
    consts = chain_consts(d, ref_mean, ref_chol, ref_ichol, *blocks, tconsts)
    beta_dev = _device_scalars(beta, torch.float32, z0.device)
    if seed is None:
        seed = (0, 0)
    elif not isinstance(seed, torch.Tensor):
        seed = tuple(int(v) & _MASK for v in seed)
    seed_dev = _device_scalars(seed, torch.int64, z0.device)
    if beta_dev.numel() != 1 or seed_dev.numel() != 2:
        raise ValueError("beta takes one value and seed two")
    z = torch.empty_like(z0)
    lq, lpi, ll, nacc = (torch.empty(n, dtype=torch.float32,
                                     device=z0.device) for _ in range(4))
    stats = torch.empty((nt, 4 * d + 1), dtype=torch.float32,
                        device=z0.device)
    # The wide form's per-particle running sums (3, d, n).
    scratch = (torch.empty(3 * d * n, dtype=torch.float32, device=z0.device)
               if FC.mma_wide(arch) else None)
    launch = chain_lib.aspire_chain_user if user else chain_lib.aspire_chain
    with torch.cuda.device(z0.device):
        code = launch(
            z0.data_ptr(), weights.data_ptr(), consts.data_ptr(),
            step0.data_ptr(), noise.data_ptr() if noise is not None else None,
            z.data_ptr(), lq.data_ptr(), lpi.data_ptr(), ll.data_ptr(),
            nacc.data_ptr(), stats.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, arch.n_layers, cfg.n_steps, KERNELS[cfg.kernel], cfg.gamma_m,
            cfg.gamma_odd, cfg.noise_rows,
            program_level(data_transform, precond),
            USER_TARGET if user else int(target_id), beta_dev.data_ptr(),
            float(cfg.nu), float(cfg.target_acceptance),
            float(cfg.adaptation_rate), float(cfg.max_log_step),
            float(arch.tail_bound), seed_dev.data_ptr(), FC.config_id(arch),
            torch.cuda.current_stream(z0.device).cuda_stream,
            *((user_consts.data_ptr(),) if user else ()),
        )
    launches.count += 1
    check(code, "chain kernel")
    return z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats


def user_target_eval(target: UserTarget, consts: torch.Tensor, config: int,
                     x: torch.Tensor):
    """``(log_prior, log_likelihood)`` of the user target at ``x (n, d)``
    in data space, NaN -> -inf: on a CUDA tensor one launch of the
    instance built with its source for chain configuration ``config``
    (the arithmetic the chain runs), on a CPU tensor its plain version."""
    if x.device.type == "cpu":
        return _densities(target, consts, x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError("the user target takes a float32 (n, d) x")
    lib = load_user_library(target.source, config)
    x = x.contiguous()
    consts = consts.to(device=x.device, dtype=torch.float32).contiguous()
    n, d = x.shape
    lpi, ll = (torch.empty(n, dtype=torch.float32, device=x.device)
               for _ in range(2))
    with torch.cuda.device(x.device):
        code = lib.aspire_user_target(
            x.data_ptr(), n, d, consts.data_ptr(), lpi.data_ptr(),
            ll.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    user_target_launches.count += 1
    check(code, "user target")
    return lpi, ll
