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
import math

import torch

from ..flows.architectures import Coupling
from ..models.targets import target_densities
from . import fused_coupling as FC
from ._build import LaunchCounter, check, load_library

# The chain kernel's weight layout is the tensor-core pass's it shares with
# the coupling kernel (csrc/coupling_mma.cuh), under the chain's names.
from .fused_coupling import mma_conditioner_plain as chain_conditioner_plain
from .fused_coupling import mma_group as chain_group
from .fused_coupling import mma_layout as chain_layout
from .fused_coupling import mma_sections as chain_sections
from .fused_coupling import prepare_mma_params as prepare_chain_params

TILE = 256
KERNELS = {"tpcn": 0, "pcn": 1, "rwmh": 2}
#: configuration ids the chain kernel is compiled for (ASPIRE_CHAIN_CONFIGS)
CHAIN_CONFIGS = {0, 2}
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

launches = LaunchCounter()


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
# The plain version
# ---------------------------------------------------------------------------


def chain_plain(cfg: ChainConfig, params: dict, z0: torch.Tensor, beta,
                step0: torch.Tensor, ref_mean, ref_chol, ref_ichol,
                target, data_transform=None, noise=None, seed=None,
                return_acc_probs: bool = False):
    """The whole chain in torch, tile by tile in lockstep.

    ``target`` is ``(id, constants)`` of an in-kernel target;
    ``data_transform`` is ``(mean, std)`` of the affine data transform or
    None. Uniforms come from ``noise`` (``(n_steps, rows, n)``) when given,
    else from :func:`philox_uniforms` with ``seed``. Returns ``(z, lq, lpi,
    ll, n_accept, step_sizes (n_tiles,), stats (n_tiles, 4d + 1))``, plus
    the per-step acceptance probabilities when ``return_acc_probs``.
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

    def tempered(x):
        if data_transform is None:
            xf, dt_lj = x, 0.0
        else:
            mean, std = data_transform
            xf = (x - mean) / std
            dt_lj = -torch.sum(torch.log(torch.abs(std)))
        z, ld = arch.forward_plain(params, xf)
        lq = (-0.5 * torch.sum(z * z, dim=-1) - d * _HALF_LOG_2PI + ld
              + dt_lj)
        lpi, ll = target_densities(target_id, consts, x)
        lp = _neg_inf_if_nan((1.0 - beta) * lq + beta * (ll + lpi))
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


def kernel_supports(cfg: ChainConfig) -> bool:
    """Whether the chain kernel is compiled for this flow configuration."""
    arch = cfg.arch
    return (isinstance(arch, Coupling) and len(arch.n_hidden) == 2
            and FC.config_id(arch) in CHAIN_CONFIGS
            and cfg.kernel in KERNELS)


def chain_consts(size: int, d: int, ref_mean, ref_chol, ref_ichol,
                 data_transform, consts) -> torch.Tensor:
    """The kernel's constant block of ``size`` floats (the library's
    ``aspire_consts_floats(d)``): reference mean, Cholesky factor and its
    inverse, data-transform mean and std, target constants, zero-padded."""
    if size < 0:
        raise ValueError(f"no chain kernel compiled for d={d}")
    dev = ref_mean.device
    if data_transform is None:
        dt = [torch.zeros(d, device=dev), torch.ones(d, device=dev)]
    else:
        dt = [data_transform[0].reshape(d), data_transform[1].reshape(d)]
    parts = [ref_mean.reshape(d), ref_chol.reshape(-1),
             ref_ichol.reshape(-1), *dt, consts.reshape(-1)]
    flat = torch.cat([p.to(device=dev, dtype=torch.float32) for p in parts])
    if flat.numel() > size:
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
def _chain_library_layout(cfg: int) -> tuple[int, ...]:
    """The loaded library's layout of chain configuration ``cfg``
    (``aspire_chain_layout``), read once per process."""
    lib = load_library()
    out = (ctypes.c_int * 16)()
    count = lib.aspire_chain_layout(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"chain configuration {cfg} has no layout table")
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
                   target, data_transform=None, noise=None):
    """Run the whole chain: the kernel on a CUDA tensor, the plain version
    (:func:`chain_plain`) on a CPU tensor. Same returns as ``chain_plain``.

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
                           noise=noise, seed=seed)
    if not z0.is_cuda:
        raise ValueError(f"unsupported device {z0.device}")
    lib = load_library()
    arch = cfg.arch
    n, d = z0.shape
    if not kernel_supports(cfg):
        raise ValueError(f"no chain kernel compiled for {arch}/{cfg.kernel}")
    if z0.dtype != torch.float32 or not z0.is_contiguous():
        raise TypeError("the chain kernel takes a contiguous float32 z0")
    if d != arch.dims or n % TILE or lib.aspire_chain_tile() != TILE:
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
    if _chain_library_layout(FC.config_id(arch)) != layout:
        raise RuntimeError("chain weight layout disagrees with the kernel "
                           "library")
    weights = FC.packed_coupling_params(arch, params)
    smem = chain_shared_bytes(arch, lib.aspire_consts_floats(d))
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(f"chain kernel needs {smem} bytes of shared memory")
    target_id, tconsts = target
    consts = chain_consts(lib.aspire_consts_floats(d), d, ref_mean,
                          ref_chol, ref_ichol, data_transform, tconsts)
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
    code = lib.aspire_chain(
        z0.data_ptr(), weights.data_ptr(), consts.data_ptr(),
        step0.data_ptr(), noise.data_ptr() if noise is not None else None,
        z.data_ptr(), lq.data_ptr(), lpi.data_ptr(), ll.data_ptr(),
        nacc.data_ptr(), stats.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        n, arch.n_layers, cfg.n_steps, KERNELS[cfg.kernel], cfg.gamma_m,
        cfg.gamma_odd, cfg.noise_rows, 0 if data_transform is None else 1,
        int(target_id), beta_dev.data_ptr(), float(cfg.nu),
        float(cfg.target_acceptance), float(cfg.adaptation_rate),
        float(cfg.max_log_step), float(arch.tail_bound), seed_dev.data_ptr(),
        FC.config_id(arch), torch.cuda.current_stream(z0.device).cuda_stream,
    )
    launches.count += 1
    check(code, "chain kernel")
    return z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats
