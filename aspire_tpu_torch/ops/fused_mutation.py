"""Wrapper for the CUDA whole-chain Metropolis kernel, and its plain version.

Counterpart of ``aspire_tpu/ops/fused_mutation.py``. One launch of the
kernel (``csrc/chain.cu``) runs an entire k-step tpCN / pCN / RWMH chain;
each 256-particle tile adapts its own step size. The kernel runs the flow's
conditioner products on the tensor cores, 32 particles per warp; this
module packs its weights for that (:func:`prepare_chain_params`: mma
fragments of split-TF32 weights), checks the packing against the
library's and launches. :func:`chain_plain` is the same algorithm in
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

TILE = 256
KERNELS = {"tpcn": 0, "pcn": 1, "rwmh": 2}
#: configuration ids the chain kernel is compiled for (ASPIRE_CHAIN_CONFIGS)
CHAIN_CONFIGS = {0}
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
# The kernel's weight layout (csrc/chain.cu ChainShape)
# ---------------------------------------------------------------------------


def chain_group(arch) -> int:
    """Floats per active dim's spline parameter group: ``3K - 1`` rounded
    up to 8, the width of the kernel's mma n-tiles."""
    return -(-arch.n_params_per_dim // 8) * 8


def chain_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed chain buffer, in order, with
    their shapes: W1 ``(H1, D/2)`` of the conditioning inputs, b1, W2 as
    ``(H1/8 * H2/8, 32, 2)`` mma B fragments, b2, W3 as
    ``(H2/8 * D/2 * G/8, 32, 2)`` fragments, b3 ``(D/2, G)``."""
    h1, h2 = tuple(arch.n_hidden)
    half, g = arch.dims // 2, chain_group(arch)
    return [("w1", (h1, half)), ("b1", (h1,)),
            ("w2", (h1 // 8 * (h2 // 8), 32, 2)), ("b2", (h2,)),
            ("w3", (h2 // 8 * (half * g // 8), 32, 2)), ("b3", (half, g))]


@functools.lru_cache(maxsize=None)
def chain_layout(arch) -> tuple[int, ...]:
    """The layout as the library reports it (``aspire_chain_layout``):
    floats per layer, the offset of each section, then the row stride and
    the floats of a warp's buffer of spline parameters (32 rows)."""
    offsets, off = [], 0
    for _, shape in chain_sections(arch):
        off = FC._round4(off)
        offsets.append(off)
        off += int(torch.Size(shape).numel())
    row = arch.dims // 2 * chain_group(arch) + 4
    return (FC._round4(off), *offsets, row, 32 * row)


@functools.lru_cache(maxsize=None)
def _fragments(k_in: int, n_out: int, device: torch.device):
    """(row, column) of every entry of the mma B fragments of a
    ``(k_in, n_out)`` matrix, each a ``(k_in/8 * n_out/8, 32, 2)`` index
    tensor on ``device`` (kept, so a packing copies no index to the card):
    lane ``4g + t`` of the fragment of k-step ``s`` and n-tile ``j`` (at
    ``s * n_out/8 + j``) holds rows ``8s + 2t`` and ``8s + 2t + 1`` of
    column ``8j + g`` (the k order that lets one product's accumulator
    serve as the next one's A fragment)."""
    lane = torch.arange(32)
    rows = 2 * (lane % 4)[:, None] + torch.arange(2)[None, :]
    cols = (lane // 4)[:, None].expand(32, 2)
    tiles = [(s, j) for s in range(k_in // 8) for j in range(n_out // 8)]
    return (torch.stack([8 * s + rows for s, _ in tiles]).to(device),
            torch.stack([8 * j + cols for _, j in tiles]).to(device))


def _layer_dims(layer: int) -> tuple[slice, slice]:
    """(active, conditioning) dims of coupling layer ``layer``, as slices:
    views, so a packing on the card copies no index to it."""
    odd = layer % 2
    return slice(odd, None, 2), slice(1 - odd, None, 2)


def _dense_layer(arch, layer: int, net: dict):
    """One layer's conditioner as the kernel computes it: W1 ``(H1, D/2)``
    on the conditioning inputs, b1, W2 ``(H1, H2)``, b2, W3
    ``(H2, D/2 * G)`` and b3 ``(D/2, G)`` of the active dims' parameter
    groups, each zero-padded to G."""
    d, P, G = arch.dims, arch.n_params_per_dim, chain_group(arch)
    active, cond = _layer_dims(layer)
    l1, l2, l3 = net["layers"]
    h2 = l3["w"].shape[0]
    pad = torch.nn.functional.pad
    w3 = pad(l3["w"].reshape(h2, d, P)[:, active], (0, G - P))
    b3 = pad(l3["b"].reshape(d, P)[active], (0, G - P))
    return (l1["w"][cond].t(), l1["b"], l2["w"], l2["b"],
            w3.reshape(h2, -1), b3)


def prepare_chain_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's conditioner into the chain kernel's flat layout
    (:func:`chain_sections`), in the parameters' dtype: W2 and W3 as mma B
    fragments, in float32 each weight the sum of two TF32 values
    (:func:`~.fused_coupling.split_tf32_sum`, so the kernel splits it
    exactly); float64 parameters (tests of the layout) are kept as they
    are."""
    if arch.dims % 2 or arch.transformer != "rqs":
        raise ValueError(f"the chain kernel takes an even-d spline flow: {arch}")
    h1, h2 = tuple(arch.n_hidden)
    dev = params["layers"][0]["layers"][0]["w"].device
    (r2, c2), (r3, c3) = (
        _fragments(h1, h2, dev),
        _fragments(h2, arch.dims // 2 * chain_group(arch), dev))
    chunks = []
    for layer, net in enumerate(params["layers"]):
        w1, b1, w2, b2, w3, b3 = _dense_layer(arch, layer, net)
        w2, w3 = w2[r2, c2], w3[r3, c3]
        if w2.dtype == torch.float32:
            w2, w3 = FC.split_tf32_sum(w2), FC.split_tf32_sum(w3)
        FC._append_sections(chunks, [w1, b1, w2, b2, w3, b3])
    return FC._concat(chunks, arch.n_layers * chain_layout(arch)[0], arch,
                      chunks[0].dtype)


def chain_conditioner_plain(arch, packed: torch.Tensor, layer: int,
                            x: torch.Tensor) -> torch.Tensor:
    """The ``(n, D/2, 3K - 1)`` spline parameters that layer ``layer``'s
    conditioner gives the active dims of ``x``, read from the kernel's
    packed buffer the way the kernel reads it: W1 on the conditioning
    inputs, the fragments gathered back into W2 and W3, each active dim's
    padded group cut to its parameters. For tests of the layout: no kernel
    path calls it."""
    h1, h2 = tuple(arch.n_hidden)
    half, G = arch.dims // 2, chain_group(arch)
    buf = packed.reshape(arch.n_layers, -1)[layer]
    sec = {name: buf[off:off + int(torch.Size(shape).numel())].reshape(shape)
           for (name, shape), off in zip(chain_sections(arch),
                                         chain_layout(arch)[1:7])}
    for name, k_in, n_out in (("w2", h1, h2), ("w3", h2, half * G)):
        rows, cols = _fragments(k_in, n_out, buf.device)
        dense = buf.new_zeros((k_in, n_out))
        dense[rows, cols] = sec[name]
        sec[name] = dense
    _, cond = _layer_dims(layer)
    h = torch.relu(x[:, cond] @ sec["w1"].t() + sec["b1"])
    h = torch.relu(h @ sec["w2"] + sec["b2"])
    out = h @ sec["w3"] + sec["b3"].reshape(-1)
    return out.reshape(-1, half, G)[:, :, :arch.n_params_per_dim]


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


def fused_mh_chain(cfg: ChainConfig, params: dict, z0: torch.Tensor, beta,
                   seed, step0: torch.Tensor, ref_mean, ref_chol, ref_ichol,
                   target, data_transform=None, noise=None):
    """Run the whole chain: the kernel on a CUDA tensor, the plain version
    (:func:`chain_plain`) on a CPU tensor. Same returns as ``chain_plain``.

    ``seed`` is a pair of 32-bit integers (ignored with ``noise``); ``step0``
    the ``(n_tiles,)`` initial step sizes.
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
    weights = prepare_chain_params(arch, params)
    warps = TILE // 32
    smem = 4 * (weights.numel() + lib.aspire_consts_floats(d) + 2 * warps
                + warps * layout[-1])
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(f"chain kernel needs {smem} bytes of shared memory")
    target_id, tconsts = target
    consts = chain_consts(lib.aspire_consts_floats(d), d, ref_mean,
                          ref_chol, ref_ichol, data_transform, tconsts)
    z = torch.empty_like(z0)
    lq, lpi, ll, nacc = (torch.empty(n, dtype=torch.float32,
                                     device=z0.device) for _ in range(4))
    stats = torch.empty((nt, 4 * d + 1), dtype=torch.float32,
                        device=z0.device)
    code = lib.aspire_chain(
        z0.data_ptr(), weights.data_ptr(), consts.data_ptr(),
        step0.data_ptr(), noise.data_ptr() if noise is not None else None,
        z.data_ptr(), lq.data_ptr(), lpi.data_ptr(), ll.data_ptr(),
        nacc.data_ptr(), stats.data_ptr(),
        n, arch.n_layers, cfg.n_steps, KERNELS[cfg.kernel], cfg.gamma_m,
        cfg.gamma_odd, cfg.noise_rows, 0 if data_transform is None else 1,
        int(target_id), float(beta), float(cfg.nu),
        float(cfg.target_acceptance), float(cfg.adaptation_rate),
        float(cfg.max_log_step), float(arch.tail_bound),
        int(seed[0]) & _MASK if seed is not None else 0,
        int(seed[1]) & _MASK if seed is not None else 0,
        FC.config_id(arch), torch.cuda.current_stream(z0.device).cuda_stream,
    )
    launches.count += 1
    check(code, "chain kernel")
    return z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats
