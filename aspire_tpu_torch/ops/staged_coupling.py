"""The coupling density pass over tiles of particles, in the three
schedules of the TPU prototypes in ``benchmarks/dev/`` (D1-D3).

Counterpart of ``interleave_ab.py::_interleaved_kernel`` (D1),
``quad_interleave_ab.py::_q_kernel`` (D2) and ``packed_ab.py::
_packed_kernel`` (D3, optionally with its ``rqs_micro`` spline). All three
compute the density pass of a coupling flow (data -> latent, the
transformer inverse per active dim, log-dets summed), the function of
``Coupling.forward_plain``; they differ in schedule:

- D2 splits a tile of ``q * s`` particles into ``q`` sub-tiles of ``s``,
  and sub-tile ``i`` runs layer ``stage - i``; D1 is its ``q = 2``
  instance;
- D3 takes two sub-tiles one layer apart, and each dense level of both is
  ONE product: layer ``l``'s weights over sub-tile A and layer ``l - 1``'s
  over sub-tile B.

:func:`staged_plain` and :func:`paired_plain` run those schedules in torch
(a ragged last tile is padded and cut). On a CUDA tensor the wrappers
launch ``csrc/staged_coupling.cu``, every schedule on the tensor cores with
the coupling kernel's packed weights
(``fused_coupling.packed_coupling_params``, packed once per parameter set);
D3's pair is a warp's two 16-row tiles (sub-tiles of 16). On a CPU tensor
they run the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..flows.architectures import Coupling, coupling_masks
from ..flows.bijectors import (
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    rational_quadratic_spline,
    softplus,
)
from ..flows.nets import apply_mlp
from . import fused_coupling as FC
from ._build import LaunchCounter, check, load_library

#: (dims, n_hidden, num_bins, q, s, paired, micro) of each configuration
#: id compiled into the library; mirrors ASPIRE_STAGED_CONFIGS in
#: csrc/common.cuh. ``s`` is :func:`sub_tile` of the row.
STAGED_CONFIGS = {
    0: (4, (64, 64), 8, 2, 128, False, False),
    1: (4, (64, 64), 8, 3, 80, False, False),
    2: (4, (64, 64), 8, 4, 64, False, False),
    3: (4, (64, 64), 8, 8, 32, False, False),
    4: (4, (64, 64), 8, 2, 16, True, False),
    5: (4, (64, 64), 8, 2, 16, True, True),
}

#: Q values of the D2 kernels compiled into the library (the dev sweep's).
COMPILED_Q = tuple(sorted({row[3] for row in STAGED_CONFIGS.values()
                           if not row[5]}))

interleaved_launches = LaunchCounter()
q_launches = LaunchCounter()
packed_launches = LaunchCounter()


def buffer_floats(arch, paired: bool) -> int:
    """Shared floats per particle of a sub-tile (h1 and h2 stay in
    registers): D1/D2's (csrc MmaStagedBuffers) the coordinates, the
    particle's row of transformer parameters (the coupling kernel's
    warp-buffer row, ``mma_layout``'s row stride) and two log-det partial
    sums; D3's the row alone (its coordinates and log-dets stay in
    registers too)."""
    row = FC.mma_layout(arch)[7]
    return row if paired else arch.dims + row + 2


#: Most threads of a block: each then keeps 128 of an SM's 65,536
#: registers, which hold a warp's accumulators and fragments unspilled.
MMA_BLOCK_THREADS = 512


def paired_warps(arch) -> int:
    """Warps of a D3 block: as many as fit their buffers (two sub-tiles of
    16) beside every layer's weights in one block's shared memory, at most
    ``MMA_BLOCK_THREADS / 32`` (csrc kPairedWarps); 0 where the weights
    leave room for none."""
    room = FC.MAX_SHARED_BYTES - 4 * arch.n_layers * FC.mma_layout(arch)[0]
    return max(0, min(room // (4 * 2 * 16 * buffer_floats(arch, True)),
                      MMA_BLOCK_THREADS // 32))


def sub_tile(arch, q: int, paired: bool = False) -> int:
    """Particles per sub-tile: D3's a warp's 16-row tile; for D1/D2 the
    most, a multiple of 16 (at least 16), for which ``q`` sub-tiles'
    buffers fit beside every layer's packed weights in one block's shared
    memory with at most ``MMA_BLOCK_THREADS`` threads in the block (2S a
    sub-tile), which binds first: their buffers hold no hidden layer."""
    if paired:
        return 16
    room = FC.MAX_SHARED_BYTES - 4 * arch.n_layers * FC.mma_layout(arch)[0]
    most = min(room // (4 * q * buffer_floats(arch, False)),
               MMA_BLOCK_THREADS // (2 * q))
    return max(16, most // 16 * 16)


def shared_bytes(arch, q: int, paired: bool) -> int:
    """A block's shared memory: every layer's packed weights and the
    buffers of its sub-tiles of :func:`sub_tile` particles (D1/D2: ``q``;
    D3: ``q`` per warp, :func:`paired_warps` warps, at least one)."""
    tiles = max(1, paired_warps(arch)) if paired else 1
    return 4 * (arch.n_layers * FC.mma_layout(arch)[0]
                + tiles * q * sub_tile(arch, q, paired)
                * buffer_floats(arch, paired))


def staged_config(arch, q: int, paired: bool = False,
                  micro: bool = False) -> int | None:
    """The configuration id compiled for this schedule, or None."""
    if not (isinstance(arch, Coupling) and arch.transformer == "rqs"):
        return None
    key = (arch.dims, tuple(arch.n_hidden), arch.num_bins, q,
           sub_tile(arch, q, paired), paired, micro)
    for cid, row in STAGED_CONFIGS.items():
        if row == key:
            return cid
    return None


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def rqs_micro(inputs, raw_params, num_bins: int, tail_bound: float = 5.0,
              inverse: bool = False):
    """``packed_ab.py::rqs_micro`` on the port's layout (raw parameters
    ``(..., 3K - 1)``): the RQS of ``rational_quadratic_spline`` with the
    bin softmax taken without its max subtraction (``exp(min(r, 60))``)
    and the minimum bin width folded into the ``2 * tail_bound`` scale.

    The same function in exact arithmetic, but not in float32 where every
    raw width or height of a row is below about -87: ``exp`` leaves the
    normal range (precision is lost in the denormals), and below about
    -104 it underflows to 0 and the row normalises 0 / 0 (NaN).
    """
    K, tb = num_bins, tail_bound

    def softmax_noclamp(r):
        e = torch.exp(torch.clamp(r, max=60.0))
        return e / e.sum(-1, keepdim=True)

    c0 = 2 * tb * DEFAULT_MIN_BIN_WIDTH
    c1 = 2 * tb * (1 - DEFAULT_MIN_BIN_WIDTH * K)
    w_scaled = c0 + c1 * softmax_noclamp(raw_params[..., :K])
    h_scaled = c0 + c1 * softmax_noclamp(raw_params[..., K:2 * K])
    x_lo = torch.cumsum(w_scaled, -1) - tb - w_scaled
    y_lo = torch.cumsum(h_scaled, -1) - tb - h_scaled
    dp = DEFAULT_MIN_DERIVATIVE + softplus(raw_params[..., 2 * K:])
    ones = torch.ones_like(dp[..., :1])
    d_right = torch.cat([dp, ones], -1)
    d_left = torch.cat([ones, dp], -1)
    inside = (inputs > -tb) & (inputs < tb)
    safe = torch.clamp(inputs, -tb, tb)
    lo = y_lo if inverse else x_lo
    k = torch.sum(safe[..., None] >= lo, dim=-1) - 1
    k = torch.clamp(k, 0, K - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, k)[..., 0]

    x_k, y_k, w, h = take(x_lo), take(y_lo), take(w_scaled), take(h_scaled)
    d_k, d_k1 = take(d_left), take(d_right)
    s = h / w
    t = d_k1 + d_k - 2 * s
    if not inverse:
        xi = torch.clamp((safe - x_k) / w, 0.0, 1.0)
        xi_1m = 1 - xi
        den = s + t * xi * xi_1m
        outputs = y_k + h * (s * xi**2 + d_k * xi * xi_1m) / den
        sign = 1.0
    else:
        y_rel = safe - y_k
        a = h * (s - d_k) + y_rel * t
        b = h * d_k - y_rel * t
        c = -s * y_rel
        disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
        xi = torch.clamp((2 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
        xi_1m = 1 - xi
        den = s + t * xi * xi_1m
        outputs = xi * w + x_k
        sign = -1.0
    log_det = sign * (
        2 * torch.log(s)
        + torch.log(d_k1 * xi**2 + 2 * s * xi * xi_1m + d_k * xi_1m**2)
        - 2 * torch.log(den)
    )
    outputs = torch.where(inside, outputs, inputs)
    log_det = torch.where(inside, log_det, torch.zeros_like(log_det))
    return outputs, log_det


def _check_arch(arch) -> None:
    if not (isinstance(arch, Coupling) and arch.transformer == "rqs"):
        raise ValueError(f"the staged coupling pass takes an RQS coupling "
                         f"flow, got {arch}")


def _subtiles(x: torch.Tensor, q: int, s: int):
    """The ``q`` sub-tiles of every tile of ``q * s`` rows, each flattened
    over the tiles: ``q`` tensors ``(n_tiles * s, d)``; the last tile is
    padded with zeros."""
    n, d = x.shape
    n_tiles = -(-n // (q * s))
    padded = x.new_zeros((n_tiles * q * s, d))
    padded[:n] = x
    tiles = padded.reshape(n_tiles, q, s, d)
    return [tiles[:, i].reshape(-1, d) for i in range(q)]


def _join(subs: list, lds: list, n: int, s: int):
    """Inverse of :func:`_subtiles` for the outputs, cut to ``n`` rows."""
    d = subs[0].shape[-1]
    z = torch.stack([t.reshape(-1, s, d) for t in subs], 1).reshape(-1, d)
    ld = torch.stack([t.reshape(-1, s) for t in lds], 1).reshape(-1)
    return z[:n], ld[:n]


def _spline(arch, x, raw, mask, micro: bool):
    """The transformer inverse of the active dims of ``x`` given the
    conditioner output ``raw`` (``(m, dims * P)``); summed log-dets."""
    h = raw.reshape(x.shape[0], arch.dims, arch.n_params_per_dim)
    fn = rqs_micro if micro else rational_quadratic_spline
    y, eld = fn(x, h, arch.num_bins, arch.tail_bound, inverse=True)
    y = torch.where(mask, x, y)
    eld = torch.where(mask, torch.zeros_like(eld), eld)
    return y, eld.sum(-1)


def staged_plain(arch, params: dict, x: torch.Tensor, q: int, s: int):
    """D2's schedule (D1 at ``q = 2``): per tile of ``q * s`` particles,
    sub-tile ``i`` runs layer ``stage - i`` at stage ``0 .. L + q - 2``."""
    _check_arch(arch)
    L = arch.n_layers
    masks = coupling_masks(arch.dims, L, x.device)
    subs = _subtiles(x, q, s)
    lds = [x.new_zeros(t.shape[0]) for t in subs]
    for stage in range(L + q - 1):
        for i in range(q):
            layer = stage - i
            if 0 <= layer < L:
                m = masks[layer]
                raw = apply_mlp(params["layers"][layer],
                                torch.where(m, subs[i], torch.zeros_like(subs[i])))
                subs[i], e = _spline(arch, subs[i], raw, m, micro=False)
                lds[i] = lds[i] + e
    return _join(subs, lds, x.shape[0], s)


def _paired_mlp(nets: list, hs: list) -> torch.Tensor:
    """The conditioners of one or two sub-tiles, each dense level one
    batched product of the layers' stacked, unpadded weights."""
    h = torch.stack(hs)
    n_dense = len(nets[0]["layers"])
    for j in range(n_dense):
        w = torch.stack([net["layers"][j]["w"] for net in nets])
        b = torch.stack([net["layers"][j]["b"] for net in nets])
        h = torch.baddbmm(b[:, None, :], h, w)
        if j < n_dense - 1:
            h = torch.relu(h)
    return h


def paired_plain(arch, params: dict, x: torch.Tensor, s: int,
                 micro: bool = False):
    """D3's schedule: per tile two sub-tiles of ``s``; at stage ``0 .. L``
    sub-tile A runs layer ``stage`` and B layer ``stage - 1``, both
    conditioners as one product per dense level. ``micro`` swaps in
    :func:`rqs_micro`."""
    _check_arch(arch)
    L = arch.n_layers
    masks = coupling_masks(arch.dims, L, x.device)
    subs = _subtiles(x, 2, s)
    lds = [x.new_zeros(t.shape[0]) for t in subs]
    for stage in range(L + 1):
        live = [(i, stage - i) for i in (0, 1) if 0 <= stage - i < L]
        raw = _paired_mlp(
            [params["layers"][layer] for _, layer in live],
            [torch.where(masks[layer], subs[i], torch.zeros_like(subs[i]))
             for i, layer in live])
        for r, (i, layer) in zip(raw, live):
            subs[i], e = _spline(arch, subs[i], r, masks[layer], micro)
            lds[i] = lds[i] + e
    return _join(subs, lds, x.shape[0], s)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _launch(counter: LaunchCounter, arch, weights: torch.Tensor,
            x: torch.Tensor, q: int, paired: bool, micro: bool):
    """The library's one entry point ``aspire_staged`` at the configuration
    of this schedule; ``counter`` is the variant's launch count."""
    cfg = staged_config(arch, q, paired, micro)
    if cfg is None:
        raise ValueError(f"no staged coupling kernel compiled for {arch} at "
                         f"q={q}, paired={paired}, micro={micro}")
    if not x.is_cuda:
        raise ValueError(f"the staged coupling kernel takes CUDA tensors, "
                         f"got {x.device}")
    lib = load_library()
    s = sub_tile(arch, q, paired)
    row = (ctypes.c_int * 10)()
    if lib.aspire_staged_config(cfg, row) != 0 or tuple(row[:8]) != (
            arch.dims, *arch.n_hidden, arch.num_bins, q, s, int(paired),
            int(micro)) or row[9] != s * buffer_floats(arch, paired):
        raise RuntimeError("staged configuration table disagrees with the "
                           "kernel library")
    layer = FC.mma_layout(arch)[0]
    FC._check_launch(lib, "staged coupling kernel", arch, weights, x, row[8],
                     layer, shared_bytes(arch, q, paired))
    if weights.numel() != arch.n_layers * layer or weights.data_ptr() % 16:
        raise ValueError(f"weights are not a 16-byte aligned packing of "
                         f"{arch} for this schedule")
    n = x.shape[0]
    z = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    code = lib.aspire_staged(
        x.data_ptr(), z.data_ptr(), ld.data_ptr(), weights.data_ptr(), n,
        arch.n_layers, float(arch.tail_bound), cfg,
        torch.cuda.current_stream(x.device).cuda_stream)
    counter.count += 1
    check(code, "staged coupling kernel")
    return z, ld


def launch_interleaved(arch, weights: torch.Tensor, x: torch.Tensor):
    """D1 on a CUDA ``x``, weights packed by
    ``fused_coupling.prepare_mma_params``."""
    return _launch(interleaved_launches, arch, weights, x, 2, False, False)


def launch_q(arch, weights: torch.Tensor, x: torch.Tensor, q: int):
    """D2 with ``q`` sub-tiles on a CUDA ``x``, weights as D1's."""
    return _launch(q_launches, arch, weights, x, q, False, False)


def launch_packed(arch, weights: torch.Tensor, x: torch.Tensor,
                  micro: bool = False):
    """D3 (with ``rqs_micro`` if ``micro``) on a CUDA ``x``, weights as
    D1's."""
    return _launch(packed_launches, arch, weights, x, 2, True, micro)


def interleaved_apply(arch, params: dict, x: torch.Tensor):
    """D1: the density pass over two sub-tiles per tile."""
    if x.device.type == "cpu":
        return staged_plain(arch, params, x, 2, sub_tile(arch, 2))
    return launch_interleaved(arch, FC.packed_coupling_params(arch, params),
                              x.contiguous())


def q_apply(arch, params: dict, x: torch.Tensor, q: int):
    """D2: the density pass over ``q`` sub-tiles per tile."""
    if x.device.type == "cpu":
        return staged_plain(arch, params, x, q, sub_tile(arch, q))
    return launch_q(arch, FC.packed_coupling_params(arch, params),
                    x.contiguous(), q)


def packed_apply(arch, params: dict, x: torch.Tensor, micro: bool = False):
    """D3: the density pass over two sub-tiles one layer apart, one product
    per dense level; ``micro`` swaps in :func:`rqs_micro`."""
    if x.device.type == "cpu":
        return paired_plain(arch, params, x, sub_tile(arch, 2, True),
                            micro)
    return launch_packed(arch, FC.packed_coupling_params(arch, params),
                         x.contiguous(), micro)
