"""Wrappers for the CUDA flow kernels: the coupling flow (density and
sampling passes) and the MAF-RQS density pass.

Counterpart of ``aspire_tpu/ops/fused_coupling.py``. Both kernels run the
conditioner's two wide products on the tensor cores in split TF32: the
coupling kernel (``csrc/coupling.cu``) 32 particles per warp with the
weights streamed through shared memory one layer at a time (or, for a
shape too wide for that, :func:`mma_wide`, in chunks of a layer), in the
packed layout it shares with the whole-chain kernel (``csrc/chain.cu``,
:func:`prepare_mma_params`); the MAF kernel (``csrc/maf.cu``) 16
particles per warp with all layers' weights in shared memory, over the
blocks its MADE masks keep (:func:`prepare_maf_params`, in degree order).
This module packs those weights (once per parameter set), checks the
packing against the library's and launches, counts launches, and wraps
the call in a ``torch.autograd.Function`` whose backward recomputes
through the plain torch path (the JAX package's ``custom_vjp``). The
staged coupling kernels D1-D3 (``ops/staged_coupling.py``) take the
coupling kernel's :func:`prepare_mma_params` too.

On a CPU tensor a wrapper runs the plain torch version
(``Coupling.forward_plain``/``inverse_plain``, ``MAF.forward_plain``); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..flows.architectures import MAF, Coupling
from ..flows.bijectors import (  # noqa: F401 - public, as in JAX package
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
)
from ._build import LaunchCounter, check, load_library

#: Below this batch the plain path is already launch-bound; training
#: batches stay on the plain autograd path (the JAX package's threshold).
MIN_FUSED_N = 4096

#: (transformer, dims, n_hidden, num_bins) -> configuration id compiled
#: into the library; mirrors ASPIRE_COUPLING_CONFIGS in csrc/common.cuh
#: (hidden widths multiples of 8; an odd d pads each half of a layer to
#: (d + 1) // 2 dims). Configuration 2 is BASELINE config 5's flow (nsf,
#: 6 x (128, 128) at d = 32): depth is no part of the key; 3 and 4 are
#: nsf-tpu at d = 2 and d = 5, the JAX package's validation rows.
KERNEL_CONFIGS = {
    ("rqs", 4, (64, 64), 8): 0,
    ("affine", 4, (64, 64), None): 1,
    ("rqs", 32, (128, 128), 8): 2,
    ("rqs", 2, (64, 64), 8): 3,
    ("rqs", 5, (64, 64), 8): 4,
}

#: The most dims a compiled coupling configuration takes (the JAX
#: package's bound on fusing a coupling flow).
MAX_FUSED_DIMS = max(key[1] for key in KERNEL_CONFIGS)

#: (dims, n_hidden, num_bins) of an RQS MAF -> configuration id of the MAF
#: density kernel; mirrors ASPIRE_MAF_CONFIGS in csrc/common.cuh. A table
#: of its own, so a MAF is never packed for the coupling kernel.
MAF_KERNEL_CONFIGS = {
    (4, (64, 64), 8): 0,
}

#: Shared memory one block may hold on an H100 (227 KB).
MAX_SHARED_BYTES = 232448

#: Most warps in a block of the coupling kernel (kCouplingWarps).
COUPLING_WARPS = 8

launches = LaunchCounter()
#: the coupling kernel's launches in sampling mode (B3) alone, also
#: counted in ``launches``
sampling_launches = LaunchCounter()
maf_launches = LaunchCounter()


def config_id(arch) -> int | None:
    if not isinstance(arch, Coupling):
        return None
    bins = arch.num_bins if arch.transformer == "rqs" else None
    return KERNEL_CONFIGS.get(
        (arch.transformer, arch.dims, tuple(arch.n_hidden), bins)
    )


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _packed_floats(sections) -> int:
    """Floats of one packed layer whose sections (given by their sizes)
    each start on a multiple of 4 floats."""
    size = 0
    for section in sections:
        size = _round4(size) + section
    return _round4(size)


def mma_weight_buffers(arch) -> int:
    """Floats of a block's weight buffers in the tensor-core pass: two
    whole layers, or in the wide form two resident parts and two chunks
    (neither grows with depth)."""
    size, *_, stage, res, chunk = mma_layout(arch)
    return 2 * (res + chunk) if mma_wide(arch) else 2 * size


def coupling_shared_bytes(arch) -> int:
    """Shared memory of a coupling kernel block at its most warps: its
    weight buffers (:func:`mma_weight_buffers`) and a warp buffer per
    warp."""
    return 4 * (mma_weight_buffers(arch)
                + COUPLING_WARPS * mma_layout(arch)[8])


def should_fuse(arch, x: torch.Tensor) -> bool:
    """True when the CUDA kernel applies to this (architecture, batch)."""
    return (
        x.is_cuda
        and x.dim() == 2
        and x.shape[0] >= MIN_FUSED_N
        and x.dtype == torch.float32
        and len(arch.n_hidden) == 2
        and config_id(arch) is not None
        and coupling_shared_bytes(arch) <= MAX_SHARED_BYTES
    )


def _append_sections(chunks: list, sections: list) -> None:
    """Append one layer's sections, each starting on a multiple of 4
    floats, and pad the layer to a multiple of 4."""
    size = 0
    for s in sections:
        pad = _round4(size) - size
        if pad:
            chunks.append(s.new_zeros(pad))
        chunks.append(s.reshape(-1))
        size = _round4(size) + s.numel()
    tail = _round4(size) - size
    if tail:
        chunks.append(sections[0].new_zeros(tail))


def _concat(chunks: list, floats: int, arch,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    out = torch.cat(chunks).to(dtype).contiguous()
    if out.numel() != floats:
        raise ValueError(f"parameters do not match {arch}")
    return out


def _check_launch(lib, what: str, arch, weights: torch.Tensor,
                  x: torch.Tensor, layer_floats_lib: int,
                  layer_floats_py: int, smem: int | None = None) -> None:
    """Refuse what a flow kernel does not take, before launching it
    (``smem``: the block's shared bytes, by default the weights')."""
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"the {what} takes float32 only")
    if x.dim() != 2 or x.shape[1] != arch.dims:
        raise ValueError(f"expected (n, {arch.dims}) input, got {tuple(x.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"the {what} takes contiguous tensors")
    if weights.device != x.device:
        raise ValueError("weights and input must be on the same device")
    smem = 4 * weights.numel() if smem is None else smem
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(
            f"flow weights ({smem} bytes) exceed one block's shared memory"
        )
    if layer_floats_lib != layer_floats_py:
        raise RuntimeError("packed layout disagrees with the kernel library")


# ---------------------------------------------------------------------------
# The tensor-core layout of the coupling kernel and the whole-chain kernel
# (csrc/coupling_mma.cuh MmaShape)
# ---------------------------------------------------------------------------


def mma_group(arch) -> int:
    """Floats per active dim's transformer parameter group: ``3K - 1``
    (spline) or 2 (affine) rounded up to 8, the width of the kernel's mma
    n-tiles."""
    return -(-arch.n_params_per_dim // 8) * 8


#: Active dims per output group of the wide form (MmaShape::GD).
WIDE_GROUP_DIMS = 2


def mma_half(arch) -> int:
    """Dims in each half of a coupling layer (MmaShape::A and C):
    ``(d + 1) // 2``; at an odd d the last slot of an odd layer's active
    half and of an even layer's conditioning half is a padding slot, dim
    d, with zero weights."""
    return (arch.dims + 1) // 2


def _mma_tiles(arch) -> tuple[int, int, int]:
    """(KS1, KS2, NT): W2's k-steps, W2's n-tiles (W3's k-steps) and W3's
    n-tiles."""
    h1, h2 = tuple(arch.n_hidden)
    return h1 // 8, h2 // 8, mma_half(arch) * mma_group(arch) // 8


def mma_wide(arch) -> bool:
    """Whether the shape takes the wide form (MmaShape::WIDE): even the
    output one active dim at a time leaves both row tiles' accumulators,
    ``8 * (KS2 + G/8)`` floats a thread, past 128."""
    _, ks2, _ = _mma_tiles(arch)
    return 8 * (ks2 + mma_group(arch) // 8) > 128


def _w3_group_cols(arch) -> int:
    """W3 columns per fragment group: a group of two active dims in the
    wide form, all of them otherwise."""
    half, g = mma_half(arch), mma_group(arch)
    return WIDE_GROUP_DIMS * g if mma_wide(arch) else half * g


def mma_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed buffer, in order, with their
    shapes (``half`` = :func:`mma_half`): W1 ``(H1, half)`` of the
    conditioning inputs, b1, W2 as ``(H1/8 * H2/8, 32, 2)`` mma B
    fragments, b2, W3 as ``(H2/8 * half * G/8, 32, 2)`` fragments, b3
    ``(half, G)``. The wide
    form puts the sections a layer reads throughout first (W1, b1, b2, b3)
    and then the streamed ones (W2, then W3 by groups of two active
    dims)."""
    h1, h2 = tuple(arch.n_hidden)
    half, g = mma_half(arch), mma_group(arch)
    sec = {"w1": (h1, half), "b1": (h1,),
           "w2": (h1 // 8 * (h2 // 8), 32, 2), "b2": (h2,),
           "w3": (h2 // 8 * (half * g // 8), 32, 2), "b3": (half, g)}
    order = (("w1", "b1", "b2", "b3", "w2", "w3") if mma_wide(arch) else
             ("w1", "b1", "w2", "b2", "w3", "b3"))
    return [(name, sec[name]) for name in order]


def _section_offsets(arch) -> tuple[dict, int]:
    """Each section's offset in a packed layer, and the layer's floats."""
    offsets, off = {}, 0
    for name, shape in mma_sections(arch):
        off = _round4(off)
        offsets[name] = off
        off += int(torch.Size(shape).numel())
    return offsets, _round4(off)


@functools.lru_cache(maxsize=None)
def mma_layout(arch) -> tuple[int, ...]:
    """The layout as the library reports it (``aspire_chain_layout``, the
    first entries of ``aspire_coupling_layout``): floats per layer, the
    offsets of W1, b1, W2, b2, W3 and b3, the row stride and the floats of
    a warp's buffer (whole-layer form: the transformer parameters of 32
    rows; wide form: those of one 16-row tile's group, then the warp's 32
    particles, ``D + 1`` floats apart), then the wide form's resident part
    and largest chunk (0 and 0 otherwise)."""
    offsets, size = _section_offsets(arch)
    ks1, ks2, _ = _mma_tiles(arch)
    names = ("w1", "b1", "w2", "b2", "w3", "b3")
    if not mma_wide(arch):
        row = mma_half(arch) * mma_group(arch) + 4
        return (size, *(offsets[k] for k in names), row, 32 * row, 0, 0)
    row = _w3_group_cols(arch) + 4
    kw2 = 4 if ks1 % 4 == 0 else (2 if ks1 % 2 == 0 else 1)
    kw3 = next(k for k in (8, 4, 2, 1) if ks2 % k == 0)
    chunk = max(64 * kw2 * ks2, 64 * kw3 * _w3_group_cols(arch) // 8)
    return (size, *(offsets[k] for k in names), row,
            16 * row + 32 * (arch.dims + 1), offsets["w2"], chunk)


@functools.lru_cache(maxsize=None)
def _fragments(k_in: int, n_out: int, device: torch.device,
               group: int | None = None):
    """(row, column) of every entry of the mma B fragments of a
    ``(k_in, n_out)`` matrix, each a ``(k_in/8 * n_out/8, 32, 2)`` index
    tensor on ``device`` (kept, so a packing copies no index to the card):
    lane ``4g + t`` of the fragment of k-step ``s`` and n-tile ``j`` holds
    rows ``8s + 2t`` and ``8s + 2t + 1`` of column ``8j + g`` (the k order
    that lets one product's accumulator serve as the next one's A
    fragment). The columns go by groups of ``group`` (all of them by
    default), and the fragments group by group, k-step by k-step, n-tile
    by n-tile: at ``(q * k_in/8 + s) * group/8 + j`` for n-tile ``j`` of
    group ``q``."""
    group = group or n_out
    lane = torch.arange(32)
    rows = 2 * (lane % 4)[:, None] + torch.arange(2)[None, :]
    cols = (lane // 4)[:, None].expand(32, 2)
    tiles = [(s, q * group // 8 + j) for q in range(n_out // group)
             for s in range(k_in // 8) for j in range(group // 8)]
    return (torch.stack([8 * s + rows for s, _ in tiles]).to(device),
            torch.stack([8 * j + cols for _, j in tiles]).to(device))


def _layer_dims(layer: int) -> tuple[slice, slice]:
    """(active, conditioning) dims of coupling layer ``layer``, as slices:
    views, so a packing on the card copies no index to it."""
    odd = layer % 2
    return slice(odd, None, 2), slice(1 - odd, None, 2)


def _dense_layer(arch, layer: int, net: dict):
    """One layer's conditioner as the kernel computes it, each half of
    the layer :func:`mma_half` dims (a padding slot's weights zero): W1
    ``(H1, half)`` on the conditioning inputs, b1, W2 ``(H1, H2)``, b2, W3
    ``(H2, half * G)`` and b3 ``(half, G)`` of the active dims' parameter
    groups, each zero-padded to G."""
    d, P, G = arch.dims, arch.n_params_per_dim, mma_group(arch)
    half = mma_half(arch)
    active, cond = _layer_dims(layer)
    l1, l2, l3 = net["layers"]
    h2 = l3["w"].shape[0]
    pad = torch.nn.functional.pad
    w3 = l3["w"].reshape(h2, d, P)[:, active]
    w3 = pad(w3, (0, G - P, 0, half - w3.shape[1]))
    b3 = l3["b"].reshape(d, P)[active]
    b3 = pad(b3, (0, G - P, 0, half - b3.shape[0]))
    w1 = l1["w"][cond].t()
    return (pad(w1, (0, half - w1.shape[1])), l1["b"], l2["w"], l2["b"],
            w3.reshape(h2, -1), b3)


def _mma_fragment_indices(arch, device):
    """The fragment index pairs of W2 and W3 (:func:`_fragments`)."""
    h1, h2 = tuple(arch.n_hidden)
    return (_fragments(h1, h2, device),
            _fragments(h2, mma_half(arch) * mma_group(arch), device,
                       _w3_group_cols(arch)))


def prepare_mma_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's conditioner into the tensor-core flat layout
    (:func:`mma_sections`), in the parameters' dtype: W2 and W3 as mma B
    fragments, in float32 each weight the sum of two TF32 values
    (:func:`split_tf32_sum`, so the kernel splits it exactly); float64
    parameters (tests of the layout) are kept as they are."""
    h1, h2 = tuple(arch.n_hidden)
    if h1 % 8 or h2 % 8:
        raise ValueError(f"the tensor-core pass takes a coupling flow with "
                         f"hidden widths /8: {arch}")
    dev = params["layers"][0]["layers"][0]["w"].device
    (r2, c2), (r3, c3) = _mma_fragment_indices(arch, dev)
    order = [name for name, _ in mma_sections(arch)]
    chunks = []
    for layer, net in enumerate(params["layers"]):
        w1, b1, w2, b2, w3, b3 = _dense_layer(arch, layer, net)
        w2, w3 = w2[r2, c2], w3[r3, c3]
        if w2.dtype == torch.float32:
            w2, w3 = split_tf32_sum(w2), split_tf32_sum(w3)
        sec = dict(w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
        _append_sections(chunks, [sec[name] for name in order])
    return _concat(chunks, arch.n_layers * mma_layout(arch)[0], arch,
                   chunks[0].dtype)


def mma_conditioner_plain(arch, packed: torch.Tensor, layer: int,
                          x: torch.Tensor) -> torch.Tensor:
    """The ``(n, a, P)`` transformer parameters that layer ``layer``'s
    conditioner gives the ``a`` active dims of ``x``, read from the packed
    buffer the way the kernels read it: W1 on the conditioning inputs (a
    padding slot's input 0), the fragments gathered back into W2 and W3,
    each active dim's padded group cut to its parameters (the padding
    slot's dropped). For tests of the layout: no kernel path calls it."""
    h1, h2 = tuple(arch.n_hidden)
    half, G = mma_half(arch), mma_group(arch)
    buf = packed.reshape(arch.n_layers, -1)[layer]
    offsets, _ = _section_offsets(arch)
    sec = {name: buf[offsets[name]:offsets[name]
                     + int(torch.Size(shape).numel())].reshape(shape)
           for name, shape in mma_sections(arch)}
    for name, (rows, cols), k_in, n_out in zip(
            ("w2", "w3"), _mma_fragment_indices(arch, buf.device),
            (h1, h2), (h2, half * G)):
        dense = buf.new_zeros((k_in, n_out))
        dense[rows, cols] = sec[name]
        sec[name] = dense
    active, cond = _layer_dims(layer)
    xc = x[:, cond]
    xc = torch.nn.functional.pad(xc, (0, half - xc.shape[1]))
    h = torch.relu(xc @ sec["w1"].t() + sec["b1"])
    h = torch.relu(h @ sec["w2"] + sec["b2"])
    out = h @ sec["w3"] + sec["b3"].reshape(-1)
    n_active = x[:, active].shape[1]
    return out.reshape(-1, half, G)[:, :n_active, :arch.n_params_per_dim]


def coupling_packed_plain(arch, mode: str, packed: torch.Tensor,
                          x: torch.Tensor):
    """The coupling kernel's pass computed from its packed buffer the way
    it reads it, in plain torch: layer by layer (reversed when sampling),
    :func:`mma_conditioner_plain` then the transformers of the layer's
    active dims, inverse for the density pass (``mode="forward"``). For
    tests of the layout: no kernel path calls it."""
    density = mode == "forward"
    steps = range(arch.n_layers)
    y = x.clone()
    log_det = x.new_zeros(x.shape[0])
    for layer in (steps if density else reversed(steps)):
        active, _ = _layer_dims(layer)
        raw = mma_conditioner_plain(arch, packed, layer, y)
        v, eld = arch._elementwise(y[:, active], raw, inverse=density)
        y[:, active] = v
        log_det = log_det + eld.sum(-1)
    return y, log_det


_coupling_pack_cache: dict = {}


def packed_coupling_params(arch, params: dict,
                           device: torch.device | None = None
                           ) -> torch.Tensor:
    """:func:`prepare_mma_params`, packed once per set of parameters and
    card (as :func:`packed_maf_params`): the ``n_steps + 2`` density passes
    of a split-chain mutation pack once."""
    return _pack_once(_coupling_pack_cache, prepare_mma_params, arch, params,
                      device)


@functools.lru_cache(maxsize=None)
def _coupling_library_layout(cfg: int) -> tuple[int, ...]:
    """The loaded library's layout of coupling configuration ``cfg``
    (``aspire_coupling_layout``), read once per process."""
    lib = load_library()
    out = (ctypes.c_int * 16)()
    count = lib.aspire_coupling_layout(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"coupling configuration {cfg} has no layout table")
    return tuple(out[:count])


def launch_packed(arch, mode: str, weights: torch.Tensor,
                  x: torch.Tensor):
    """Launch the kernel on a CUDA ``x`` with weights already packed by
    :func:`prepare_mma_params`."""
    lib = load_library()
    cfg = config_id(arch)
    if cfg is None:
        raise ValueError(f"no coupling kernel compiled for {arch}")
    layout = mma_layout(arch)
    library = _coupling_library_layout(cfg)
    _check_launch(lib, "coupling kernel", arch, weights, x, library[0],
                  layout[0], coupling_shared_bytes(arch))
    if library != (*layout, COUPLING_WARPS):
        raise RuntimeError("coupling weight layout disagrees with the kernel "
                           "library")
    if weights.numel() != arch.n_layers * layout[0] or weights.data_ptr() % 16:
        raise ValueError(f"weights are not a 16-byte aligned packing of "
                         f"{arch}")
    n = x.shape[0]
    z = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.aspire_coupling(
            x.data_ptr(), z.data_ptr(), ld.data_ptr(), weights.data_ptr(),
            n, arch.n_layers, float(arch.tail_bound), cfg,
            1 if mode == "forward" else 0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    launches.count += 1
    if mode != "forward":
        sampling_launches.count += 1
    check(code, "coupling kernel")
    return z, ld


def coupling_kernel_apply(arch, mode: str, params: dict, x: torch.Tensor):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        fn = arch.forward_plain if mode == "forward" else arch.inverse_plain
        return fn(params, x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return launch_packed(arch, mode,
                         packed_coupling_params(arch, params, x.device),
                         x.contiguous())


class _FusedPass(torch.autograd.Function):
    """A kernel's pass forward; its backward recomputes through the plain
    path ``plain(params, x)``."""

    @staticmethod
    def forward(ctx, kernel, plain, treedef, x, *leaves):
        params = _unflatten(treedef, leaves)
        with torch.no_grad():
            z, ld = kernel(params, x)
        ctx.plain, ctx.treedef = plain, treedef
        ctx.save_for_backward(x, *leaves)
        return z, ld

    @staticmethod
    def backward(ctx, gz, gld):
        x, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(x.requires_grad)
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
            params = _unflatten(ctx.treedef, leaves)
            z, ld = ctx.plain(params, x)
            inputs = [t for t in [x, *leaves] if t.requires_grad]
            grads = torch.autograd.grad((z, ld), inputs, (gz, gld),
                                        allow_unused=True)
        it = iter(grads)
        out = [next(it) if t.requires_grad else None for t in [x, *leaves]]
        return (None, None, None, *out)


def _flatten(params: dict):
    leaves, treedef = [], []
    for net in params["layers"]:
        treedef.append(len(net["layers"]))
        for layer in net["layers"]:
            leaves += [layer["w"], layer["b"]]
    return tuple(treedef), leaves


def _unflatten(treedef, leaves) -> dict:
    it = iter(leaves)
    return {
        "layers": [
            {"layers": [{"w": next(it), "b": next(it)} for _ in range(k)]}
            for k in treedef
        ]
    }


def fused_coupling_apply(arch, mode: str, params: dict, x: torch.Tensor):
    """Coupling pass with ``mode`` in {"forward", "inverse"}.

    Same semantics as ``Coupling.forward_plain``/``inverse_plain``;
    differentiable in ``x`` and the parameters, with the backward pass
    recomputed through the plain path.
    """
    treedef, leaves = _flatten(params)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    return _FusedPass.apply(
        functools.partial(coupling_kernel_apply, arch, mode), plain,
        treedef, x, *leaves)


# ---------------------------------------------------------------------------
# MAF-RQS density pass (the sampling pass is a sequential solve over dims
# and stays on the plain path, as in the JAX package)
# ---------------------------------------------------------------------------


def maf_config_id(arch) -> int | None:
    if not isinstance(arch, MAF) or arch.transformer != "rqs":
        return None
    return MAF_KERNEL_CONFIGS.get(
        (arch.dims, tuple(arch.n_hidden), arch.num_bins))


def maf_group(arch) -> int:
    """Floats per dim's parameter group: ``3K - 1`` rounded up to 8, the
    width of the kernel's mma n-tiles."""
    return -(-arch.n_params_per_dim // 8) * 8


def _max_degree(arch) -> int:
    return max(arch.dims - 1, 1)


def _hidden_degrees(arch, width: int) -> torch.Tensor:
    """MADE degrees of a hidden layer's units, ``j % (D - 1) + 1`` for unit
    ``j`` (as ``made_masks``)."""
    return torch.arange(width) % _max_degree(arch) + 1


def degree_order(arch, width: int) -> torch.Tensor:
    """The hidden units of a MADE layer sorted by degree, stably: the
    kernel's unit order."""
    return torch.argsort(_hidden_degrees(arch, width), stable=True)


def degree_ends(arch, width: int) -> list[int]:
    """``ends[d]``: the number of hidden units of degree <= d, for
    d = 0 .. D - 1 (the ends of the sorted degree segments)."""
    degrees = _hidden_degrees(arch, width)
    return [int((degrees <= d).sum()) for d in range(_max_degree(arch) + 1)]


@functools.lru_cache(maxsize=None)
def maf_ksteps(arch) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The 8-wide k-steps the kernel multiplies, in sorted unit order:
    per n-tile ``j`` of W2 (output units ``8j .. 8j+7`` read the first-layer
    units up to the highest degree among them) and per dim ``i`` of W3
    (dim ``i`` reads the second-layer units of degree <= i; none for dim
    0)."""
    h1, h2 = tuple(arch.n_hidden)
    e1, e2 = degree_ends(arch, h1), degree_ends(arch, h2)
    deg2 = torch.sort(_hidden_degrees(arch, h2)).values
    ks2 = tuple(-(-e1[int(deg2[8 * j + 7])] // 8) for j in range(h2 // 8))
    ks3 = tuple(-(-e2[min(i, _max_degree(arch))] // 8)
                for i in range(arch.dims))
    return ks2, ks3


def maf_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed MAF buffer, in order, with
    their shapes (csrc/maf.cu MafShape), hidden units in degree order:
    W1 ``(H1, D)``, b1, W2 as ``(F2, 32, 2)`` mma B fragments (the kept
    blocks only), b2, W3 as ``(F3, 32, 2)`` fragments (dims 1..D-1), b3
    ``(D, G)``."""
    d, (h1, h2), g = arch.dims, tuple(arch.n_hidden), maf_group(arch)
    ks2, ks3 = maf_ksteps(arch)
    f2, f3 = sum(ks2), (g // 8) * sum(ks3)
    return [("w1", (h1, d)), ("b1", (h1,)), ("w2", (f2, 32, 2)),
            ("b2", (h2,)), ("w3", (f3, 32, 2)), ("b3", (d, g))]


@functools.lru_cache(maxsize=None)
def maf_layer_floats(arch) -> int:
    """Floats per layer of the packed MAF buffer (MafShape::SIZE)."""
    return _packed_floats(int(torch.Size(shape).numel())
                          for _, shape in maf_sections(arch))


def maf_stage_floats(arch) -> int:
    """Floats of one warp's shared buffer in the MAF kernel
    (MafShape::STAGE): 16 particles' coordinates and the spline parameters
    of dims 1..D-1."""
    d = arch.dims
    return 16 * d + (d - 1) * 16 * maf_group(arch)


def maf_shared_bytes(arch) -> int:
    """Shared memory of a MAF kernel block with one warp: every layer's
    packed weights and one warp's buffer."""
    return 4 * (arch.n_layers * maf_layer_floats(arch) + maf_stage_floats(arch))


def should_fuse_maf(arch, x: torch.Tensor) -> bool:
    """True when the CUDA MAF kernel applies: an RQS MAF in a compiled
    configuration whose weights fit one block's shared memory, on a CUDA
    float32 batch of at least ``MIN_FUSED_N`` rows. Affine MAF runs plain
    (the JAX package measured its fusion as neutral)."""
    return (
        x.is_cuda
        and x.dim() == 2
        and x.shape[0] >= MIN_FUSED_N
        and x.dtype == torch.float32
        and maf_config_id(arch) is not None
        and maf_shared_bytes(arch) <= MAX_SHARED_BYTES
    )


@functools.lru_cache(maxsize=None)
def _maf_fragments(arch):
    """(row, column) of every entry of the packed W2 and W3 fragments,
    each a ``(F, 32, 2)`` index pair into the sorted ``(H1, H2)`` W2 and
    ``(H2, D * G)`` W3: lane ``4g + t`` of the fragment for k-step ``s``
    and n-tile ``j`` holds rows ``8s + 2t`` and ``8s + 2t + 1`` of column
    ``8j + g`` (the mma B fragment, with the k order that lets one
    product's accumulator serve as the next one's A fragment)."""
    lane = torch.arange(32)
    rows = 2 * (lane % 4)[:, None] + torch.arange(2)[None, :]
    cols = (lane // 4)[:, None].expand(32, 2)
    g, nt = maf_group(arch), maf_group(arch) // 8
    ks2, ks3 = maf_ksteps(arch)
    w2 = [(8 * s + rows, 8 * j + cols)
          for j, k in enumerate(ks2) for s in range(k)]
    w3 = [(8 * s + rows, i * g + 8 * m + cols)
          for i, k in enumerate(ks3) for s in range(k) for m in range(nt)]

    def stack(frags):
        if not frags:
            return (torch.zeros((0, 32, 2), dtype=torch.long),) * 2
        return tuple(torch.stack(f) for f in zip(*frags))

    return stack(w2), stack(w3)


def _maf_sorted_weights(arch, net: dict):
    """One layer's MADE, mask-premultiplied, hidden units in degree order:
    W1 ``(H1, D)``, b1, W2 ``(H1, H2)``, b2, W3 ``(H2, D * G)``, b3
    ``(D, G)`` (each dim's P parameters zero-padded to G)."""
    d, P, G = arch.dims, arch.n_params_per_dim, maf_group(arch)
    h1, h2 = tuple(arch.n_hidden)
    if h1 % 8 or h2 % 8:
        raise ValueError(f"the MAF kernel takes hidden widths /8: {arch}")
    l1, l2, l3 = net["layers"]
    m1, m2, m3 = arch.masks(l1["w"])
    o1 = degree_order(arch, h1).to(l1["w"].device)
    o2 = degree_order(arch, h2).to(l1["w"].device)
    w3 = torch.nn.functional.pad((l3["w"] * m3)[o2].reshape(h2, d, P),
                                 (0, G - P)).reshape(h2, d * G)
    b3 = torch.nn.functional.pad(l3["b"].reshape(d, P), (0, G - P))
    return ((l1["w"] * m1)[:, o1].t(), l1["b"][o1],
            (l2["w"] * m2)[o1][:, o2], l2["b"][o2], w3, b3)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits), ties
    away from zero: ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_sum(w: torch.Tensor) -> torch.Tensor:
    """``hi + lo`` with ``hi`` = w cut to TF32 (its top 11 significant
    bits) and ``lo`` = the rest rounded to TF32: w to within 2^-21 of
    itself, in at most 22 significant bits, so the kernel splits it back
    into the same two TF32 values exactly (the operand split of its 3xTF32
    products)."""
    hi = (w.view(torch.int32) & -0x2000).view(torch.float32)
    return hi + _round_tf32(w - hi)


def prepare_maf_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's MADE into the MAF kernel's flat layout
    (:func:`maf_sections`), in the parameters' dtype: weights
    premultiplied by their masks (the JAX package's
    ``prepare_maf_params``), hidden units in degree order, W2 and W3 as
    the mma fragments of the blocks the masks keep, in float32 each as the
    sum of two TF32 values (:func:`split_tf32_sum`). Float64 parameters
    (tests of the layout) keep their weights as they are."""
    chunks = []
    (r2, c2), (r3, c3) = _maf_fragments(arch)
    for net in params["layers"]:
        w1, b1, w2, b2, w3, b3 = _maf_sorted_weights(arch, net)
        dev = w1.device
        w2, w3 = w2[r2.to(dev), c2.to(dev)], w3[r3.to(dev), c3.to(dev)]
        if w2.dtype == torch.float32:
            w2, w3 = split_tf32_sum(w2), split_tf32_sum(w3)
        _append_sections(chunks, [w1, b1, w2, b2, w3, b3])
    return _concat(chunks, arch.n_layers * maf_layer_floats(arch), arch,
                   chunks[0].dtype)


def unpack_maf_layer(arch, layer: torch.Tensor) -> dict:
    """One layer of the packed buffer as its sections (by name), the
    fragments scattered back into the sorted ``(H1, H2)`` W2 and
    ``(H2, D * G)`` W3 (zeros outside the kept blocks)."""
    sections, off = {}, 0
    for name, shape in maf_sections(arch):
        off = _round4(off)
        size = int(torch.Size(shape).numel())
        sections[name] = layer[off:off + size].reshape(shape)
        off += size
    h1, h2 = tuple(arch.n_hidden)
    (r2, c2), (r3, c3) = _maf_fragments(arch)
    dev = layer.device
    for name, (rows, cols), shape in (
            ("w2", (r2, c2), (h1, h2)),
            ("w3", (r3, c3), (h2, arch.dims * maf_group(arch)))):
        dense = layer.new_zeros(shape)
        dense[rows.to(dev), cols.to(dev)] = sections[name]
        sections[name] = dense
    return sections


def maf_packed_plain(arch, packed: torch.Tensor, x: torch.Tensor):
    """The MAF density pass computed from the kernel's packed buffer the
    way the kernel reads it, in plain torch: hidden units in degree order,
    only the 8-wide blocks the masks keep multiplied (a first-layer unit
    of degree d by inputs < d), dim 0's spline parameters from its bias
    alone, then the inverse spline of every dim and the reversal of dims.
    For tests of the layout: no kernel path calls it."""
    d, P, G = arch.dims, arch.n_params_per_dim, maf_group(arch)
    h1, h2 = tuple(arch.n_hidden)
    e1 = degree_ends(arch, h1)
    ks2, ks3 = maf_ksteps(arch)
    n = x.shape[0]
    log_det = x.new_zeros(n)
    z = x
    for layer in packed.reshape(arch.n_layers, -1):
        sec = unpack_maf_layer(arch, layer)
        h = x.new_empty((n, h1))
        for deg in range(1, len(e1)):
            seg = slice(e1[deg - 1], e1[deg])
            h[:, seg] = z[:, :deg] @ sec["w1"][seg, :deg].t() + sec["b1"][seg]
        h = torch.relu(h)
        hh = torch.cat([h[:, :8 * k] @ sec["w2"][:8 * k, 8 * j:8 * j + 8]
                        for j, k in enumerate(ks2)], dim=1)
        hh = torch.relu(hh + sec["b2"])
        par = [sec["b3"][0, :P].expand(n, P)]
        for i in range(1, d):
            cols = slice(i * G, i * G + P)
            par.append(hh[:, :8 * ks3[i]] @ sec["w3"][:8 * ks3[i], cols]
                       + sec["b3"][i, :P])
        y, eld = arch._elementwise(z, torch.stack(par, dim=1), inverse=True)
        log_det = log_det + eld.sum(-1)
        z = y.flip(-1)
    return z, log_det


def _pack_once(cache: dict, pack, arch, params: dict,
               device: torch.device | None = None) -> torch.Tensor:
    """``pack(arch, params)``, kept in ``cache`` per card with the parameter
    tensors themselves and their in-place version counters: the same
    tensors at the same versions give the kept packing; a new or updated
    tensor packs anew (an update made through ``.data`` bypasses the
    version counter and is not seen). A CUDA ``device`` (the card of the
    tensors the kernel reads) gets its own copy where the parameters live
    on another card; None keeps the parameters' device."""
    _, leaves = _flatten(params)
    key = (arch, tuple(t._version for t in leaves))
    slot = cache.setdefault(str(device), {})
    hit = slot.get("key")
    if (hit is not None and hit[0] == key
            and len(hit[1]) == len(leaves)
            and all(a is b for a, b in zip(hit[1], leaves))):
        return slot["packed"]
    packed = pack(arch, params)
    if (device is not None and device.type == "cuda"
            and packed.device != device):
        packed = packed.to(device)
    slot.update(key=(key, tuple(leaves)), packed=packed)
    return packed


_maf_pack_cache: dict = {}


def kept_packings() -> tuple:
    """The packings the caches hold now. A CUDA graph that launched a
    kernel on one holds it, since a cache keeps only its latest packing
    per card."""
    return tuple(slot["packed"] for cache in (_coupling_pack_cache,
                                              _maf_pack_cache)
                 for slot in cache.values() if "packed" in slot)


def packed_maf_params(arch, params: dict,
                      device: torch.device | None = None) -> torch.Tensor:
    """:func:`prepare_maf_params`, packed once per set of parameters and
    card (:func:`_pack_once`), so the ``n_steps + 2`` density passes of a
    split-chain mutation pack once."""
    return _pack_once(_maf_pack_cache, prepare_maf_params, arch, params,
                      device)


@functools.lru_cache(maxsize=None)
def _maf_library_layout(cfg: int) -> tuple[int, int, tuple[int, ...]]:
    """The loaded library's layout of MAF configuration ``cfg``: floats per
    layer, floats per warp buffer, and the k-steps of W2's n-tiles then
    W3's dims (MafBlocks), read once per process."""
    lib = load_library()
    out = (ctypes.c_int * 256)()
    count = lib.aspire_maf_ksteps(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"MAF configuration {cfg} has no k-step table")
    return (lib.aspire_maf_layer_floats(cfg), lib.aspire_maf_stage_floats(cfg),
            tuple(out[:count]))


def launch_maf(arch, weights: torch.Tensor, x: torch.Tensor):
    """Launch the MAF density kernel on a CUDA ``x`` with weights already
    packed by :func:`prepare_maf_params`."""
    lib = load_library()
    cfg = maf_config_id(arch)
    if cfg is None:
        raise ValueError(f"no MAF kernel compiled for {arch}")
    layer, stage, ksteps = _maf_library_layout(cfg)
    _check_launch(lib, "MAF kernel", arch, weights, x, layer,
                  maf_layer_floats(arch), maf_shared_bytes(arch))
    ks2, ks3 = maf_ksteps(arch)
    if stage != maf_stage_floats(arch) or ksteps != ks2 + ks3:
        raise RuntimeError("MAF buffer layout disagrees with the kernel library")
    n = x.shape[0]
    z = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.aspire_maf(
            x.data_ptr(), z.data_ptr(), ld.data_ptr(), weights.data_ptr(),
            n, arch.n_layers, float(arch.tail_bound), cfg,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    maf_launches.count += 1
    check(code, "MAF kernel")
    return z, ld


def maf_kernel_apply(arch, params: dict, x: torch.Tensor):
    """The MAF density kernel on a CUDA tensor, ``MAF.forward_plain`` on a
    CPU tensor."""
    if x.device.type == "cpu":
        return arch.forward_plain(params, x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return launch_maf(arch, packed_maf_params(arch, params, x.device),
                      x.contiguous())


def fused_maf_forward(arch, params: dict, x: torch.Tensor):
    """MAF density pass with the semantics of ``MAF.forward_plain``;
    differentiable in ``x`` and the parameters, with the backward pass
    recomputed through the plain path."""
    treedef, leaves = _flatten(params)
    return _FusedPass.apply(functools.partial(maf_kernel_apply, arch),
                            arch.forward_plain, treedef, x, *leaves)
