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
import dataclasses
import functools
import os

import torch

from ..flows.architectures import MAF, Coupling
from ..flows.bijectors import (  # noqa: F401 - public, as in JAX package
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
)
from ._build import LaunchCounter, check, load_instance, load_library

#: Below this batch the plain path is already launch-bound; training
#: batches stay on the plain autograd path (the JAX package's threshold,
#: read once, at import, from ``ASPIRE_TPU_FUSED_MIN_N`` as it reads it).
MIN_FUSED_N = int(os.environ.get("ASPIRE_TPU_FUSED_MIN_N", "4096"))


def fused_enabled() -> bool:
    """The JAX package's kill switch, read at every call: any value of
    ``ASPIRE_TPU_FUSED`` but ``"1"`` turns the flow kernels off (B1/B3,
    B4, and the chain kernel unless ``fused_chain=True`` forces it)."""
    return os.environ.get("ASPIRE_TPU_FUSED", "1") == "1"

#: (transformer, dims, n_hidden, num_bins) -> configuration id compiled
#: into the prebuilt library; mirrors ASPIRE_COUPLING_CONFIGS in
#: csrc/common.cuh (hidden widths multiples of 8; an odd d pads each half
#: of a layer to (d + 1) // 2 dims). Configuration 2 is BASELINE config
#: 5's flow (nsf, 6 x (128, 128) at d = 32): depth is no part of the key;
#: 3 and 4 are nsf-tpu at d = 2 and d = 5, the JAX package's validation
#: rows. Every other shape the kernel takes builds an instance of its own
#: at first use (``_build.load_instance``).
KERNEL_CONFIGS = {
    ("rqs", 4, (64, 64), 8): 0,
    ("affine", 4, (64, 64), None): 1,
    ("rqs", 32, (128, 128), 8): 2,
    ("rqs", 2, (64, 64), 8): 3,
    ("rqs", 5, (64, 64), 8): 4,
}

#: What the JAX package's predicates take (``should_fuse``): at most 32
#: dims, RQS with at most 32 bins (or affine), at most 8 MB of float32
#: conditioner weights (``_weight_bytes``; twice them for a MAF), any
#: number of hidden layers (the first on FMAs, every further product on the
#: tensor cores; none: one product on FMAs).
MAX_FUSED_DIMS = 32
MAX_FUSED_BINS = 32
MAX_WEIGHT_BYTES = 8 * 1024 * 1024

#: (dims, n_hidden, num_bins) of an RQS MAF -> configuration id of the MAF
#: density kernel; mirrors ASPIRE_MAF_CONFIGS in csrc/common.cuh. A table
#: of its own, so a MAF is never packed for the coupling kernel.
MAF_KERNEL_CONFIGS = {
    (4, (64, 64), 8): 0,
}

#: Shared memory one block may hold on an H100 (227 KB).
MAX_SHARED_BYTES = 232448
_MAX_BLOCK_FLOATS = MAX_SHARED_BYTES // 4

#: Most warps in a block of the coupling kernel (kMaxCouplingWarps); the
#: chain kernel's block (its 256-particle tile); the wide form's chunk
#: target in floats (coupling_mma.cuh kChunkFloats).
COUPLING_WARPS = 8
_CHAIN_WARPS = 8
_CHUNK_FLOATS = 4096

launches = LaunchCounter()
#: the coupling kernel's launches in sampling mode (B3) alone, also
#: counted in ``launches``
sampling_launches = LaunchCounter()
maf_launches = LaunchCounter()


def kernel_hidden(arch) -> tuple[int, ...]:
    """The hidden widths the kernels compute with: each rounded up to a
    multiple of 8, the padded units' incoming and outgoing weights zero
    (:func:`pad_hidden`), which leaves the function as it is."""
    return tuple(-(-int(h) // 8) * 8 for h in arch.n_hidden)


def kernel_arch(arch):
    """``arch`` at :func:`kernel_hidden`'s widths (itself where they are
    its own)."""
    hidden = kernel_hidden(arch)
    if hidden == tuple(arch.n_hidden):
        return arch
    return dataclasses.replace(arch, n_hidden=hidden)


def pad_hidden(arch, params: dict) -> dict:
    """``params`` with each hidden layer zero-padded to
    :func:`kernel_hidden` (the new units last: zero incoming weights and
    bias, zero outgoing weights); ``params`` itself where nothing pads."""
    hidden = kernel_hidden(arch)
    if hidden == tuple(arch.n_hidden):
        return params
    pad = torch.nn.functional.pad
    grow = [h - n for h, n in zip(hidden, arch.n_hidden)]
    layers = []
    for net in params["layers"]:
        dense = []
        for i, layer in enumerate(net["layers"]):
            rows = grow[i - 1] if i else 0
            cols = grow[i] if i < len(grow) else 0
            dense.append({"w": pad(layer["w"], (0, cols, 0, rows)),
                          "b": pad(layer["b"], (0, cols))})
        layers.append({"layers": dense})
    return {"layers": layers}


def reference_weight_bytes(arch) -> int:
    """The JAX package's ``_weight_bytes``: float32 bytes of every layer's
    conditioner, its output layer ``(d + 1) // 2`` parameter groups of 8
    rows (affine) or ``3K`` rounded up to 8."""
    d = arch.dims
    group = (8 if arch.transformer == "affine"
             else -(-3 * arch.num_bins // 8) * 8)
    sizes = [d, *arch.n_hidden, (d + 1) // 2 * group]
    per_layer = sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                    for i in range(len(sizes) - 1))
    return 4 * arch.n_layers * per_layer


def _reference_takes(arch) -> bool:
    """What the JAX package's ``should_fuse`` reads of the flow."""
    return (1 <= arch.dims <= MAX_FUSED_DIMS
            and arch.transformer in ("affine", "rqs")
            and (arch.transformer == "affine"
                 or arch.num_bins <= MAX_FUSED_BINS)
            and reference_weight_bytes(arch) <= MAX_WEIGHT_BYTES)


def config_id(arch) -> int | None:
    """The prebuilt library's configuration of a coupling flow (its hidden
    widths as :func:`kernel_hidden` pads them), or None: that shape gets
    an instance of its own at first use (:func:`coupling_library`)."""
    if not isinstance(arch, Coupling):
        return None
    bins = arch.num_bins if arch.transformer == "rqs" else None
    return KERNEL_CONFIGS.get(
        (arch.transformer, arch.dims, kernel_hidden(arch), bins)
    )


def coupling_row(arch) -> tuple:
    """The flow's configuration row of ``ASPIRE_COUPLING_CONFIGS`` (its
    values after the id): ``(D, (H...), K, RQS)``, every hidden width
    padded (so the row names the depth), K 1 for an affine flow."""
    rqs = arch.transformer == "rqs"
    return (arch.dims, kernel_hidden(arch), arch.num_bins if rqs else 1, rqs)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def coupling_takes(arch) -> bool:
    """Whether the coupling kernel takes the flow: what the JAX package's
    predicate takes (:func:`_reference_takes`), where a block of its form
    fits one SM (:func:`coupling_warps`)."""
    return (isinstance(arch, Coupling) and _reference_takes(arch)
            and coupling_warps(arch) >= 1)


def mma_weight_buffers(arch) -> int:
    """Floats of a block's weight buffers in the tensor-core pass: two
    whole layers, or in the wide form two resident parts (one where two
    leave no warp) and two chunks (neither grows with depth)."""
    return mma_shape(arch)["bufs"]


def coupling_warps(arch) -> int:
    """Warps in a block of the coupling kernel at its most (MmaShape::
    WARPS): as many as fit beside its weight buffers, at most 8."""
    return mma_shape(arch)["warps"]


def coupling_shared_bytes(arch) -> int:
    """Shared memory of a coupling kernel block at its most warps: its
    weight buffers (:func:`mma_weight_buffers`) and a warp buffer per
    warp."""
    shape = mma_shape(arch)
    return 4 * (shape["bufs"] + shape["warps"] * shape["stage"])


def should_fuse(arch, x: torch.Tensor) -> bool:
    """True when the CUDA kernel applies to this (architecture, batch):
    the switch on (:func:`fused_enabled`), a CUDA float32 batch of at least
    ``MIN_FUSED_N`` rows and a flow the kernel takes
    (:func:`coupling_takes`)."""
    return (
        fused_enabled()
        and x.is_cuda
        and x.dim() == 2
        and x.shape[0] >= MIN_FUSED_N
        and x.dtype == torch.float32
        and coupling_takes(arch)
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


def chain_consts_floats(d: int) -> int:
    """Floats of the chain kernel's constant block at ``d``
    (coupling_mma.cuh ``chain_consts_floats``)."""
    return _round4(d + 2 * d * d + 2 * (8 * d + 3) + 2 * d + 2 + 1 + 2 + 2)


def _chunk_steps(steps: int, most: int, floats_per_step: int) -> int:
    """coupling_mma.cuh ``chunk_steps``: the most k-steps (``most``,
    halving) dividing ``steps`` whose chunk stays within 4096 floats."""
    k = most
    while k > 1:
        if steps % k == 0 and k * floats_per_step <= _CHUNK_FLOATS:
            return k
        k //= 2
    return 1


def hidden_products(arch) -> list[tuple[str, str, int, int]]:
    """The tensor-core products between hidden layers (``MmaShape::WH``,
    ``BH``): ``(weights, bias, k_in, n_out)`` of h_j -> h_{j+1}, named
    ``w2``/``b2`` for j = 0 and ``w2.j``/``b2.j`` after it, at
    :func:`kernel_hidden`'s widths."""
    hidden = kernel_hidden(arch)
    return [("w2" if j == 0 else f"w2.{j}", "b2" if j == 0 else f"b2.{j}",
             hidden[j], hidden[j + 1]) for j in range(len(hidden) - 1)]


def _slots_cp(arch, wide: bool) -> tuple[int, int]:
    """The active slots packed and W1's row stride (``MmaShape::AS``,
    ``CP``): the half, or in the wide form whole groups of two and the
    stride rounded to 4 floats (rounded too with no hidden layer)."""
    half = mma_half(arch)
    slots = WIDE_GROUP_DIMS * -(-half // WIDE_GROUP_DIMS) if wide else half
    return slots, _round4(half) if wide or not arch.n_hidden else half


def _mma_sections_of(arch, wide: bool) -> list[tuple[str, tuple]]:
    """The sections of one packed layer in order with their shapes, in the
    whole-layer or the wide form (:func:`mma_sections`)."""
    hidden = kernel_hidden(arch)
    g = mma_group(arch)
    slots, cp = _slots_cp(arch, wide)
    out = slots * g
    if not hidden:
        return [("w3", (out, cp)), ("b3", (slots, g))]
    prods = hidden_products(arch)
    w1 = [("w1", (hidden[0], cp)), ("b1", (hidden[0],))]
    w3 = ("w3", (hidden[-1] // 8 * out // 8, 32, 2))
    b3 = ("b3", (slots, g))
    frags = [(w, (k // 8 * n // 8, 32, 2)) for w, _, k, n in prods]
    biases = [(b, (n,)) for _, b, _, n in prods]
    if wide:
        return [*w1, *biases, b3, *frags, w3]
    return [*w1, *[x for pair in zip(frags, biases) for x in pair], w3, b3]


def _offsets(sections) -> tuple[dict, int]:
    """Each section's offset (each on a multiple of 4 floats) and the
    layer's floats."""
    offsets, off = {}, 0
    for name, shape in sections:
        off = _round4(off)
        offsets[name] = off
        off += int(torch.Size(shape).numel())
    return offsets, _round4(off)


@functools.lru_cache(maxsize=None)
def mma_shape(arch) -> dict:
    """The shape's constants as ``MmaShape`` computes them, at
    :func:`kernel_hidden`'s widths: the form (``wide`` where the
    whole-layer form's accumulators pass 128 floats a thread, two of its
    layers do not fit a block beside one warp's buffer, or the chain
    kernel's block of 8 warps and two layers does not fit; never with no
    hidden layer; ``by_dim``), the active slots packed (``slots``: the wide
    form pads an odd half to whole groups of two) and W1's row stride
    (``cp``), the sections and their offsets, a layer's and a warp
    buffer's floats, the wide form's resident part and chunk, and a
    coupling kernel block's weight buffers and most warps. The wide form
    holds one resident part (``one_res``) where two leave no warp beside
    the chunks."""
    hidden = kernel_hidden(arch)
    nh = len(hidden)
    d, half, g = arch.dims, mma_half(arch), mma_group(arch)
    ks, ntd = [h // 8 for h in hidden], g // 8
    _, whole_size = _offsets(_mma_sections_of(arch, False))
    whole_stage = 32 * (half * g + 4) if nh else 0
    if nh == 0:
        regs = False
    elif nh == 1:
        regs = 8 * (half * g // 8) > 128
    else:
        regs = (any(8 * (ks[j] + ks[j + 1]) > 128 for j in range(1, nh - 1))
                or 8 * (ks[-1] + ntd) > 128)
    wide = nh > 0 and (
        regs or _MAX_BLOCK_FLOATS - 2 * whole_size < whole_stage
        or (2 * whole_size + chain_consts_floats(d) + 2 * _CHAIN_WARPS
            + _CHAIN_WARPS * whole_stage) > _MAX_BLOCK_FLOATS)
    sections = _mma_sections_of(arch, wide)
    offsets, size = _offsets(sections)
    slots, cp = _slots_cp(arch, wide)
    out = slots * g
    ng = WIDE_GROUP_DIMS * g // 8
    row = (WIDE_GROUP_DIMS * g if wide else out) + 4
    if wide:
        stage = 16 * row + 32 * (d + 1) + (16 * cp if nh == 1 else 0)
    else:
        stage = 32 * row if nh else 0
    chunks = [64 * _chunk_steps(ks[j], 4, 64 * ks[j + 1]) * ks[j + 1]
              for j in range(nh - 1)]
    chunks.append(64 * _chunk_steps(ks[-1], 8, 64 * ng) * ng if nh else 0)
    first = "w2" if nh >= 2 else "w3"
    res = offsets[first] if wide else 0
    chunk = max(chunks) if wide else 0
    # One resident part where two leave no warp beside the chunks.
    one_res = wide and _MAX_BLOCK_FLOATS - 2 * (res + chunk) < stage
    bufs = ((1 if one_res else 2) * res + 2 * chunk if wide
            else 2 * size)
    fit = ((_MAX_BLOCK_FLOATS - bufs) // stage if stage
           else (COUPLING_WARPS if bufs <= _MAX_BLOCK_FLOATS else 0))
    return {"wide": wide,
            "by_dim": not wide and nh >= 2 and 8 * (ks[-1] + half * g // 8)
            > 128,
            "slots": slots, "cp": cp, "sections": sections,
            "offsets": offsets, "size": size, "row": row, "stage": stage,
            "res": res, "chunk": chunk, "one_res": one_res, "bufs": bufs,
            "warps": min(fit, COUPLING_WARPS)}


def mma_wide(arch) -> bool:
    """Whether the shape takes the wide form (MmaShape::WIDE,
    :func:`mma_shape`)."""
    return mma_shape(arch)["wide"]


def mma_form(arch) -> str:
    """The coupling kernel's form at this shape, as ``chip_smoke.py``
    prints it: ``"wide"`` or ``"whole-layer"`` (``", by dim"`` where the
    output layer goes one dim at a time; ``"linear"`` with no hidden
    layer; ``", one resident part"`` where the wide form holds one),
    then its most warps a block."""
    shape = mma_shape(arch)
    form = ("wide" if shape["wide"] else "whole-layer" if arch.n_hidden
            else "linear")
    by_dim = ", by dim" if shape["by_dim"] else ""
    one_res = ", one resident part" if shape["one_res"] else ""
    return f"{form}{by_dim}{one_res}, {shape['warps']} warps"


def mma_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed buffer, in order, with their
    shapes: W1 ``(H_0, cp)`` of the conditioning inputs, b1, then per
    hidden product (:func:`hidden_products`) its ``(H_j/8 * H_{j+1}/8, 32,
    2)`` mma B fragments and bias, W3 as ``(H_last/8 * slots * G/8, 32,
    2)`` fragments, b3 ``(slots, G)`` (:func:`mma_shape`'s ``cp`` and
    ``slots``: the half, or in the wide form its row stride rounded to 4
    floats and whole groups of two), hidden widths :func:`kernel_hidden`'s.
    The wide form puts the sections a layer reads throughout first (W1,
    b1, every hidden bias, b3) and then the streamed ones (the hidden
    products, then W3 by groups of two active dims). With no hidden layer:
    W3 ``(slots * G, cp)`` dense (on FMAs) and b3."""
    return mma_shape(arch)["sections"]


def _section_offsets(arch) -> tuple[dict, int]:
    """Each section's offset in a packed layer, and the layer's floats."""
    shape = mma_shape(arch)
    return shape["offsets"], shape["size"]


def _w3_group_cols(arch) -> int:
    """W3 columns per fragment group: a group of two active dims in the
    wide form, all of them otherwise."""
    shape = mma_shape(arch)
    g = mma_group(arch)
    return WIDE_GROUP_DIMS * g if shape["wide"] else shape["slots"] * g


@functools.lru_cache(maxsize=None)
def mma_layout(arch) -> tuple[int, ...]:
    """The layout as the library reports it (``aspire_chain_layout``, the
    first entries of ``aspire_coupling_layout``): floats per layer, the
    offsets of W1, b1, W2, b2, W3 and b3 (-1 for a section the shape has
    not), the row stride and the floats of a warp's buffer (whole-layer
    form: the transformer parameters of 32 rows; wide form: those of one
    16-row tile's group, then the warp's 32 particles, ``D + 1`` floats
    apart, then with one hidden layer the tile's inputs), then the wide
    form's resident part and largest chunk (0 and 0 otherwise), then the
    offsets of every further hidden product's fragments and bias."""
    shape = mma_shape(arch)
    offsets = shape["offsets"]
    names = ("w1", "b1", "w2", "b2", "w3", "b3")
    extra = [offsets[k] for w, b, _, _ in hidden_products(arch)[1:]
             for k in (w, b)]
    return (shape["size"], *(offsets.get(k, -1) for k in names),
            shape["row"], shape["stage"], shape["res"], shape["chunk"],
            *extra)


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


def _dense_layer(arch, layer: int, net: dict) -> dict:
    """One layer's conditioner as the kernel computes it (hidden widths
    already :func:`kernel_hidden`'s), each half of the layer in its
    :func:`mma_shape` slots (a padding slot's weights zero), by section
    name: W1 ``(H_0, cp)`` on the conditioning inputs, b1, each hidden
    product ``(H_j, H_{j+1})`` and bias, W3 ``(H_last, slots * G)`` and b3
    ``(slots, G)`` of the active dims' parameter groups, each zero-padded
    to G; with no hidden layer W3 ``(slots * G, cp)`` on the conditioning
    inputs."""
    d, P, G = arch.dims, arch.n_params_per_dim, mma_group(arch)
    shape = mma_shape(arch)
    slots, cp = shape["slots"], shape["cp"]
    active, cond = _layer_dims(layer)
    dense, last = net["layers"], net["layers"][-1]
    pad = torch.nn.functional.pad
    rows = last["w"].shape[0]
    w3 = last["w"].reshape(rows, d, P)[:, active]
    w3 = pad(w3, (0, G - P, 0, slots - w3.shape[1])).reshape(rows, -1)
    b3 = last["b"].reshape(d, P)[active]
    b3 = pad(b3, (0, G - P, 0, slots - b3.shape[0]))
    if len(dense) == 1:
        w3 = w3[cond].t()
        return {"w3": pad(w3, (0, cp - w3.shape[1])), "b3": b3}
    w1 = dense[0]["w"][cond].t()
    out = {"w1": pad(w1, (0, cp - w1.shape[1])), "b1": dense[0]["b"],
           "w3": w3, "b3": b3}
    for (w, b, _, _), layer_j in zip(hidden_products(arch), dense[1:-1]):
        out[w], out[b] = layer_j["w"], layer_j["b"]
    return out


def _fragment_sections(arch) -> list[str]:
    """The sections packed as mma fragments: each hidden product, then
    W3 (none with no hidden layer)."""
    if not arch.n_hidden:
        return []
    return [w for w, _, _, _ in hidden_products(arch)] + ["w3"]


def _mma_fragment_indices(arch, device) -> tuple:
    """The fragment index pairs (:func:`_fragments`) of every tensor-core
    product, in :func:`_fragment_sections`' order."""
    if not arch.n_hidden:
        return ()
    return (*(_fragments(k, n, device)
              for _, _, k, n in hidden_products(arch)),
            _fragments(kernel_hidden(arch)[-1],
                       mma_shape(arch)["slots"] * mma_group(arch),
                       device, _w3_group_cols(arch)))


def prepare_mma_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's conditioner into the tensor-core flat layout
    (:func:`mma_sections`), in the parameters' dtype, hidden widths padded
    to :func:`kernel_hidden`'s (:func:`pad_hidden`): the products past W1
    as mma B fragments, in float32 each weight the sum of two TF32 values
    (:func:`split_tf32_sum`, so the kernel splits it exactly); float64
    parameters (tests of the layout) are kept as they are. With no hidden
    layer the one product stays dense (FMAs)."""
    params = pad_hidden(arch, params)
    dev = params["layers"][0]["layers"][0]["w"].device
    frags = list(zip(_fragment_sections(arch),
                     _mma_fragment_indices(arch, dev)))
    order = [name for name, _ in mma_sections(arch)]
    chunks = []
    for layer, net in enumerate(params["layers"]):
        sec = _dense_layer(arch, layer, net)
        for name, (rows, cols) in frags:
            sec[name] = sec[name][rows, cols]
            if sec[name].dtype == torch.float32:
                sec[name] = split_tf32_sum(sec[name])
        _append_sections(chunks, [sec[name] for name in order])
    return _concat(chunks, arch.n_layers * mma_layout(arch)[0], arch,
                   chunks[0].dtype)


def mma_conditioner_plain(arch, packed: torch.Tensor, layer: int,
                          x: torch.Tensor) -> torch.Tensor:
    """The ``(n, a, P)`` transformer parameters that layer ``layer``'s
    conditioner gives the ``a`` active dims of ``x``, read from the packed
    buffer the way the kernels read it: W1 on the conditioning inputs (a
    padding slot's input 0), the fragments gathered back into each
    product, each active dim's padded group cut to its parameters (the
    padding slot's dropped). For tests of the layout: no kernel path calls
    it."""
    hidden = kernel_hidden(arch)
    shape = mma_shape(arch)
    slots, G = shape["slots"], mma_group(arch)
    buf = packed.reshape(arch.n_layers, -1)[layer]
    offsets, _ = _section_offsets(arch)
    sec = {name: buf[offsets[name]:offsets[name]
                     + int(torch.Size(dims).numel())].reshape(dims)
           for name, dims in mma_sections(arch)}
    outs = {w: n for w, _, _, n in hidden_products(arch)}
    outs["w3"] = slots * G
    for name, (rows, cols) in zip(_fragment_sections(arch),
                                  _mma_fragment_indices(arch, buf.device)):
        k_in = hidden[0] if name == "w2" else (
            hidden[-1] if name == "w3" else hidden[int(name[3:])])
        dense = buf.new_zeros((k_in, outs[name]))
        dense[rows, cols] = sec[name]
        sec[name] = dense
    active, cond = _layer_dims(layer)
    xc = x[:, cond]
    xc = torch.nn.functional.pad(xc, (0, shape["cp"] - xc.shape[1]))
    if not hidden:
        out = xc @ sec["w3"].t() + sec["b3"].reshape(-1)
    else:
        h = torch.relu(xc @ sec["w1"].t() + sec["b1"])
        for w, b, _, _ in hidden_products(arch):
            h = torch.relu(h @ sec[w] + sec[b])
        out = h @ sec["w3"] + sec["b3"].reshape(-1)
    n_active = x[:, active].shape[1]
    return out.reshape(-1, slots, G)[:, :n_active, :arch.n_params_per_dim]


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


def coupling_library(arch):
    """``(library, configuration id)`` of the coupling kernel for the
    flow's shape: the prebuilt library's configuration
    (:func:`config_id`), else the shape's instance, built at its first use
    (``_build.load_instance``, id 0)."""
    cfg = config_id(arch)
    if cfg is not None:
        return load_library(), cfg
    return load_instance("coupling", coupling_row(arch)), 0


@functools.lru_cache(maxsize=None)
def _coupling_library_layout(lib, cfg: int) -> tuple[int, ...]:
    """Library ``lib``'s layout of coupling configuration ``cfg``
    (``aspire_coupling_layout``), read once per process."""
    out = (ctypes.c_int * 256)()
    count = lib.aspire_coupling_layout(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"coupling configuration {cfg} has no layout table")
    return tuple(out[:count])


def launch_packed(arch, mode: str, weights: torch.Tensor,
                  x: torch.Tensor):
    """Launch the kernel on a CUDA ``x`` with weights already packed by
    :func:`prepare_mma_params`: the prebuilt library's configuration or
    the shape's instance (:func:`coupling_library`)."""
    if not coupling_takes(arch):
        raise ValueError(f"the coupling kernel does not take {arch}")
    main = load_library()
    lib, cfg = coupling_library(arch)
    layout = mma_layout(arch)
    library = _coupling_library_layout(lib, cfg)
    _check_launch(main, "coupling kernel", arch, weights, x, library[0],
                  layout[0], coupling_shared_bytes(arch))
    if library != (*layout, coupling_warps(arch)):
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
    """The prebuilt library's configuration of an RQS MAF (its hidden
    widths as :func:`kernel_hidden` pads them), or None."""
    if not isinstance(arch, MAF) or arch.transformer != "rqs":
        return None
    return MAF_KERNEL_CONFIGS.get(
        (arch.dims, kernel_hidden(arch), arch.num_bins))


def maf_row(arch) -> tuple:
    """The MAF's configuration row of ``ASPIRE_MAF_CONFIGS`` (its values
    after the id): ``(D, (H...), K)``, hidden widths padded."""
    return (arch.dims, kernel_hidden(arch), arch.num_bins)


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
def maf_product_ksteps(arch) -> tuple[tuple[int, ...], ...]:
    """The 8-wide k-steps the kernel multiplies in each hidden product
    (h_j -> h_{j+1}, in sorted unit order), per n-tile ``n`` of h_{j+1}:
    output units ``8n .. 8n+7`` read the units of h_j up to the highest
    degree among them."""
    hidden = tuple(arch.n_hidden)
    out = []
    for h_in, h_out in zip(hidden, hidden[1:]):
        ends = degree_ends(arch, h_in)
        deg = torch.sort(_hidden_degrees(arch, h_out)).values
        out.append(tuple(-(-ends[int(deg[8 * n + 7])] // 8)
                         for n in range(h_out // 8)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def maf_ksteps(arch) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The 8-wide k-steps the kernel multiplies, in sorted unit order: per
    n-tile of every hidden product (:func:`maf_product_ksteps`, in order;
    W2's alone with two hidden layers) and per dim ``i`` of W3 (dim ``i``
    reads the last hidden layer's units of degree <= i, or with no hidden
    layer the inputs below i; none for dim 0)."""
    hidden = tuple(arch.n_hidden)
    ends = (degree_ends(arch, hidden[-1]) if hidden
            else list(range(arch.dims + 1)))
    ks3 = tuple(-(-ends[min(i, len(ends) - 1)] // 8)
                for i in range(arch.dims))
    return sum(maf_product_ksteps(arch), ()), ks3


def maf_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed MAF buffer, in order, with
    their shapes (csrc/maf.cu MafShape), hidden units in degree order:
    W1 ``(H_0, D)``, b1, each hidden product's ``(F_j, 32, 2)`` mma B
    fragments (the kept blocks only) and bias (named as
    :func:`hidden_products`), W3 as ``(F3, 32, 2)`` fragments (dims
    1..D-1), b3 ``(D, G)``; with no hidden layer W3 and b3 alone."""
    d, hidden, g = arch.dims, tuple(arch.n_hidden), maf_group(arch)
    _, ks3 = maf_ksteps(arch)
    out = [("w1", (hidden[0], d)), ("b1", (hidden[0],))] if hidden else []
    for (w, b, _, n), ks in zip(hidden_products(arch),
                                maf_product_ksteps(arch)):
        out += [(w, (sum(ks), 32, 2)), (b, (n,))]
    return out + [("w3", ((g // 8) * sum(ks3), 32, 2)), ("b3", (d, g))]


@functools.lru_cache(maxsize=None)
def maf_layer_floats(arch) -> int:
    """Floats per layer of the packed MAF buffer (MafShape::SIZE)."""
    return _offsets(maf_sections(arch))[1]


def maf_stage_floats(arch) -> int:
    """Floats of one warp's shared buffer in the MAF kernel
    (MafShape::STAGE): 16 particles' coordinates and the spline parameters
    of dims 1..D-1."""
    d = arch.dims
    return 16 * d + (d - 1) * 16 * maf_group(arch)


def maf_resident_bytes(arch) -> int:
    """Shared memory of a resident MAF kernel block with one warp: every
    layer's packed weights and one warp's buffer."""
    return 4 * (arch.n_layers * maf_layer_floats(arch) + maf_stage_floats(arch))


#: W2 fragments a streamed MAF chunk holds at most (maf.cu kMafChunkFrags)
_MAF_CHUNK_FRAGS = 64


def _maf_stream_items(arch, split3: bool, stream_w1: bool) -> tuple:
    """The floats of each item a streamed MAF layer streams (maf.cu
    ``MafStream``), in order: with ``stream_w1`` W1 by ``kw1`` k-steps of
    units; each hidden product's fragments by chunks of n-tiles of at most
    64 fragments; W3's by pairs of dims, with ``split3`` each pair by
    ``kc3`` k-steps. Returns the items' floats, the W2 chunks' count and
    ``(kw1, kc3)``."""
    d, g = arch.dims, maf_group(arch)
    _, ks3 = maf_ksteps(arch)
    hidden = tuple(arch.n_hidden)
    kw1 = max(1, _CHUNK_FLOATS // (8 * d)) if hidden else 0
    items = ([8 * d * min(kw1, hidden[0] // 8 - s)
              for s in range(0, hidden[0] // 8, kw1)]
             if stream_w1 and hidden else [])
    w2 = []
    for ks in maf_product_ksteps(arch):
        j = 0
        while j < len(ks):
            e, f = j, 0
            while e < len(ks) and (e == j or f + ks[e] <= _MAF_CHUNK_FRAGS):
                f, e = f + ks[e], e + 1
            w2.append(64 * f)
            j = e
    items += w2
    nt = g // 8
    kc3 = max(1, _MAF_CHUNK_FRAGS // (2 * nt))
    for q in range((d + 1) // 2):
        pair = ks3[2 * q:2 * q + 2]
        if not split3:
            items.append(64 * nt * sum(pair))
            continue
        for s in range(0, max(max(pair), 1), kc3):
            items.append(64 * nt * sum(max(0, min(k, s + kc3) - s)
                                       for k in pair))
    return items, len(w2), (kw1, kc3)


@functools.lru_cache(maxsize=None)
def maf_stream_layout(arch) -> dict:
    """The streamed MAF form's block (maf.cu ``MafStream``): a layer's
    head (W1, b1, every hidden bias, b3; ``head`` floats, two buffers),
    its items through two slots (``slot`` floats each: each hidden
    product's fragments by chunks of n-tiles of at most 64 fragments,
    ``w2_chunks`` of them in all, then W3's by two dims), a warp's buffer
    (``stage``: its tile in and out, two dims' parameters) and the most
    warps beside them (up to 16). Where that leaves no warp, each pair of
    dims' W3 streams by ``kc3`` k-steps (``split3``); where that leaves
    none either, W1 streams too, by ``kw1`` k-steps of units, and the head
    keeps the biases alone (``stream_w1``): ``level`` 0, 1 or 2, as
    maf.cu's ``maf_stream_level``."""
    d, g = arch.dims, maf_group(arch)
    hidden = tuple(arch.n_hidden)
    offsets, _ = _offsets(maf_sections(arch))
    stage = 2 * _round4(16 * d) + 16 * (2 * g + 4)
    for split3, stream_w1 in ((False, False), (True, False), (True, True)):
        items, w2_chunks, (kw1, kc3) = _maf_stream_items(arch, split3,
                                                        stream_w1)
        slot = _round4(max(items))
        if stream_w1:
            head = _round4(sum(hidden) + d * g)
        else:
            first = offsets["w2" if len(hidden) >= 2 else "w3"]
            head = _round4(first + sum(hidden[1:]) + d * g)
        bufs = 2 * slot + 2 * head
        warps = min((_MAX_BLOCK_FLOATS - bufs) // stage, 16)
        if warps >= 1:
            break
    return {"level": int(split3) + int(stream_w1), "slot": slot,
            "head": head, "w2_chunks": w2_chunks,
            "split3": split3, "stream_w1": stream_w1,
            "kc3": kc3 if split3 else 0, "kw1": kw1 if stream_w1 else 0,
            "stage": stage, "bufs": bufs, "warps": warps}


def maf_form(arch) -> str:
    """``"resident"`` where every layer's weights fit one block beside a
    warp's buffer (the prebuilt form), else ``"streamed"`` (the streamed
    or, at :func:`maf_stream_layout`'s level 1 or 2, the chunked form of
    the streamed instance)."""
    return ("resident" if maf_resident_bytes(arch) <= MAX_SHARED_BYTES
            else "streamed")


def maf_shared_bytes(arch) -> int:
    """Shared memory of a MAF kernel block of the flow's form with one
    warp."""
    if maf_form(arch) == "resident":
        return maf_resident_bytes(arch)
    layout = maf_stream_layout(arch)
    return 4 * (layout["bufs"] + layout["stage"])


def maf_takes(arch) -> bool:
    """Whether the MAF kernel takes the flow: what the JAX package's
    ``should_fuse_maf`` takes (RQS, twice its weight bytes within 8 MB,
    and ``should_fuse``'s bounds), where a block of its form fits one SM
    (every such flow since the chunked form)."""
    if not (isinstance(arch, MAF) and arch.transformer == "rqs"
            and _reference_takes(arch) and arch.dims >= 2
            and 2 * reference_weight_bytes(arch) <= MAX_WEIGHT_BYTES):
        return False
    karch = kernel_arch(arch)
    return (maf_form(karch) == "resident"
            or maf_stream_layout(karch)["warps"] >= 1)


def should_fuse_maf(arch, x: torch.Tensor) -> bool:
    """True when the CUDA MAF kernel applies: the switch on
    (:func:`fused_enabled`), a flow it takes (:func:`maf_takes`) on a CUDA
    float32 batch of at least ``MIN_FUSED_N`` rows. Affine MAF runs plain
    (the JAX package measured its fusion as neutral)."""
    return (
        fused_enabled()
        and x.is_cuda
        and x.dim() == 2
        and x.shape[0] >= MIN_FUSED_N
        and x.dtype == torch.float32
        and maf_takes(arch)
    )


@functools.lru_cache(maxsize=None)
def _maf_fragments(arch) -> dict:
    """(row, column) of every entry of the packed fragments, by section
    name, each a ``(F, 32, 2)`` index pair into the sorted ``(H_j,
    H_{j+1})`` hidden product and the ``(H_last, D * G)`` W3 (``(D, D *
    G)`` on the inputs with no hidden layer): lane ``4g + t`` of the
    fragment for k-step ``s`` and n-tile ``j`` holds rows ``8s + 2t`` and
    ``8s + 2t + 1`` of column ``8j + g`` (the mma B fragment, with the k
    order that lets one product's accumulator serve as the next one's A
    fragment)."""
    lane = torch.arange(32)
    rows = 2 * (lane % 4)[:, None] + torch.arange(2)[None, :]
    cols = (lane // 4)[:, None].expand(32, 2)
    g, nt = maf_group(arch), maf_group(arch) // 8
    _, ks3 = maf_ksteps(arch)

    def stack(frags):
        if not frags:
            return (torch.zeros((0, 32, 2), dtype=torch.long),) * 2
        return tuple(torch.stack(f) for f in zip(*frags))

    out = {w: stack([(8 * s + rows, 8 * j + cols)
                     for j, k in enumerate(ks) for s in range(k)])
           for (w, _, _, _), ks in zip(hidden_products(arch),
                                       maf_product_ksteps(arch))}
    out["w3"] = stack([(8 * s + rows, i * g + 8 * m + cols)
                       for i, k in enumerate(ks3) for s in range(k)
                       for m in range(nt)])
    return out


def _maf_dense_shapes(arch) -> dict:
    """The dense shape each fragment section packs (``_maf_fragments``):
    ``(rows, columns)`` with the rows padded to whole k-steps."""
    hidden = tuple(arch.n_hidden)
    out = {w: (k, n) for w, _, k, n in hidden_products(arch)}
    rows = hidden[-1] if hidden else -(-arch.dims // 8) * 8
    out["w3"] = (rows, arch.dims * maf_group(arch))
    return out


def _maf_sorted_weights(arch, net: dict) -> dict:
    """One layer's MADE, mask-premultiplied, hidden units in degree order,
    by section name: W1 ``(H_0, D)``, b1, each hidden product ``(H_j,
    H_{j+1})`` and bias, W3 ``(rows, D * G)`` (rows: the last hidden
    layer's units, or the inputs padded to whole k-steps) and b3 ``(D,
    G)`` (each dim's P parameters zero-padded to G)."""
    d, P, G = arch.dims, arch.n_params_per_dim, maf_group(arch)
    hidden = tuple(arch.n_hidden)
    if any(h % 8 for h in hidden):
        raise ValueError(f"the MAF packing takes hidden widths /8 "
                         f"(kernel_arch, pad_hidden): {arch}")
    dense = net["layers"]
    masks = arch.masks(dense[0]["w"])
    dev = dense[0]["w"].device
    orders = [degree_order(arch, h).to(dev) for h in hidden]
    w = [layer["w"] * m for layer, m in zip(dense, masks)]
    last = w[-1][orders[-1]] if hidden else w[-1]
    rows = _maf_dense_shapes(arch)["w3"][0]
    w3 = torch.nn.functional.pad(last.reshape(-1, d, P), (0, G - P))
    w3 = torch.nn.functional.pad(w3.reshape(-1, d * G),
                                 (0, 0, 0, rows - w3.shape[0]))
    b3 = torch.nn.functional.pad(dense[-1]["b"].reshape(d, P), (0, G - P))
    out = {"w3": w3, "b3": b3}
    if hidden:
        out["w1"] = w[0][:, orders[0]].t()
        out["b1"] = dense[0]["b"][orders[0]]
    for j, (wn, bn, _, _) in enumerate(hidden_products(arch)):
        out[wn] = w[j + 1][orders[j]][:, orders[j + 1]]
        out[bn] = dense[j + 1]["b"][orders[j + 1]]
    return out


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
    params, arch = pad_hidden(arch, params), kernel_arch(arch)
    chunks = []
    frags = _maf_fragments(arch)
    order = [name for name, _ in maf_sections(arch)]
    for net in params["layers"]:
        sec = _maf_sorted_weights(arch, net)
        dev = sec["w3"].device
        for name, (rows, cols) in frags.items():
            sec[name] = sec[name][rows.to(dev), cols.to(dev)]
            if sec[name].dtype == torch.float32:
                sec[name] = split_tf32_sum(sec[name])
        _append_sections(chunks, [sec[name] for name in order])
    return _concat(chunks, arch.n_layers * maf_layer_floats(arch), arch,
                   chunks[0].dtype)


def unpack_maf_layer(arch, layer: torch.Tensor) -> dict:
    """One layer of the packed buffer as its sections (by name), the
    fragments scattered back into the sorted dense products
    (:func:`_maf_dense_shapes`; zeros outside the kept blocks)."""
    sections, off = {}, 0
    for name, shape in maf_sections(arch):
        off = _round4(off)
        size = int(torch.Size(shape).numel())
        sections[name] = layer[off:off + size].reshape(shape)
        off += size
    dev = layer.device
    shapes = _maf_dense_shapes(arch)
    for name, (rows, cols) in _maf_fragments(arch).items():
        dense = layer.new_zeros(shapes[name])
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
    hidden = tuple(arch.n_hidden)
    _, ks3 = maf_ksteps(arch)
    n = x.shape[0]
    log_det = x.new_zeros(n)
    z = x
    for layer in packed.reshape(arch.n_layers, -1):
        sec = unpack_maf_layer(arch, layer)
        if hidden:
            e1 = degree_ends(arch, hidden[0])
            h = x.new_empty((n, hidden[0]))
            for deg in range(1, len(e1)):
                seg = slice(e1[deg - 1], e1[deg])
                h[:, seg] = (z[:, :deg] @ sec["w1"][seg, :deg].t()
                             + sec["b1"][seg])
            h = torch.relu(h)
        else:
            h = torch.nn.functional.pad(
                z, (0, sec["w3"].shape[0] - d))
        for (w, b, _, _), ks in zip(hidden_products(arch),
                                    maf_product_ksteps(arch)):
            h = torch.relu(torch.cat(
                [h[:, :8 * k] @ sec[w][:8 * k, 8 * j:8 * j + 8]
                 for j, k in enumerate(ks)], dim=1) + sec[b])
        par = [sec["b3"][0, :P].expand(n, P)]
        for i in range(1, d):
            cols = slice(i * G, i * G + P)
            par.append(h[:, :8 * ks3[i]] @ sec["w3"][:8 * ks3[i], cols]
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


def maf_library(arch):
    """``(library, configuration id)`` of the MAF kernel for the flow: the
    prebuilt library's configuration where it has the shape and the
    flow's layers fit resident, else the shape's instance (its streamed
    kind where they do not), built at its first use
    (``_build.load_instance``, id 0)."""
    cfg = maf_config_id(arch)
    resident = maf_form(arch) == "resident"
    if cfg is not None and resident:
        return load_library(), cfg
    return load_instance("maf" if resident else "maf_streamed",
                         maf_row(arch)), 0


@functools.lru_cache(maxsize=None)
def _maf_library_layout(lib, cfg: int) -> tuple[int, int, tuple[int, ...]]:
    """Library ``lib``'s layout of MAF configuration ``cfg``: floats per
    layer, floats per warp buffer, and the k-steps of W2's n-tiles then
    W3's dims (MafBlocks), read once per process."""
    out = (ctypes.c_int * 4096)()
    count = lib.aspire_maf_ksteps(cfg, out, len(out))
    if not 0 <= count <= len(out):
        raise RuntimeError(f"MAF configuration {cfg} has no k-step table")
    return (lib.aspire_maf_layer_floats(cfg), lib.aspire_maf_stage_floats(cfg),
            tuple(out[:count]))


def launch_maf(arch, weights: torch.Tensor, x: torch.Tensor):
    """Launch the MAF density kernel on a CUDA ``x`` with weights already
    packed by :func:`prepare_maf_params`: the prebuilt library's
    configuration or the shape's instance (:func:`maf_library`)."""
    if not maf_takes(arch):
        raise ValueError(f"the MAF kernel does not take {arch}")
    main = load_library()
    lib, cfg = maf_library(arch)
    karch = kernel_arch(arch)
    layer, stage, ksteps = _maf_library_layout(lib, cfg)
    _check_launch(main, "MAF kernel", arch, weights, x, layer,
                  maf_layer_floats(karch), maf_shared_bytes(karch))
    if stage != maf_stage_floats(karch) or ksteps != sum(maf_ksteps(karch),
                                                         ()):
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
