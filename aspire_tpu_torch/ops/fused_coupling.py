"""Wrappers for the CUDA flow kernels: the coupling flow (density and
sampling passes) and the MAF-RQS density pass.

Counterpart of ``aspire_tpu/ops/fused_coupling.py``. Each kernel
(``csrc/coupling.cu``, ``csrc/maf.cu``) runs every layer of the flow for
one particle per thread, with all layers' weights in shared memory; this
module packs those weights, checks and launches, counts launches, and
wraps the call in a ``torch.autograd.Function`` whose backward recomputes
through the plain torch path (the JAX package's ``custom_vjp``).

On a CPU tensor a wrapper runs the plain torch version
(``Coupling.forward_plain``/``inverse_plain``, ``MAF.forward_plain``); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..flows.architectures import MAF, Coupling
from ._build import LaunchCounter, check, load_library

#: Below this batch the plain path is already launch-bound; training
#: batches stay on the plain autograd path (the JAX package's threshold).
MIN_FUSED_N = 4096

#: (transformer, dims, n_hidden, num_bins) -> configuration id compiled
#: into the library; mirrors ASPIRE_COUPLING_CONFIGS in csrc/common.cuh.
KERNEL_CONFIGS = {
    ("rqs", 4, (64, 64), 8): 0,
    ("affine", 4, (64, 64), None): 1,
}

#: (dims, n_hidden, num_bins) of an RQS MAF -> configuration id of the MAF
#: density kernel; mirrors ASPIRE_MAF_CONFIGS in csrc/common.cuh. A table
#: of its own, so a MAF is never packed for the coupling kernel.
MAF_KERNEL_CONFIGS = {
    (4, (64, 64), 8): 0,
}

#: Shared memory one block may hold on an H100 (227 KB).
MAX_SHARED_BYTES = 232448

launches = LaunchCounter()
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


def layer_floats(arch) -> int:
    """Floats per layer of the packed buffer (csrc/common.cuh Shape::SIZE)."""
    d = arch.dims
    h1, h2 = arch.n_hidden
    outp = _round4(((d + 1) // 2) * arch.n_params_per_dim)
    return _packed_floats((h1 * d, h1, h2 * h1, h2, h2 * outp, outp))


def weight_bytes(arch) -> int:
    return 4 * arch.n_layers * layer_floats(arch)


def should_fuse(arch, x: torch.Tensor) -> bool:
    """True when the CUDA kernel applies to this (architecture, batch)."""
    return (
        x.is_cuda
        and x.dim() == 2
        and x.shape[0] >= MIN_FUSED_N
        and x.dtype == torch.float32
        and len(arch.n_hidden) == 2
        and config_id(arch) is not None
        and weight_bytes(arch) <= MAX_SHARED_BYTES
    )


def prepare_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's MLP weights into the kernel's flat layout.

    Per layer: W1 (H1, D), b1, W2 (H2, H1), b2, W3 (H2, OUTP), b3 - the
    output layer keeps only the parameter columns of the dims the layer
    transforms (group ``i // 2`` for active dim ``i``; a zero group pads
    odd ``D``), as the JAX package's ``prepare_params`` does.
    """
    d = arch.dims
    P = arch.n_params_per_dim
    a = (d + 1) // 2
    outp = _round4(a * P)
    chunks = []
    for layer, net in enumerate(params["layers"]):
        (l1, l2, l3) = net["layers"]
        w3 = l3["w"].reshape(l3["w"].shape[0], d, P)
        b3 = l3["b"].reshape(d, P)
        w3_sel = torch.zeros(w3.shape[0], a, P, dtype=w3.dtype,
                             device=w3.device)
        b3_sel = torch.zeros(a, P, dtype=w3.dtype, device=w3.device)
        for i in range(d):
            if (i % 2) == (layer % 2):
                w3_sel[:, i // 2] = w3[:, i]
                b3_sel[i // 2] = b3[i]
        w3_sel = w3_sel.reshape(w3.shape[0], a * P)
        _append_sections(chunks, [
            l1["w"].t(), l1["b"], l2["w"].t(), l2["b"],
            torch.nn.functional.pad(w3_sel, (0, outp - a * P)),
            torch.nn.functional.pad(b3_sel.reshape(-1), (0, outp - a * P)),
        ])
    return _concat(chunks, arch.n_layers * layer_floats(arch), arch)


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


def _concat(chunks: list, floats: int, arch) -> torch.Tensor:
    out = torch.cat(chunks).to(torch.float32).contiguous()
    if out.numel() != floats:
        raise ValueError(f"parameters do not match {arch}")
    return out


def _check_launch(lib, what: str, arch, weights: torch.Tensor,
                  x: torch.Tensor, layer_floats_lib: int,
                  layer_floats_py: int) -> None:
    """Refuse what a flow kernel does not take, before launching it."""
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"the {what} takes float32 only")
    if x.dim() != 2 or x.shape[1] != arch.dims:
        raise ValueError(f"expected (n, {arch.dims}) input, got {tuple(x.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"the {what} takes contiguous tensors")
    if weights.device != x.device:
        raise ValueError("weights and input must be on the same device")
    smem = 4 * weights.numel()
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(
            f"flow weights ({smem} bytes) exceed one block's shared memory"
        )
    if layer_floats_lib != layer_floats_py:
        raise RuntimeError("packed layout disagrees with the kernel library")


def launch_packed(arch, mode: str, weights: torch.Tensor,
                  x: torch.Tensor):
    """Launch the kernel on a CUDA ``x`` with weights already packed by
    :func:`prepare_params`."""
    lib = load_library()
    cfg = config_id(arch)
    if cfg is None:
        raise ValueError(f"no coupling kernel compiled for {arch}")
    _check_launch(lib, "coupling kernel", arch, weights, x,
                  lib.aspire_layer_floats(cfg), layer_floats(arch))
    n = x.shape[0]
    z = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    code = lib.aspire_coupling(
        x.data_ptr(), z.data_ptr(), ld.data_ptr(), weights.data_ptr(),
        n, arch.n_layers, float(arch.tail_bound), cfg,
        1 if mode == "forward" else 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    launches.count += 1
    check(code, "coupling kernel")
    return z, ld


def coupling_kernel_apply(arch, mode: str, params: dict, x: torch.Tensor):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        fn = arch.forward_plain if mode == "forward" else arch.inverse_plain
        return fn(params, x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return launch_packed(arch, mode, prepare_params(arch, params), x)


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
    """Floats per dim's parameter group: ``3K - 1`` rounded up to 4."""
    return _round4(arch.n_params_per_dim)


def maf_sections(arch) -> list[tuple[str, tuple]]:
    """Sections of one layer of the packed MAF buffer, in order, with
    their shapes (csrc/common.cuh MafShape): W1 ``(H1, D)``, b1,
    W2 ``(H1, H2)`` (input-major), b2, W3 ``(D, H2, G)``, b3 ``(D, G)``."""
    d, (h1, h2), g = arch.dims, tuple(arch.n_hidden), maf_group(arch)
    return [("w1", (h1, d)), ("b1", (h1,)), ("w2", (h1, h2)), ("b2", (h2,)),
            ("w3", (d, h2, g)), ("b3", (d, g))]


def maf_layer_floats(arch) -> int:
    """Floats per layer of the packed MAF buffer (MafShape::SIZE)."""
    return _packed_floats(int(torch.Size(shape).numel())
                          for _, shape in maf_sections(arch))


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
        and 4 * arch.n_layers * maf_layer_floats(arch) <= MAX_SHARED_BYTES
    )


def prepare_maf_params(arch, params: dict) -> torch.Tensor:
    """Pack every layer's MADE into the MAF kernel's flat layout, weights
    premultiplied by their masks (the JAX package's
    ``prepare_maf_params``); dim ``i``'s output columns become the
    zero-padded group ``W3[i]`` of ``maf_group(arch)`` floats per hidden
    unit."""
    d, P, G = arch.dims, arch.n_params_per_dim, maf_group(arch)
    chunks = []
    for net in params["layers"]:
        l1, l2, l3 = net["layers"]
        m1, m2, m3 = arch.masks(l1["w"])
        h2 = l3["w"].shape[0]
        w3 = (l3["w"] * m3).reshape(h2, d, P).permute(1, 0, 2)
        _append_sections(chunks, [
            (l1["w"] * m1).t(), l1["b"], l2["w"] * m2, l2["b"],
            torch.nn.functional.pad(w3, (0, G - P)),
            torch.nn.functional.pad(l3["b"].reshape(d, P), (0, G - P)),
        ])
    return _concat(chunks, arch.n_layers * maf_layer_floats(arch), arch)


_maf_pack_cache: dict = {}


def packed_maf_params(arch, params: dict) -> torch.Tensor:
    """:func:`prepare_maf_params`, packed once per set of parameters.

    The last packing is kept with the parameter tensors themselves and
    their in-place version counters, so the ``n_steps + 2`` density passes
    of a split-chain mutation pack once; a new or updated tensor packs
    anew (an update made through ``.data`` bypasses the version counter
    and is not seen).
    """
    _, leaves = _flatten(params)
    key = (arch, tuple(t._version for t in leaves))
    hit = _maf_pack_cache.get("key")
    if (hit is not None and hit[0] == key
            and len(hit[1]) == len(leaves)
            and all(a is b for a, b in zip(hit[1], leaves))):
        return _maf_pack_cache["packed"]
    packed = prepare_maf_params(arch, params)
    _maf_pack_cache.update(key=(key, tuple(leaves)), packed=packed)
    return packed


def launch_maf(arch, weights: torch.Tensor, x: torch.Tensor):
    """Launch the MAF density kernel on a CUDA ``x`` with weights already
    packed by :func:`prepare_maf_params`."""
    lib = load_library()
    cfg = maf_config_id(arch)
    if cfg is None:
        raise ValueError(f"no MAF kernel compiled for {arch}")
    _check_launch(lib, "MAF kernel", arch, weights, x,
                  lib.aspire_maf_layer_floats(cfg), maf_layer_floats(arch))
    n = x.shape[0]
    z = torch.empty_like(x)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
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
    return launch_maf(arch, packed_maf_params(arch, params), x.contiguous())


def fused_maf_forward(arch, params: dict, x: torch.Tensor):
    """MAF density pass with the semantics of ``MAF.forward_plain``;
    differentiable in ``x`` and the parameters, with the backward pass
    recomputed through the plain path."""
    treedef, leaves = _flatten(params)
    return _FusedPass.apply(functools.partial(maf_kernel_apply, arch),
                            arch.forward_plain, treedef, x, *leaves)
