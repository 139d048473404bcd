"""Wrapper for the CUDA coupling-flow kernel (density and sampling passes).

Counterpart of ``aspire_tpu/ops/fused_coupling.py``. The kernel
(``csrc/coupling.cu``) runs every coupling layer of the flow for one
particle per thread, with all layers' weights in shared memory; this
module packs those weights, checks and launches, counts launches, and
wraps the call in a ``torch.autograd.Function`` whose backward recomputes
through the plain torch path (the JAX package's ``custom_vjp``).

On a CPU tensor the wrapper runs the plain torch version
(``Coupling.forward_plain``/``inverse_plain``); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

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

#: Shared memory one block may hold on an H100 (227 KB).
MAX_SHARED_BYTES = 232448

launches = LaunchCounter()


def config_id(arch) -> int | None:
    bins = arch.num_bins if arch.transformer == "rqs" else None
    return KERNEL_CONFIGS.get(
        (arch.transformer, arch.dims, tuple(arch.n_hidden), bins)
    )


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def layer_floats(arch) -> int:
    """Floats per layer of the packed buffer (csrc/common.cuh Shape::SIZE)."""
    d = arch.dims
    h1, h2 = arch.n_hidden
    outp = _round4(((d + 1) // 2) * arch.n_params_per_dim)
    size = 0
    for section in (h1 * d, h1, h2 * h1, h2, h2 * outp, outp):
        size = _round4(size) + section
    return _round4(size)


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
        sections = [
            l1["w"].t().reshape(-1), l1["b"],
            l2["w"].t().reshape(-1), l2["b"],
            torch.nn.functional.pad(w3_sel, (0, outp - a * P)).reshape(-1),
            torch.nn.functional.pad(b3_sel.reshape(-1), (0, outp - a * P)),
        ]
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
    out = torch.cat(chunks).to(torch.float32).contiguous()
    if out.numel() != arch.n_layers * layer_floats(arch):
        raise ValueError(f"parameters do not match {arch}")
    return out


def launch_packed(arch, mode: str, weights: torch.Tensor,
                  x: torch.Tensor):
    """Launch the kernel on a CUDA ``x`` with weights already packed by
    :func:`prepare_params`."""
    lib = load_library()
    cfg = config_id(arch)
    if cfg is None:
        raise ValueError(f"no coupling kernel compiled for {arch}")
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("the coupling kernel takes float32 only")
    if x.dim() != 2 or x.shape[1] != arch.dims:
        raise ValueError(f"expected (n, {arch.dims}) input, got {tuple(x.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("the coupling kernel takes contiguous tensors")
    if weights.device != x.device:
        raise ValueError("weights and input must be on the same device")
    smem = 4 * weights.numel()
    if smem > lib.aspire_max_shared_bytes():
        raise ValueError(
            f"flow weights ({smem} bytes) exceed one block's shared memory"
        )
    if lib.aspire_layer_floats(cfg) != layer_floats(arch):
        raise RuntimeError("packed layout disagrees with the kernel library")
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


class _FusedCoupling(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arch, mode, treedef, x, *leaves):
        params = _unflatten(treedef, leaves)
        with torch.no_grad():
            z, ld = coupling_kernel_apply(arch, mode, params, x)
        ctx.arch, ctx.mode, ctx.treedef = arch, mode, treedef
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
            fn = (ctx.arch.forward_plain if ctx.mode == "forward"
                  else ctx.arch.inverse_plain)
            z, ld = fn(params, x)
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
    return _FusedCoupling.apply(arch, mode, treedef, x, *leaves)
