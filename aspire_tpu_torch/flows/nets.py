"""Conditioner networks over a plain parameter dict: the MLP of a coupling
layer and the MADE of a masked autoregressive layer.

Counterpart of ``aspire_tpu/flows/nets.py``. Parameters keep the JAX
package's nesting and layout, ``{"layers": [{"w": (in, out), "b": (out,)},
...]}``, for both networks; MADE masks are static tensors kept outside the
parameters, so an optimizer never touches them.
"""

from __future__ import annotations

import math

import torch


def _init_dense(n_in: int, n_out: int, generator: torch.Generator,
                dtype, device) -> dict:
    scale = 1.0 / math.sqrt(max(n_in, 1))
    w = torch.rand((n_in, n_out), generator=generator, dtype=dtype,
                   device=device)
    return {"w": (2.0 * w - 1.0) * scale,
            "b": torch.zeros((n_out,), dtype=dtype, device=device)}


def init_mlp(n_in: int, n_hidden: list[int], n_out: int,
             generator: torch.Generator, dtype=torch.float32,
             device="cpu") -> dict:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, zero biases and a
    zero output layer, so the flow starts at the identity."""
    sizes = [n_in] + list(n_hidden) + [n_out]
    layers = [
        _init_dense(sizes[i], sizes[i + 1], generator, dtype, device)
        for i in range(len(sizes) - 1)
    ]
    layers[-1]["w"] = torch.zeros_like(layers[-1]["w"])
    return {"layers": layers}


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    h = x
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = layers[-1]
    return h @ out["w"] + out["b"]


def made_masks(dims: int, n_hidden: list[int], n_params_per_dim: int
               ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """MADE masks for the sequential input degrees ``1..dims``.

    Hidden degrees cycle over ``1..max(dims - 1, 1)``; a hidden unit sees
    the inputs of degree <= its own, and the ``n_params_per_dim`` outputs
    of dim ``i`` see only hidden units of degree < ``i + 1``, so the
    conditioner is strictly autoregressive. Returns ``(masks, degrees)``
    with float32 ``(in, out)`` masks, as the JAX package's ``made_masks``.
    """
    degrees = [torch.arange(1, dims + 1)]
    max_deg = max(dims - 1, 1)
    for h in n_hidden:
        degrees.append(torch.arange(h) % max_deg + 1)
    masks = [(d_out[None, :] >= d_in[:, None]).to(torch.float32)
             for d_in, d_out in zip(degrees[:-1], degrees[1:])]
    out_deg = torch.arange(1, dims + 1).repeat_interleave(n_params_per_dim)
    masks.append((out_deg[None, :] > degrees[-1][:, None]).to(torch.float32))
    return masks, degrees[0]


def init_made(dims: int, n_hidden: list[int], n_params_per_dim: int,
              generator: torch.Generator, dtype=torch.float32,
              device="cpu") -> tuple[dict, list[torch.Tensor]]:
    """A MADE producing ``n_params_per_dim`` outputs per input dim, with the
    MLP's initialisation (zero output layer). Returns ``(params, masks)``."""
    params = init_mlp(dims, list(n_hidden), dims * n_params_per_dim,
                      generator, dtype=dtype, device=device)
    masks, _ = made_masks(dims, list(n_hidden), n_params_per_dim)
    return params, [m.to(dtype=dtype, device=device) for m in masks]


def apply_made(params: dict, masks: list[torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """Masked forward pass, ``(batch, dims * n_params_per_dim)`` laid out
    ``[dim0_p0, dim0_p1, ..., dim1_p0, ...]``."""
    layers = params["layers"]
    h = x
    for layer, mask in zip(layers[:-1], masks[:-1]):
        h = torch.relu(h @ (layer["w"] * mask) + layer["b"])
    out = layers[-1]
    return h @ (out["w"] * masks[-1]) + out["b"]
