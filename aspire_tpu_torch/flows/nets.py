"""MLP conditioner over a plain parameter dict.

Counterpart of the MLP half of ``aspire_tpu/flows/nets.py`` (MADE is not
ported yet). Parameters keep the JAX package's nesting and layout:
``{"layers": [{"w": (in, out), "b": (out,)}, ...]}``.
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
