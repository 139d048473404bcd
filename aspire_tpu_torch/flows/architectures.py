"""Coupling-flow architectures as plain functions over a parameter dict.

Counterpart of ``aspire_tpu/flows/architectures.py`` (the MAF family is
not ported yet). An architecture is a frozen config exposing

- ``init(generator, device) -> params``      (nested parameter dict)
- ``forward(params, x) -> (z, log_det)``     data -> latent (density pass)
- ``inverse(params, z) -> (x, log_det)``     latent -> data (sampling pass)

``forward``/``inverse`` dispatch to the hand-written CUDA coupling kernel
(:mod:`aspire_tpu_torch.ops.fused_coupling`) when its predicate holds
(a CUDA float32 batch of at least ``MIN_FUSED_N`` rows in a configuration
the kernel is built for); otherwise they run the plain torch path, as
the JAX package leaves small batches to XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import resolve_dtype
from .bijectors import (
    affine_forward,
    affine_inverse,
    constrain_log_scale,
    rational_quadratic_spline,
)
from .nets import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class Architecture:
    dims: int
    n_layers: int = 4
    n_hidden: tuple = (64, 64)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)


def coupling_masks(dims: int, n_layers: int, device="cpu"):
    """Alternating masks; ``True`` marks the conditioning half."""
    base = torch.arange(dims, device=device) % 2
    return [((base + i) % 2).bool() for i in range(n_layers)]


@dataclasses.dataclass(frozen=True)
class Coupling(Architecture):
    """Coupling flow: an MLP on one half conditions the transformer of the
    other. ``transformer="rqs"`` is a neural spline flow, ``"affine"`` is
    RealNVP."""

    transformer: str = "rqs"
    num_bins: int = 8
    tail_bound: float = 5.0

    @property
    def n_params_per_dim(self) -> int:
        if self.transformer == "affine":
            return 2
        return 3 * self.num_bins - 1

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        return {
            "layers": [
                init_mlp(
                    self.dims,
                    list(self.n_hidden),
                    self.dims * self.n_params_per_dim,
                    generator,
                    dtype=self.torch_dtype,
                    device=device,
                )
                for _ in range(self.n_layers)
            ]
        }

    def _transform(self, params_net, x, mask, inverse: bool):
        batch = x.shape[0]
        h = apply_mlp(params_net, torch.where(mask, x, torch.zeros_like(x)))
        h = h.reshape(batch, self.dims, self.n_params_per_dim)
        if self.transformer == "affine":
            shift = h[..., 0]
            log_scale = constrain_log_scale(h[..., 1])
            fn = affine_inverse if inverse else affine_forward
            y, eld = fn(x, shift, log_scale)
        else:
            y, eld = rational_quadratic_spline(
                x, h, self.num_bins, self.tail_bound, inverse=inverse
            )
        y = torch.where(mask, x, y)
        eld = torch.where(mask, torch.zeros_like(eld), eld)
        return y, eld.sum(-1)

    def forward_plain(self, params, x):
        masks = coupling_masks(self.dims, self.n_layers, x.device)
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        z = x
        for layer, mask in zip(params["layers"], masks):
            z, ld = self._transform(layer, z, mask, inverse=True)
            log_det = log_det + ld
        return z, log_det

    def inverse_plain(self, params, z):
        masks = coupling_masks(self.dims, self.n_layers, z.device)
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        x = z
        for layer, mask in zip(reversed(params["layers"]), reversed(masks)):
            x, ld = self._transform(layer, x, mask, inverse=False)
            log_det = log_det + ld
        return x, log_det

    def forward(self, params, x):
        """Data -> latent; the CUDA coupling kernel where it applies."""
        from ..ops.fused_coupling import fused_coupling_apply, should_fuse

        if should_fuse(self, x):
            return fused_coupling_apply(self, "forward", params, x)
        return self.forward_plain(params, x)

    def inverse(self, params, z):
        """Latent -> data; the CUDA coupling kernel where it applies."""
        from ..ops.fused_coupling import fused_coupling_apply, should_fuse

        if should_fuse(self, z):
            return fused_coupling_apply(self, "inverse", params, z)
        return self.inverse_plain(params, z)


def realnvp(dims: int, **kwargs) -> Coupling:
    kwargs.setdefault("transformer", "affine")
    return Coupling(dims=dims, **kwargs)


def nsf(dims: int, **kwargs) -> Coupling:
    kwargs.setdefault("transformer", "rqs")
    return Coupling(dims=dims, **kwargs)


def nsf_tpu(dims: int, **kwargs) -> Coupling:
    """The JAX package's tuned NSF preset: 3 layers x (64, 64) x 8 bins."""
    kwargs.setdefault("transformer", "rqs")
    kwargs.setdefault("n_layers", 3)
    kwargs.setdefault("n_hidden", (64, 64))
    kwargs.setdefault("num_bins", 8)
    return Coupling(dims=dims, **kwargs)


ARCHITECTURES = {
    "nsf": nsf,
    "nsf-tpu": nsf_tpu,
    "realnvp": realnvp,
    "coupling": nsf,
}


def get_architecture(name: str, dims: int, **kwargs) -> Coupling:
    key = name.lower()
    if key not in ARCHITECTURES:
        raise ValueError(
            f"Unknown flow architecture '{name}'. "
            f"Choose from {sorted(ARCHITECTURES)}"
        )
    if "n_hidden" in kwargs:
        kwargs["n_hidden"] = tuple(kwargs["n_hidden"])
    return ARCHITECTURES[key](dims, **kwargs)
