"""Flow architectures as plain functions over a parameter dict.

Counterpart of ``aspire_tpu/flows/architectures.py``: masked
autoregressive flows (MAF, affine or RQS transformer) and coupling flows
(RealNVP, NSF). An architecture is a frozen config exposing

- ``init(generator, device) -> params``      (nested parameter dict)
- ``forward(params, x) -> (z, log_det)``     data -> latent (density pass)
- ``inverse(params, z) -> (x, log_det)``     latent -> data (sampling pass)

Where a hand-written CUDA kernel exists (:mod:`aspire_tpu_torch.ops.
fused_coupling`: both coupling passes, and the MAF-RQS density pass) the
pass dispatches to it when its predicate holds (a CUDA float32 batch of
at least ``MIN_FUSED_N`` rows in a configuration the kernel is built
for); otherwise it runs the plain torch path, as the JAX package leaves
small batches to XLA. The MAF sampling pass is a sequential solve over
dims and always runs plain, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..utils import resolve_dtype
from .bijectors import (
    affine_forward,
    affine_inverse,
    constrain_log_scale,
    rational_quadratic_spline,
)
from .nets import apply_made, apply_mlp, init_made, init_mlp, made_masks


@dataclasses.dataclass(frozen=True)
class Architecture:
    dims: int
    n_layers: int = 4
    n_hidden: tuple = (64, 64)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def n_params_per_dim(self) -> int:
        """Transformer parameters per dim (subclasses with a transformer)."""
        if self.transformer == "affine":
            return 2
        return 3 * self.num_bins - 1

    def _elementwise(self, x, h, inverse: bool):
        """The transformer of every dim of ``x`` given its parameters ``h``
        (``(batch, dims, n_params_per_dim)``); elementwise log-dets."""
        if self.transformer == "affine":
            fn = affine_inverse if inverse else affine_forward
            return fn(x, h[..., 0], constrain_log_scale(h[..., 1]))
        return rational_quadratic_spline(x, h, self.num_bins,
                                         self.tail_bound, inverse=inverse)


@functools.lru_cache(maxsize=None)
def _masks_on(dims: int, n_hidden: tuple, n_params: int, device, dtype):
    masks, _ = made_masks(dims, list(n_hidden), n_params)
    return tuple(m.to(device=device, dtype=dtype) for m in masks)


@dataclasses.dataclass(frozen=True)
class MAF(Architecture):
    """Masked autoregressive flow with an affine or RQS transformer: per
    layer one MADE of the layer's input gives every dim's transformer
    parameters, and the dims are reversed after every layer."""

    transformer: str = "affine"  # "affine" | "rqs"
    num_bins: int = 8
    tail_bound: float = 5.0

    def masks(self, like: torch.Tensor) -> tuple:
        """The static MADE masks on ``like``'s device and dtype."""
        return _masks_on(self.dims, tuple(self.n_hidden),
                         self.n_params_per_dim, like.device, like.dtype)

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        return {
            "layers": [
                init_made(self.dims, list(self.n_hidden),
                          self.n_params_per_dim, generator,
                          dtype=self.torch_dtype, device=device)[0]
                for _ in range(self.n_layers)
            ]
        }

    def _transform(self, h, x, inverse: bool):
        h = h.reshape(x.shape[0], self.dims, self.n_params_per_dim)
        y, eld = self._elementwise(x, h, inverse)
        return y, eld.sum(-1)

    def forward_plain(self, params, x):
        """Per layer: MADE of the input, inverse transformer of every dim,
        then the dims reversed (also after the last layer)."""
        masks = self.masks(x)
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        z = x
        for layer in params["layers"]:
            z, ld = self._transform(apply_made(layer, masks, z), z,
                                    inverse=True)
            log_det = log_det + ld
            z = z.flip(-1)
        return z, log_det

    def inverse_plain(self, params, z):
        """Autoregressive solve: per layer ``dims + 1`` MADE evaluations,
        dim ``i`` fixed by the ``i``-th (it sees only dims ``< i``)."""
        masks = self.masks(z)
        cols = torch.arange(self.dims, device=z.device)
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        x = z
        for layer in reversed(params["layers"]):
            latent = x.flip(-1)
            y = torch.zeros_like(latent)
            for i in range(self.dims):
                cand, _ = self._transform(apply_made(layer, masks, y),
                                          latent, inverse=False)
                y = torch.where(cols == i, cand, y)
            x, ld = self._transform(apply_made(layer, masks, y), latent,
                                    inverse=False)
            log_det = log_det + ld
        return x, log_det

    def forward(self, params, x):
        """Data -> latent; the CUDA MAF-RQS kernel where it applies."""
        from ..ops.fused_coupling import fused_maf_forward, should_fuse_maf

        if should_fuse_maf(self, x):
            return fused_maf_forward(self, params, x)
        return self.forward_plain(params, x)

    def inverse(self, params, z):
        """Latent -> data; always the plain sequential solve."""
        return self.inverse_plain(params, z)


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
        y, eld = self._elementwise(x, h, inverse)
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


def maf(dims: int, **kwargs) -> MAF:
    kwargs.setdefault("transformer", "affine")
    return MAF(dims=dims, **kwargs)


def maf_rqs(dims: int, **kwargs) -> MAF:
    kwargs.setdefault("transformer", "rqs")
    return MAF(dims=dims, **kwargs)


ARCHITECTURES = {
    "maf": maf,
    "maf-rqs": maf_rqs,
    "nsf": nsf,
    "nsf-tpu": nsf_tpu,
    "realnvp": realnvp,
    "coupling": nsf,
}


def get_architecture(name: str, dims: int, **kwargs) -> Architecture:
    key = name.lower()
    if key not in ARCHITECTURES:
        raise ValueError(
            f"Unknown flow architecture '{name}'. "
            f"Choose from {sorted(ARCHITECTURES)}"
        )
    if "n_hidden" in kwargs:
        kwargs["n_hidden"] = tuple(kwargs["n_hidden"])
    return ARCHITECTURES[key](dims, **kwargs)
