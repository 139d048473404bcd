"""Continuous normalizing flow trained by conditional flow matching.

Counterpart of ``aspire_tpu/flows/matching.py``: a velocity field
``v(t, x)`` (an MLP of ``[x, t, 1 - t]``) trained with the linear-path CFM
loss; sampling integrates the ODE noise -> data and ``log_prob`` the
augmented ODE with the exact divergence, by fixed-step RK4 (``n_steps``
steps, four velocity evaluations each).

The divergence carries the ``d`` tangent directions of ``x`` through the
ReLU MLP beside the velocity: per hidden layer one product of the
``(n, d, H)`` tangents with the layer's weights and one mask of the
active units (the first two layers' in one product of the first mask,
:func:`_tangent_weights`), so a stage is a few launches whatever ``d``
is (the JAX package takes ``jacfwd`` per row). No kernel of this module is
hand-written: the JAX package runs it on XLA with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils import resolve_device, resolve_dtype
from .base import Flow
from .bijectors import standard_normal_sample
from .nets import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class _VelocityField:
    """The CNF's architecture: a velocity MLP and its fixed-step RK4
    transport, with the ``init/forward/inverse`` surface of the discrete
    architectures."""

    dims: int
    n_hidden: tuple = (128, 128, 128)
    dtype: str = "float32"
    n_steps: int = 64

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """``x`` (dims) and the time features (t, 1 - t) in, the velocity
        out; the output layer zero, so the flow starts at the identity."""
        return init_mlp(self.dims + 2, list(self.n_hidden), self.dims,
                        generator, dtype=resolve_dtype(self.dtype),
                        device=device)

    def forward(self, params, x):
        """Data -> latent (t from 1 to 0) with the log-det."""
        return _ode_integrate(params, x, self.n_steps, forward=True)

    def inverse(self, params, z):
        """Latent -> data (t from 0 to 1) with the log-det."""
        return _ode_integrate(params, z, self.n_steps, forward=False)


def _velocity(params, t, x):
    """``v(t, x)`` for a batch; ``t`` a scalar in [0, 1]. The features are
    ``[x, t, 1 - t]`` in that order, as the JAX package's."""
    tvec = torch.full((x.shape[0], 1), float(t), dtype=x.dtype,
                      device=x.device)
    return apply_mlp(params, torch.cat([x, tvec, 1.0 - tvec], dim=-1))


def _time_biases(params, t: torch.Tensor, d: int):
    """The first layer's bias with the time features folded in, for each
    time in the tensor ``t``: ``b + t w_t + (1 - t) w_(1-t)``, shape
    ``(*t.shape, H)``."""
    first = params["layers"][0]
    w = first["w"]
    t = t.unsqueeze(-1)
    return first["b"] + t * w[d] + (1.0 - t) * w[d + 1]


def _stage_times(n_steps: int, forward: bool, like: torch.Tensor):
    """The RK4 stages' times, ``(n_steps, 3)``: t, t + dt/2 and t + dt of
    every step, made on ``like``'s device (a CUDA graph captures no copy
    from the host)."""
    dt = (-1.0 if forward else 1.0) / n_steps
    t0 = 1.0 if forward else 0.0
    step = torch.arange(n_steps, dtype=like.dtype, device=like.device)
    half = 0.5 * torch.arange(3, dtype=like.dtype, device=like.device)
    return t0 + step[:, None] * dt + half * dt


def _tangent_weights(params, d: int):
    """The second layer's weights scaled by each input dim's first-layer
    row, ``(H1, d H2)``: column block j is ``diag(w1[j]) W2``, so the mask
    of the first layer's active units times it gives every ``dh2/dx_j``
    before the second mask in one product, without the ``(n, d, H1)``
    first-layer tangents."""
    layers = params["layers"]
    wx, w2 = layers[0]["w"][:d], layers[1]["w"]
    return (wx[:, :, None] * w2).permute(1, 0, 2).reshape(w2.shape[0], -1)


def _velocity_and_divergence(params, x, bias, tangent_weights=None):
    """``v(t, x)`` and its exact divergence ``tr(dv/dx)`` per row, for the
    first layer's time-folded ``bias`` (:func:`_time_biases`) and
    :func:`_tangent_weights` (made here when not given).

    The rows of ``tan`` are ``dh/dx_j`` for the current hidden layer ``h``:
    through a ReLU layer they go through the weights and the mask of the
    units the row keeps active; the output layer's diagonal is the trace.
    """
    layers = params["layers"]
    n, d = x.shape
    if tangent_weights is None:
        tangent_weights = _tangent_weights(params, d)
    a = torch.addmm(bias, x, layers[0]["w"][:d])
    h = torch.relu(a)
    # d(second layer's pre-activation)/dx_j, or dv/dx_j with one hidden layer
    tan = ((a > 0).to(x.dtype) @ tangent_weights).view(n, d, -1)
    for i, layer in enumerate(layers[1:-1]):
        a = torch.addmm(layer["b"], h, layer["w"])
        h = torch.relu(a)
        if i:
            tan = tan @ layer["w"]
        tan.mul_((a > 0).unsqueeze(1))
    out = layers[-1]
    v = torch.addmm(out["b"], h, out["w"])
    jac = tan if len(layers) == 2 else tan @ out["w"]
    return v, torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)


def _divergence(params, t, x):
    """Exact divergence of ``v(t, .)`` at each row of ``x``."""
    bias = _time_biases(params, torch.full((), float(t), dtype=x.dtype,
                                           device=x.device), x.shape[1])
    return _velocity_and_divergence(params, x, bias)[1]


def _rk4_step_with_div(params, biases, dt: float, x, logp, tw):
    """One RK4 step of the augmented ODE ``(dx, dlogp) = (v, -div v)``;
    ``biases`` holds the first layer's bias at t, t + dt/2 and t + dt,
    ``tw`` the :func:`_tangent_weights`."""
    def f(y, bias):
        return _velocity_and_divergence(params, y, bias, tw)

    k1, d1 = f(x, biases[0])
    k2, d2 = f(torch.add(x, k1, alpha=dt / 2), biases[1])
    k3, d3 = f(torch.add(x, k2, alpha=dt / 2), biases[1])
    k4, d4 = f(torch.add(x, k3, alpha=dt), biases[2])
    x_new = torch.add(x, k1 + 2 * k2 + 2 * k3 + k4, alpha=dt / 6)
    logp_new = torch.add(logp, d1 + 2 * d2 + 2 * d3 + d4, alpha=-dt / 6)
    return x_new, logp_new


def _ode_integrate(params, x, n_steps: int, forward: bool):
    """RK4 transport with the divergence accumulated; returns ``(out,
    log_det)`` in the discrete flows' convention for the direction:
    ``dt = -1/n_steps`` from t = 1 (data -> latent) or ``+1/n_steps`` from
    t = 0, and ``log_det = -delta``, delta the accumulated ``-div``."""
    dt = (-1.0 if forward else 1.0) / n_steps
    biases = _time_biases(params, _stage_times(n_steps, forward, x),
                          x.shape[1])
    tw = _tangent_weights(params, x.shape[1])
    logp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(n_steps):
        x, logp = _rk4_step_with_div(params, biases[i], dt, x, logp, tw)
    return x, -logp


def cfm_loss(params, batch, t, x0):
    """The linear-path CFM loss at draws ``t`` (n, 1) and ``x0`` (n, d):
    the mean of ``||v(t, x_t) - (x1 - x0)||^2``, ``x_t = (1 - t) x0 + t
    x1``."""
    x_t = (1 - t) * x0 + t * batch
    target = batch - x0
    feats = torch.cat([x_t, torch.cat([t, 1.0 - t], dim=-1)], dim=-1)
    v = apply_mlp(params, feats)
    return torch.mean(torch.sum((v - target) ** 2, dim=-1))


class FlowMatching(Flow):
    """A CNF proposal trained by conditional flow matching, on ``device``
    (the card, ``"cuda"``, unless the caller asks for another). Other
    keyword arguments are accepted and ignored, as the JAX package's."""

    def __init__(
        self,
        dims: int,
        data_transform=None,
        seed: int | None = None,
        dtype: str = "float32",
        device: Any = "cuda",
        n_hidden: tuple = (128, 128, 128),
        n_steps: int = 64,
        **kwargs: Any,
    ):
        from ..transforms import IdentityTransform

        self.n_steps = n_steps
        self._n_hidden = tuple(n_hidden)
        self.dims = dims
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.architecture = _VelocityField(
            dims, tuple(n_hidden), str(self.dtype).replace("torch.", ""),
            n_steps)
        self.data_transform = data_transform or IdentityTransform(
            dtype=self.dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0 if seed is None else int(seed))
        self.params = self.architecture.init(self.generator, self.device)

    def config_dict(self) -> dict:
        return {
            "dims": self.dims,
            "architecture": "flow_matching",
            "dtype": str(self.dtype).replace("torch.", ""),
            "architecture_config": {
                "n_hidden": list(self._n_hidden),
                "n_steps": self.n_steps,
            },
        }

    def loss_fn(self, params, batch) -> torch.Tensor:
        """The CFM loss at fresh draws of ``t ~ U(0, 1)`` and ``x0 ~ N(0,
        I)`` from the flow's generator: each training batch and each
        validation loss draws its own."""
        t = torch.rand((batch.shape[0], 1), generator=self.generator,
                       dtype=batch.dtype, device=batch.device)
        x0 = standard_normal_sample(batch.shape, self.generator,
                                    dtype=batch.dtype, device=batch.device)
        return cfm_loss(params, batch, t, x0)
