"""Dtype/device resolution and converters from the JAX package's state.

The port never imports JAX. The converters take the JAX package's flow
parameter pytree (nested dicts of arrays) and its fitted transform
objects duck-typed: anything ``numpy.asarray`` can read is accepted, so a
JAX array, a numpy array or a list all convert the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def resolve_dtype(dtype: Any) -> torch.dtype | None:
    """Resolve a dtype given as a string, numpy dtype, torch dtype or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype!r}") from None


def resolve_device(device: Any) -> torch.device:
    """The device asked for; ``None`` means the card (``"cuda"``). Nothing
    checks for a GPU: without one, the first tensor made there raises."""
    return torch.device("cuda" if device is None else device)


def as_tensor(x: Any, dtype: Any = None, device: Any = None) -> torch.Tensor:
    """Tensor view of array-like input (no copy when already matching)."""
    dtype = resolve_dtype(dtype)
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype if dtype is not None else x.dtype)
    arr = np.asarray(x)
    t = torch.as_tensor(arr)
    return t.to(device=device if device is not None else "cpu",
                dtype=dtype if dtype is not None else t.dtype)


def flow_params_from_jax(tree: dict, dtype: Any = None,
                         device: Any = "cpu") -> dict:
    """Convert a JAX flow parameter pytree to the port's parameter dict.

    ``tree`` is ``{"layers": [{"layers": [{"w", "b"}, ...]}, ...]}``
    (``aspire_tpu/flows/nets.py`` MLPs stacked by
    ``aspire_tpu/flows/architectures.py``); the port keeps the same
    nesting and the same ``(in, out)`` weight layout.
    """
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return as_tensor(np.array(node), dtype=dtype, device=device)

    return convert(tree)


def transform_from_jax(transform, dtype: Any = None, device: Any = "cpu"):
    """Rebuild a fitted JAX transform (Identity/Affine/Logit/Probit/
    Periodic/Composite/FlowTransform/FlowPreconditioningTransform) as the
    port's equivalent.

    Reads the object's ``config_dict()``, for the affine part its fitted
    ``_mean``/``_std`` arrays, and for a flow preconditioning its inner
    flow's ``_params`` and ``_inner_data_transform`` (the architecture
    comes from its ``flow_kwargs``, as the JAX package's ``_arch`` does).
    """
    from . import transforms as T

    name = type(transform).__name__
    if name == "IdentityTransform":
        return T.IdentityTransform(dtype=dtype, device=device)
    config = dict(transform.config_dict())
    config["dtype"] = dtype
    config["device"] = device
    if name == "AffineTransform":
        out = T.AffineTransform(dtype=dtype, device=device)
        _copy_affine_state(transform, out, dtype, device)
        return out
    if name in ("LogitTransform", "ProbitTransform", "PeriodicTransform"):
        return getattr(T, name)(**config)
    if name in ("CompositeTransform", "FlowTransform"):
        out = getattr(T, name)(**config)
        sub = getattr(transform, "_affine_transform", None)
        if sub is not None and out._affine_transform is not None:
            _copy_affine_state(sub, out._affine_transform, dtype, device)
        return out
    if name == "FlowPreconditioningTransform":
        out = T.FlowPreconditioningTransform(**config)
        if getattr(transform, "_params", None) is not None:
            out._rebuild_flow(
                transform_from_jax(transform._inner_data_transform,
                                   dtype=dtype, device=device),
                flow_params_from_jax(transform._params, dtype=dtype,
                                     device=device))
        return out
    raise ValueError(f"Cannot convert transform of type {name}")


def flow_matching_from_jax(flow, dtype: Any = None, device: Any = "cpu"):
    """The port's :class:`~aspire_tpu_torch.flows.FlowMatching` with the
    width, step count, parameters and fitted data transform of a JAX
    package ``FlowMatching``."""
    from .flows.matching import FlowMatching

    cfg = flow.config_dict()
    dtype = dtype if dtype is not None else cfg["dtype"]
    out = FlowMatching(
        dims=cfg["dims"], dtype=dtype, device=device,
        data_transform=transform_from_jax(flow.data_transform, dtype=dtype,
                                          device=device),
        **cfg["architecture_config"])
    out.params = flow_params_from_jax(flow.params, dtype=dtype,
                                      device=device)
    return out


def _copy_affine_state(src, dst, dtype, device) -> None:
    if getattr(src, "_mean", None) is None:
        return
    dst._mean = as_tensor(np.array(src._mean), dtype=dtype, device=device)
    dst._std = as_tensor(np.array(src._std), dtype=dtype, device=device)
