"""Dtype/device resolution and converters from the JAX package's state.

The port never imports JAX. The converters take the JAX package's flow
parameter pytree (nested dicts of arrays) and its fitted transform
objects duck-typed: anything ``numpy.asarray`` can read is accepted, so a
JAX array, a numpy array or a list all convert the same way.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable

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


def require_module(name: str, what: str):
    """Import ``name`` at first use (h5py, matplotlib, pandas: none is
    needed to run a sampler, and the card's machine has none); an
    ``ImportError`` naming the package where it is missing."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        raise ImportError(
            f"{what} needs the {name.split('.')[0]!r} package, which is not "
            f"installed here ({err})") from err


def dtype_name(dtype: Any) -> str | None:
    """A dtype's name as the JAX package writes it (``"float32"``)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def to_numpy(x: Any) -> np.ndarray | None:
    """A tensor (on any device) or array-like as a host numpy array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


# -- call tracking (the JAX package's ``track_calls``) ---------------------


@dataclasses.dataclass
class CallHistory:
    """Record of calls to a tracked method (args/kwargs per call)."""

    calls: list = dataclasses.field(default_factory=list)

    def add_call(self, args: tuple, kwargs: dict) -> None:
        self.calls.append({"args": args, "kwargs": kwargs})

    @property
    def last(self) -> dict | None:
        return self.calls[-1] if self.calls else None

    def to_dict(self) -> dict:
        return {str(i): {"args": _sanitize_for_config(call["args"]),
                         "kwargs": _sanitize_for_config(call["kwargs"])}
                for i, call in enumerate(self.calls)}


def _sanitize_for_config(obj: Any) -> Any:
    """Call arguments in a storable form: callables as id strings, tensors
    as host arrays."""
    if callable(obj) and not isinstance(obj, type):
        return function_id(obj)
    if isinstance(obj, dict):
        return {k: _sanitize_for_config(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_sanitize_for_config(v) for v in obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return to_numpy(obj)
    return obj


def track_calls(method: Callable) -> Callable:
    """Record every call of ``method`` on the instance, under
    ``_call_history[method_name]`` (read by ``Sampler.config_dict``)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if not hasattr(self, "_call_history"):
            self._call_history = {}
        self._call_history.setdefault(
            method.__name__, CallHistory()).add_call(args, kwargs)
        return method(self, *args, **kwargs)

    return wrapper


def function_id(fn: Callable) -> str | None:
    """``module:qualname`` of a callable: user functions are recorded by id
    and supplied again on resume, never pickled."""
    if fn is None:
        return None
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", getattr(fn, "__name__", None))
    if qualname is None:
        qualname = type(fn).__qualname__
        module = type(fn).__module__
    return f"{module}:{qualname}"
