"""Invertible data transforms with log-abs-det Jacobians.

Counterpart of ``aspire_tpu/transforms.py``. Every ``forward``/``inverse``
returns ``(y, log_j)`` with the Jacobian reduced over the feature axis,
shape ``(n,)``. Fitted state (the affine mean/std, a preconditioning
flow's parameters) lives on the transform's device. Every transform saves
to and loads from HDF5 in the JAX package's layout (a group with its class
name, its config and its fitted state: a file of either package loads in
the other), and gives its fitted state as host arrays for a checkpoint
(:meth:`BaseTransform.host_state`).
"""

from __future__ import annotations

import logging
import math
from typing import Any

import numpy as np
import torch

from .utils import as_tensor, resolve_dtype, to_numpy

logger = logging.getLogger("aspire_tpu_torch")

_TRANSFORM_REGISTRY: dict[str, type] = {}


def register_transform(cls):
    """Register ``cls`` by name for :meth:`BaseTransform.load`."""
    _TRANSFORM_REGISTRY[cls.__name__] = cls
    return cls


def get_transform_class(name: str) -> type:
    try:
        return _TRANSFORM_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown transform class: {name}") from None


def _name_list(names) -> list:
    return [] if names is None else list(names)


class BaseTransform:
    def __init__(self, dtype: Any = None, device: Any = "cpu"):
        self.dtype = resolve_dtype(dtype)
        self.device = torch.device(device)

    def _as(self, x) -> torch.Tensor:
        return as_tensor(x, dtype=self.dtype, device=self.device)

    def fit(self, x):
        raise NotImplementedError

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def config_dict(self) -> dict:
        return {"dtype": str(self.dtype).replace("torch.", "")
                if self.dtype else None}

    # -- persistence ----------------------------------------------------------

    def save(self, h5_file, path: str = "data_transform"):
        from .io import save_dict_to_hdf5

        if path in h5_file:
            del h5_file[path]
        grp = h5_file.create_group(path)
        grp.attrs["class"] = type(self).__name__
        save_dict_to_hdf5(grp, "config", self.config_dict())
        self._save_state(grp)

    @classmethod
    def load(cls, h5_file, path: str = "data_transform",
             strict: bool = False, device: Any = "cpu"):
        """The transform saved at ``path`` (by either package), of the class
        its group names, on ``device``."""
        from .io import load_dict_from_hdf5

        grp = h5_file[path]
        class_name = grp.attrs["class"]
        target = get_transform_class(class_name)
        if strict and target is not cls:
            raise ValueError(
                f"Expected class {cls.__name__}, got {class_name}.")
        obj = target(**load_dict_from_hdf5(grp, "config"), device=device)
        obj._load_state(grp)
        return obj

    def _fitted_arrays(self) -> dict:
        """The fitted state as named tensors (none before a fit)."""
        return {}

    def _set_fitted_arrays(self, arrays: dict) -> None:
        pass

    def _save_state(self, grp):
        for name, value in self._fitted_arrays().items():
            grp.create_dataset(name, data=to_numpy(value))

    def _load_state(self, grp):
        arrays = {name: grp[name][()] for name in ("mean", "std")
                  if name in grp}
        if arrays:
            self._set_fitted_arrays(arrays)

    def host_state(self) -> dict:
        """Class, config and fitted state as host arrays: what a checkpoint
        keeps of a transform (no tensor of any device)."""
        return {"class": type(self).__name__, "config": self.config_dict(),
                "arrays": {k: to_numpy(v).copy()
                           for k, v in self._fitted_arrays().items()}}

    @staticmethod
    def from_host_state(state: dict, device: Any = "cpu") -> "BaseTransform":
        obj = get_transform_class(state["class"])(**state["config"],
                                                  device=device)
        if state["arrays"]:
            obj._set_fitted_arrays(state["arrays"])
        return obj


@register_transform
class IdentityTransform(BaseTransform):
    def fit(self, x):
        return self._as(x)

    def forward(self, x):
        x = self._as(x)
        return x, torch.zeros(len(x), dtype=x.dtype, device=x.device)

    def inverse(self, y):
        y = self._as(y)
        return y, torch.zeros(len(y), dtype=y.dtype, device=y.device)


@register_transform
class PeriodicTransform(BaseTransform):
    """Wrap values into ``[lower, upper)`` with zero Jacobian."""

    name = "periodic"
    requires_prior_bounds = True

    def __init__(self, lower, upper, dtype: Any = None, device="cpu"):
        super().__init__(dtype=dtype, device=device)
        self.lower = self._as(lower)
        self.upper = self._as(upper)

    def fit(self, x):
        return self.forward(x)[0]

    def _wrap(self, x):
        # Floor modulo (sign of the divisor), as numpy/jax ``%``.
        return self.lower + torch.remainder(x - self.lower,
                                            self.upper - self.lower)

    def forward(self, x):
        y = self._wrap(x)
        return y, torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)

    def inverse(self, y):
        x = self._wrap(y)
        return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def config_dict(self):
        return super().config_dict() | {
            "lower": self.lower.tolist(), "upper": self.upper.tolist(),
        }


class BoundedTransform(BaseTransform):
    """Linear map ``[lower, upper] <-> [0, 1]``; subclasses unbound it."""

    name = "bounded"
    requires_prior_bounds = True

    def __init__(self, lower, upper, eps: float = 1e-6, dtype: Any = None,
                 device="cpu"):
        super().__init__(dtype=dtype, device=device)
        self.lower = torch.atleast_1d(self._as(lower))
        self.upper = torch.atleast_1d(self._as(upper))
        self.eps = eps
        self.interval_check(self.lower, self.upper)

    def interval_check(self, lower, upper) -> None:
        """Raise where a range is empty at the transform's precision."""
        if bool(torch.any((upper - lower) == 0.0)):
            raise ValueError(
                f"Current floating precision ({self.dtype}) is too small "
                "for specified parameter ranges"
            )

    @property
    def _denom(self):
        return self.upper - self.lower

    def _scale_log_j(self):
        return -torch.log(self._denom).sum()

    def to_unit_interval(self, x):
        y = (x - self.lower) / self._denom
        return y, self._scale_log_j() * torch.ones(
            y.shape[0], dtype=y.dtype, device=y.device)

    def from_unit_interval(self, y):
        x = self._denom * y + self.lower
        return x, -self._scale_log_j() * torch.ones(
            x.shape[0], dtype=x.dtype, device=x.device)

    def fit(self, x):
        return self.forward(x)[0]

    def config_dict(self):
        return super().config_dict() | {
            "lower": self.lower.tolist(), "upper": self.upper.tolist(),
            "eps": self.eps,
        }


@register_transform
class ProbitTransform(BoundedTransform):
    name = "probit"

    def forward(self, x):
        y, log_j_unit = self.to_unit_interval(x)
        y = torch.clamp(y, self.eps, 1.0 - self.eps)
        y = torch.erfinv(2 * y - 1) * math.sqrt(2)
        log_j = 0.5 * (math.log(2 * math.pi) + y**2).sum(-1)
        return y, log_j + log_j_unit

    def inverse(self, y):
        log_j = -(0.5 * (math.log(2 * math.pi) + y**2)).sum(-1)
        x = 0.5 * (1 + torch.erf(y / math.sqrt(2)))
        x, log_j_unit = self.from_unit_interval(x)
        return x, log_j + log_j_unit


@register_transform
class LogitTransform(BoundedTransform):
    name = "logit"

    def forward(self, x):
        y, log_j_unit = self.to_unit_interval(x)
        y = torch.clamp(y, self.eps, 1.0 - self.eps)
        z = torch.log(y) - torch.log1p(-y)
        log_j = -(torch.log(y) + torch.log1p(-y)).sum(-1)
        return z, log_j + log_j_unit

    def inverse(self, z):
        y = torch.sigmoid(z)
        log_j = (torch.nn.functional.logsigmoid(z)
                 + torch.nn.functional.logsigmoid(-z)).sum(-1)
        x, log_j_unit = self.from_unit_interval(y)
        return x, log_j + log_j_unit


@register_transform
class AffineTransform(BaseTransform):
    """Whitening fit to the data's mean and (population) std."""

    name = "affine"
    requires_prior_bounds = False

    def __init__(self, dtype: Any = None, device="cpu"):
        super().__init__(dtype=dtype, device=device)
        self._mean = None
        self._std = None

    @property
    def log_abs_det_jacobian(self) -> torch.Tensor:
        return -torch.log(torch.abs(self._std)).sum()

    def fit(self, x):
        x = self._as(x)
        self._mean = x.mean(0)
        self._std = x.std(0, correction=0)
        return self.forward(x)[0]

    def forward(self, x):
        y = (x - self._mean) / self._std
        return y, self.log_abs_det_jacobian * torch.ones(
            y.shape[0], dtype=y.dtype, device=y.device)

    def inverse(self, y):
        x = y * self._std + self._mean
        return x, -self.log_abs_det_jacobian * torch.ones(
            y.shape[0], dtype=y.dtype, device=y.device)

    def _fitted_arrays(self) -> dict:
        if self._mean is None:
            return {}
        return {"mean": self._mean, "std": self._std}

    def _set_fitted_arrays(self, arrays: dict) -> None:
        self._mean = self._as(arrays["mean"])
        self._std = self._as(arrays["std"])


@register_transform
class CompositeTransform(BaseTransform):
    """Masked composition: periodic wrap, bounded -> unbounded, affine."""

    def __init__(
        self,
        parameters: list[str],
        periodic_parameters: list[str] | None = None,
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        eps: float = 1e-6,
        dtype: Any = None,
        device: Any = "cpu",
    ):
        super().__init__(dtype=dtype, device=device)
        if prior_bounds is None:
            logger.warning(
                "Missing prior bounds, some transforms may not be applied."
            )
        periodic_parameters = _name_list(periodic_parameters)
        if periodic_parameters and not prior_bounds:
            raise ValueError(
                "Must specify prior bounds to use periodic parameters."
            )
        self.parameters = list(parameters)
        self.periodic_parameters = periodic_parameters
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.affine_transform = affine_transform
        self.eps = eps
        if prior_bounds is None:
            self._prior_bounds_config = None
            self.bounded_parameters = []
            lower = upper = None
        else:
            self._prior_bounds_config = {
                k: [float(v) for v in np.asarray(prior_bounds[k]).ravel()]
                for k in self.parameters
            }
            lower = np.asarray(
                [self._prior_bounds_config[p][0] for p in self.parameters])
            upper = np.asarray(
                [self._prior_bounds_config[p][1] for p in self.parameters])
            if bounded_to_unbounded:
                finite = np.isfinite(lower) & np.isfinite(upper)
                self.bounded_parameters = [
                    p for p, ok in zip(self.parameters, finite)
                    if ok and p not in self.periodic_parameters
                ]
            else:
                self.bounded_parameters = []
        self._periodic_mask = np.asarray(
            [p in self.periodic_parameters for p in self.parameters])
        self._bounded_mask = np.asarray(
            [p in self.bounded_parameters for p in self.parameters])
        kw = dict(dtype=self.dtype, device=self.device)
        self._periodic_transform = (
            PeriodicTransform(lower[self._periodic_mask],
                              upper[self._periodic_mask], **kw)
            if self.periodic_parameters else None
        )
        if self.bounded_parameters:
            cls = {"probit": ProbitTransform,
                   "logit": LogitTransform}.get(bounded_transform)
            if cls is None:
                raise ValueError(
                    f"Unknown bounded transform: {bounded_transform}")
            self._bounded_transform = cls(
                lower[self._bounded_mask], upper[self._bounded_mask],
                eps=eps, **kw)
        else:
            self._bounded_transform = None
        self._affine_transform = (
            AffineTransform(**kw) if affine_transform else None
        )
        # The masks' dims as index tensors on the transform's device, made
        # once: indexing by a numpy mask copies it to the device at every
        # call, which a CUDA graph (the device ladder) cannot capture.
        self._periodic_index, self._bounded_index = (
            torch.as_tensor(np.flatnonzero(m), device=self.device)
            for m in (self._periodic_mask, self._bounded_mask))

    @property
    def prior_bounds(self):
        return self._prior_bounds_config

    @property
    def periodic_mask(self) -> torch.Tensor:
        return torch.as_tensor(self._periodic_mask, device=self.device)

    @property
    def bounded_mask(self) -> torch.Tensor:
        return torch.as_tensor(self._bounded_mask, device=self.device)

    @property
    def is_identity(self) -> bool:
        return (self._periodic_transform is None
                and self._bounded_transform is None
                and self._affine_transform is None)

    def _masked(self, x, index, fn):
        y, lj = fn(x.index_select(1, index))
        return x.index_copy(1, index, y.to(x.dtype)), lj

    def fit(self, x):
        x = torch.atleast_2d(self._as(x))
        if self._periodic_transform is not None:
            x, _ = self._masked(x, self._periodic_index,
                                self._periodic_transform.forward)
        if self._bounded_transform is not None:
            x, _ = self._masked(x, self._bounded_index,
                                self._bounded_transform.forward)
        if self._affine_transform is not None:
            x = self._affine_transform.fit(x)
        return x

    def forward(self, x):
        x = torch.atleast_2d(self._as(x))
        log_j = torch.zeros(len(x), dtype=x.dtype, device=x.device)
        if self._periodic_transform is not None:
            x, lj = self._masked(x, self._periodic_index,
                                 self._periodic_transform.forward)
            log_j = log_j + lj
        if self._bounded_transform is not None:
            x, lj = self._masked(x, self._bounded_index,
                                 self._bounded_transform.forward)
            log_j = log_j + lj
        if self._affine_transform is not None:
            x, lj = self._affine_transform.forward(x)
            log_j = log_j + lj
        return x, log_j

    def inverse(self, y):
        y = torch.atleast_2d(self._as(y))
        log_j = torch.zeros(len(y), dtype=y.dtype, device=y.device)
        if self._affine_transform is not None:
            y, lj = self._affine_transform.inverse(y)
            log_j = log_j + lj
        if self._bounded_transform is not None:
            y, lj = self._masked(y, self._bounded_index,
                                 self._bounded_transform.inverse)
            log_j = log_j + lj
        if self._periodic_transform is not None:
            y, lj = self._masked(y, self._periodic_index,
                                 self._periodic_transform.inverse)
            log_j = log_j + lj
        return y, log_j

    def _fitted_arrays(self) -> dict:
        if self._affine_transform is None:
            return {}
        return self._affine_transform._fitted_arrays()

    def _set_fitted_arrays(self, arrays: dict) -> None:
        if self._affine_transform is not None:
            self._affine_transform._set_fitted_arrays(arrays)

    def _save_state(self, grp):
        """The JAX package's layout: the affine step's state in a group of
        its own."""
        if self._fitted_arrays():
            self._affine_transform._save_state(
                grp.create_group("affine_transform"))

    def _load_state(self, grp):
        if self._affine_transform is not None and "affine_transform" in grp:
            self._affine_transform._load_state(grp["affine_transform"])

    def config_dict(self):
        return super().config_dict() | {
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self._prior_bounds_config,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "affine_transform": self.affine_transform,
            "eps": self.eps,
        }


@register_transform
class FlowTransform(CompositeTransform):
    """Composite without periodic support: the flow's data transform."""

    def __init__(
        self,
        parameters: list[str],
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        eps: float = 1e-6,
        dtype: Any = None,
        device: Any = "cpu",
    ):
        super().__init__(
            parameters=parameters,
            periodic_parameters=[],
            prior_bounds=prior_bounds,
            bounded_to_unbounded=bounded_to_unbounded,
            bounded_transform=bounded_transform,
            affine_transform=affine_transform,
            eps=eps,
            dtype=dtype,
            device=device,
        )

    def config_dict(self):
        cfg = super().config_dict()
        cfg.pop("periodic_parameters", None)
        return cfg



@register_transform
class FlowPreconditioningTransform(BaseTransform):
    """Preconditioning by an inner normalizing flow used as a transport
    map: ``fit`` trains a fresh flow on the particles (a
    :class:`FlowTransform` of these options as its data transform), and
    ``forward`` maps to its latent space. A coupling flow's passes run on
    its kernels on the card (B1 forward, B3 inverse); a CNF integrates its
    ODE.

    Not a :class:`CompositeTransform`: it lowers to no transform program,
    so a chain preconditioned by it takes the split route, and the device
    ladder refuses it, as in the JAX package. A fitted one saves its flow's
    parameters and inner data transform (HDF5, and the checkpoint payload
    of an SMC state).
    """

    def __init__(
        self,
        parameters: list[str],
        flow_backend: str = "maf",
        prior_bounds: dict | None = None,
        bounded_to_unbounded: bool = True,
        bounded_transform: str = "probit",
        affine_transform: bool = True,
        periodic_parameters: list[str] | None = None,
        eps: float = 1e-6,
        dtype: Any = None,
        flow_matching: bool = False,
        flow_kwargs: dict | None = None,
        fit_kwargs: dict | None = None,
        device: Any = "cpu",
    ):
        super().__init__(dtype=dtype, device=device)
        self.parameters = list(parameters)
        self.periodic_parameters = _name_list(periodic_parameters)
        self.prior_bounds = prior_bounds
        self.bounded_to_unbounded = bounded_to_unbounded
        self.bounded_transform = bounded_transform
        self.affine_transform = affine_transform
        self.eps = eps
        self.flow_backend = flow_backend
        self.flow_matching = flow_matching
        self.flow_kwargs = dict(flow_kwargs or {})
        self.fit_kwargs = dict(fit_kwargs or {})
        self.flow = None
        self._params = None
        self._inner_data_transform = None
        self._arch = None

    def _make_data_transform(self):
        return CompositeTransform(
            parameters=self.parameters,
            periodic_parameters=self.periodic_parameters,
            prior_bounds=self.prior_bounds,
            bounded_to_unbounded=self.bounded_to_unbounded,
            bounded_transform=self.bounded_transform,
            affine_transform=self.affine_transform,
            eps=self.eps,
            dtype=self.dtype,
            device=self.device,
        )

    def _new_flow(self, data_transform):
        from .flows import get_flow_class

        flow_class = get_flow_class(self.flow_backend,
                                    flow_matching=self.flow_matching)
        return flow_class(dims=len(self.parameters),
                          data_transform=data_transform, device=self.device,
                          **self.flow_kwargs)

    def fit(self, x):
        """Train a fresh flow on ``x``; returns ``x`` in its latent space."""
        self.flow = self._new_flow(self._make_data_transform())
        self.flow.fit(x, **self.fit_kwargs)
        self._params = self.flow.params
        self._inner_data_transform = self.flow.data_transform
        self._arch = self.flow.architecture
        return self.flow.forward(x)[0]

    def _check_fitted(self):
        if self._params is None:
            raise RuntimeError("FlowPreconditioningTransform is not fitted")

    def forward(self, x):
        self._check_fitted()
        x_t, log_j = self._inner_data_transform.forward(x)
        z, log_det = self._arch.forward(self._params, x_t)
        return z, log_det + log_j

    def inverse(self, y):
        self._check_fitted()
        x_t, log_det = self._arch.inverse(self._params, y)
        x, log_j = self._inner_data_transform.inverse(x_t)
        return x, log_det + log_j

    def config_dict(self):
        return super().config_dict() | {
            "parameters": self.parameters,
            "periodic_parameters": self.periodic_parameters,
            "prior_bounds": self.prior_bounds,
            "bounded_to_unbounded": self.bounded_to_unbounded,
            "bounded_transform": self.bounded_transform,
            "affine_transform": self.affine_transform,
            "eps": self.eps,
            "flow_backend": self.flow_backend,
            "flow_matching": self.flow_matching,
            "flow_kwargs": self.flow_kwargs,
            "fit_kwargs": self.fit_kwargs,
        }

    def _rebuild_flow(self, data_transform, params):
        """Reattach a fitted transport map (no training): a new flow of
        this configuration with ``data_transform`` and ``params``."""
        self.flow = self._new_flow(data_transform)
        if params is not None:
            self._params = params
            self.flow.params = params
        self._inner_data_transform = self.flow.data_transform
        self._arch = self.flow.architecture

    def _save_state(self, grp):
        """The fitted transport map: the flow's parameters (by the JAX
        package's leaf order) and its data transform."""
        if self._params is None:
            return
        from .io import save_pytree_to_hdf5

        save_pytree_to_hdf5(grp, "flow_params", self._params)
        self._inner_data_transform.save(grp, "inner_data_transform")

    def _load_state(self, grp):
        if "flow_params" not in grp:
            return  # saved unfitted
        from .io import load_pytree_from_hdf5

        self._rebuild_flow(BaseTransform.load(grp, "inner_data_transform",
                                              device=self.device), None)
        self._params = load_pytree_from_hdf5(grp, "flow_params",
                                             like=self.flow.params)
        self.flow.params = self._params

    def checkpoint_payload(self) -> dict | None:
        """The fitted state as host data (config, the parameters as numpy
        in their nesting, the inner data transform's :meth:`host_state`),
        or None unfitted."""
        if self._params is None:
            return None
        from .io import tree_unflatten, tree_flatten

        return {"class": type(self).__name__, "config": self.config_dict(),
                "params": tree_unflatten(self._params, [
                    to_numpy(v).copy() for v in tree_flatten(self._params)]),
                "inner_data_transform":
                    self._inner_data_transform.host_state()}

    @classmethod
    def from_checkpoint_payload(cls, payload: dict, device: Any = "cpu"
                                ) -> "FlowPreconditioningTransform":
        from .io import tree_flatten, tree_unflatten

        obj = cls(**payload["config"], device=device)
        params = payload["params"]
        obj._rebuild_flow(
            BaseTransform.from_host_state(payload["inner_data_transform"],
                                          device=device),
            tree_unflatten(params, [
                torch.as_tensor(v, device=obj.device)
                for v in tree_flatten(params)]))
        return obj
