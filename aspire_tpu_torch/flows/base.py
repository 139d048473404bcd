"""Flow wrapper: architecture + data transform + training.

Counterpart of ``aspire_tpu/flows/base.py``. The wrapper owns the
parameter dict, the fitted data transform, its device and a
``torch.Generator`` for initialisation and sampling; ``log_prob``/
``sample`` compose the data transform's log-Jacobians as the JAX package
does. ``save``/``load`` keep the JAX package's HDF5 layout (config,
parameters by the JAX package's leaf order, data transform), so a flow
file of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import torch

from ..transforms import BaseTransform, IdentityTransform
from ..utils import as_tensor, resolve_device, resolve_dtype
from .architectures import Architecture, get_architecture
from .bijectors import standard_normal_log_prob, standard_normal_sample
from .train import TrainConfig, fit_flow

logger = logging.getLogger("aspire_tpu_torch")

_FIT_ALIASES = {
    "lr": "learning_rate",
    "clip_grad": "max_grad_norm",
    "lr_annealing": "annealing",
}


class Flow:
    """A trainable flow proposal (MAF or coupling) on ``device``, the card
    (``"cuda"``) unless the caller asks for another."""

    def __init__(
        self,
        dims: int,
        architecture: str | Architecture = "maf",
        data_transform: BaseTransform | None = None,
        seed: int | None = None,
        dtype: str = "float32",
        device: Any = "cuda",
        **architecture_kwargs: Any,
    ):
        self.dims = dims
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        if isinstance(architecture, Architecture):
            self.architecture = architecture
            self._architecture_name = type(architecture).__name__.lower()
        else:
            self._architecture_name = architecture
            self.architecture = get_architecture(
                architecture, dims, dtype=str(dtype).replace("torch.", ""),
                **architecture_kwargs,
            )
        self.data_transform = data_transform or IdentityTransform(
            dtype=self.dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0 if seed is None else int(seed))
        self.params = self.architecture.init(self.generator, self.device)

    def config_dict(self) -> dict:
        return {
            "dims": self.dims,
            "architecture": self._architecture_name,
            "dtype": str(self.dtype).replace("torch.", ""),
            "architecture_config": dataclasses.asdict(self.architecture),
        }

    # -- densities ---------------------------------------------------------

    def _as(self, x) -> torch.Tensor:
        return as_tensor(x, dtype=self.dtype, device=self.device)

    def log_prob(self, x) -> torch.Tensor:
        x_t, log_j = self.data_transform.forward(self._as(x))
        z, log_det = self.architecture.forward(self.params, x_t)
        return standard_normal_log_prob(z) + log_det + log_j

    def forward(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        x_t, log_j = self.data_transform.forward(self._as(x))
        z, log_det = self.architecture.forward(self.params, x_t)
        return z, log_det + log_j

    def inverse(self, z) -> tuple[torch.Tensor, torch.Tensor]:
        x_t, log_det = self.architecture.inverse(self.params, self._as(z))
        x, log_j = self.data_transform.inverse(x_t)
        return x, log_det + log_j

    def sample(self, n: int, generator: torch.Generator | None = None):
        return self.sample_and_log_prob(n, generator=generator)[0]

    def sample_and_log_prob(self, n: int,
                            generator: torch.Generator | None = None):
        z = standard_normal_sample(
            (n, self.dims), generator or self.generator, dtype=self.dtype,
            device=self.device)
        x_t, log_det = self.architecture.inverse(self.params, z)
        log_q = standard_normal_log_prob(z) - log_det
        x, log_j = self.data_transform.inverse(x_t)
        return x, log_q - log_j

    # -- training ----------------------------------------------------------

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean negative log-likelihood in the transformed space."""
        z, log_det = self.architecture.forward(params, batch)
        return -torch.mean(standard_normal_log_prob(z) + log_det)

    def fit(self, x, **kwargs):
        """Fit the data transform, then train by maximum likelihood."""
        x_t = self.data_transform.fit(self._as(x))
        for old, new in _FIT_ALIASES.items():
            if old in kwargs:
                if new in kwargs and kwargs[new] != kwargs[old]:
                    raise ValueError(
                        f"Conflicting fit kwargs: {old}={kwargs[old]!r} "
                        f"and {new}={kwargs[new]!r}")
                value = kwargs.pop(old)
                if value is not None:
                    kwargs[new] = value
        if kwargs.get("patience", 0) is None:
            kwargs["patience"] = int(kwargs.get("n_epochs", 100))
        fields = TrainConfig.__dataclass_fields__
        unknown = set(kwargs) - set(fields)
        if unknown:
            logger.warning("Ignoring unknown fit kwargs: %s", sorted(unknown))
        config = TrainConfig(**{k: v for k, v in kwargs.items()
                                if k in fields})
        self.params, history = fit_flow(
            self.loss_fn, self.params, x_t, self.generator, config)
        return history

    # -- persistence -------------------------------------------------------

    def save(self, h5_file, path: str = "flow") -> None:
        from ..io import save_dict_to_hdf5, save_pytree_to_hdf5

        if path in h5_file:
            del h5_file[path]
        grp = h5_file.create_group(path)
        grp.attrs["class"] = type(self).__name__
        save_dict_to_hdf5(grp, "config", self.config_dict())
        save_pytree_to_hdf5(grp, "params", self.params)
        self.data_transform.save(grp, "data_transform")

    @classmethod
    def load(cls, h5_file, path: str = "flow", device: Any = "cuda"
             ) -> "Flow":
        """The flow saved at ``path`` (by either package) on ``device``."""
        from ..io import load_dict_from_hdf5, load_pytree_from_hdf5

        grp = h5_file[path]
        config = load_dict_from_hdf5(grp, "config")
        arch_config = config.pop("architecture_config", {})
        arch_config.pop("dims", None)
        arch_config.pop("dtype", None)
        if "n_hidden" in arch_config:
            arch_config["n_hidden"] = tuple(int(h) for h in
                                            arch_config["n_hidden"])
        data_transform = None
        if "data_transform" in grp:
            data_transform = BaseTransform.load(grp, "data_transform",
                                                device=resolve_device(device))
        flow = cls(dims=config["dims"], architecture=config["architecture"],
                   data_transform=data_transform, dtype=config["dtype"],
                   device=device, **arch_config)
        flow.params = load_pytree_from_hdf5(grp, "params", flow.params)
        return flow
