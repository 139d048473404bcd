"""Normalizing flows: coupling architectures, training, factory."""

from __future__ import annotations

from .architectures import ARCHITECTURES, Coupling, get_architecture  # noqa: F401
from .base import Flow  # noqa: F401
from .train import TrainConfig, fit_flow  # noqa: F401

_KNOWN_BACKENDS = {
    "nsf": Flow,
    "nsf-tpu": Flow,
    "realnvp": Flow,
    "coupling": Flow,
    "torch": Flow,
}


def get_flow_class(backend: str = "nsf", flow_matching: bool = False) -> type:
    """Resolve a flow class from a backend/architecture name."""
    if flow_matching:
        raise NotImplementedError(
            "flow-matching (CNF) flows are not ported yet")
    name = (backend or "nsf").lower()
    if name in _KNOWN_BACKENDS:
        return _KNOWN_BACKENDS[name]
    raise ValueError(
        f"Unknown flow backend '{backend}'. Known backends: "
        f"{sorted(_KNOWN_BACKENDS)} (MAF is not ported yet)"
    )


def default_architecture_for_backend(backend: str) -> str:
    name = (backend or "nsf").lower()
    return name if name in ARCHITECTURES else "nsf"
