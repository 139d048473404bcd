"""Normalizing flows: MAF and coupling architectures, the flow-matching
CNF, training, factory.

Backend names and defaults follow ``aspire_tpu/flows/__init__.py``: MAF
is the default, the reference-style names ``jax``, ``flowjax``,
``native``, ``zuko`` and ``torch`` map to it, and ``flow_matching`` and
``cnf`` (or ``flow_matching=True``) give :class:`FlowMatching`.
"""

from __future__ import annotations

from .architectures import (  # noqa: F401
    ARCHITECTURES,
    MAF,
    Architecture,
    Coupling,
    get_architecture,
)
from .base import Flow  # noqa: F401
from .matching import FlowMatching  # noqa: F401
from .train import TrainConfig, fit_flow  # noqa: F401

_ALIASES = ("jax", "flowjax", "native", "zuko", "torch")
_KNOWN_BACKENDS = {name: Flow for name in (*ARCHITECTURES, *_ALIASES)}
_KNOWN_BACKENDS.update(flow_matching=FlowMatching, cnf=FlowMatching)


def get_flow_class(backend: str = "maf", flow_matching: bool = False) -> type:
    """Resolve a flow class from a backend/architecture name."""
    if flow_matching:
        return FlowMatching
    name = (backend or "maf").lower()
    if name in _KNOWN_BACKENDS:
        return _KNOWN_BACKENDS[name]
    raise ValueError(
        f"Unknown flow backend '{backend}'. Known backends: "
        f"{sorted(_KNOWN_BACKENDS)}"
    )


def default_architecture_for_backend(backend: str) -> str:
    """Map a backend name to the architecture string for :class:`Flow`."""
    name = (backend or "maf").lower()
    return name if name in ARCHITECTURES else "maf"
