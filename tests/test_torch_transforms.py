"""aspire_tpu_torch transforms against the JAX package (float64), and the
converter of fitted JAX transforms into the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import transforms as JT
from aspire_tpu_torch import transforms as TT
from aspire_tpu_torch.utils import transform_from_jax

torch.set_num_threads(1)

PARAMS = ["a", "b", "c", "d"]
BOUNDS = {"a": [-2.0, 3.0], "b": [0.0, 1.0], "c": [-np.inf, np.inf],
          "d": [0.0, 2 * np.pi]}


def _x(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.9, 2.9, n), rng.uniform(0.01, 0.99, n),
                     rng.normal(3.0, 2.0, n), rng.uniform(-1.0, 7.0, n)], 1)


def _pair(kind):
    if kind == "logit":
        return (JT.LogitTransform([-2.0], [3.0], dtype="float64"),
                TT.LogitTransform([-2.0], [3.0], dtype="float64"))
    if kind == "probit":
        return (JT.ProbitTransform([-2.0], [3.0], dtype="float64"),
                TT.ProbitTransform([-2.0], [3.0], dtype="float64"))
    if kind == "periodic":
        return (JT.PeriodicTransform([0.0], [2 * np.pi], dtype="float64"),
                TT.PeriodicTransform([0.0], [2 * np.pi], dtype="float64"))
    if kind == "affine":
        return (JT.AffineTransform(dtype="float64"),
                TT.AffineTransform(dtype="float64"))
    kw = dict(parameters=PARAMS, prior_bounds=BOUNDS, dtype="float64")
    if kind == "composite":
        return (JT.CompositeTransform(periodic_parameters=["d"], **kw),
                TT.CompositeTransform(periodic_parameters=["d"], **kw))
    return (JT.FlowTransform(bounded_transform="logit", **kw),
            TT.FlowTransform(bounded_transform="logit", **kw))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-10, rtol=0)


@pytest.mark.parametrize(
    "kind", ["logit", "probit", "periodic", "affine", "composite", "flow"])
def test_transform_matches_jax_f64(kind):
    jt, tt = _pair(kind)
    x = _x()
    if kind in ("logit", "probit", "periodic"):
        x = x[:, :1] if kind != "periodic" else x[:, 3:]
    if kind in ("affine", "composite", "flow"):
        _close(tt.fit(torch.as_tensor(x)), jt.fit(jnp.asarray(x)))
    yj, lj = jt.forward(jnp.asarray(x))
    yt, lt = tt.forward(torch.as_tensor(x))
    _close(yt, yj)
    _close(lt, lj)
    xj, lij = jt.inverse(yj)
    xt, lit = tt.inverse(yt)
    _close(xt, xj)
    _close(lit, lij)


def test_flow_transform_converts_from_jax():
    """A fitted JAX FlowTransform rebuilt in the port applies the same map."""
    jt = JT.FlowTransform(parameters=PARAMS, prior_bounds=BOUNDS,
                          bounded_transform="probit", dtype="float64")
    x = _x(seed=3)
    jt.fit(jnp.asarray(x))
    tt = transform_from_jax(jt, dtype="float64")
    yj, lj = jt.forward(jnp.asarray(x))
    yt, lt = tt.forward(torch.as_tensor(x))
    _close(yt, yj)
    _close(lt, lj)

