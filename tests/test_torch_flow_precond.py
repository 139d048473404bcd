"""The port's ``FlowPreconditioningTransform`` against the JAX package's,
and a flow-preconditioned SMC run on the CPU.

Both transports are the JAX package's fitted state converted
(``transform_from_jax``): an nsf inner flow and a CNF inner flow, float64,
1e-10. Then the port's own rules: no transform program (the split route),
no device ladder, the Aspire's defaults, and an unfitted transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu.transforms import (
    FlowPreconditioningTransform as JFlowPreconditioning,
)
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.flows import FlowMatching
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.transforms import FlowPreconditioningTransform
from aspire_tpu_torch.utils import transform_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
D = 3
BOUNDS = {f"x_{i}": [-6.0, 8.0] for i in range(D)}
INNER = {
    "nsf": dict(flow_backend="nsf", flow_kwargs=dict(
        architecture="nsf", n_layers=2, n_hidden=(16, 16),
        dtype="float64")),
    "cnf": dict(flow_matching=True, flow_kwargs=dict(
        n_hidden=(16, 16), n_steps=8, dtype="float64")),
}


def _x(n, seed=0):
    return 1.0 + 1.3 * np.random.default_rng(seed).normal(size=(n, D))


def _jax_fitted(inner: str, seed: int = 1):
    """A JAX flow preconditioning with a fitted logit + affine inner data
    transform and perturbed inner-flow parameters (reattached with
    ``_rebuild_flow``, no training)."""
    jt = JFlowPreconditioning(parameters=list(BOUNDS), prior_bounds=BOUNDS,
                              bounded_transform="logit", dtype="float64",
                              **INNER[inner])
    dt = jt._make_data_transform()
    dt.fit(jnp.asarray(_x(256)))
    jt._rebuild_flow(dt, None)
    rng = np.random.default_rng(seed)
    jt._rebuild_flow(dt, jax.tree.map(
        lambda p: p + 0.2 * rng.normal(size=p.shape), jt.flow.params))
    return jt


@pytest.mark.parametrize("inner", sorted(INNER))
def test_forward_and_inverse_match_jax(inner):
    jt = _jax_fitted(inner)
    tt = transform_from_jax(jt, dtype="float64", device="cpu")
    assert isinstance(tt, FlowPreconditioningTransform)
    assert isinstance(tt.flow, FlowMatching) == (inner == "cnf")
    assert tt.config_dict() == jt.config_dict()
    x = _x(64, seed=2)
    z = np.random.default_rng(3).normal(size=(64, D))
    for fn, arg in (("forward", x), ("inverse", z)):
        out_t = getattr(tt, fn)(torch.as_tensor(arg))
        out_j = jax.jit(getattr(jt, fn))(jnp.asarray(arg))
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.fixture(scope="module")
def mixture():
    p = GaussianMixtureProblem(dims=2)
    init = Samples(p.draw_initial_samples(np.random.default_rng(4), 1024))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, flow_backend="nsf", architecture="nsf",
                 n_layers=2, n_hidden=(16, 16), seed=1, device="cpu")
    asp.fit(init, n_epochs=10, batch_size=256)
    return p, asp


FIT = dict(n_epochs=3, batch_size=128)


def test_flow_preconditioned_smc_takes_the_split_route(mixture):
    p, asp = mixture
    post = asp.sample_posterior(
        sampler="smc", n_samples=256, store_sample_history=False,
        preconditioning="flow", preconditioning_kwargs=dict(fit_kwargs=FIT),
        sampler_kwargs=dict(n_steps=3))
    sampler = asp.sampler
    pc = sampler.preconditioning_transform
    assert isinstance(pc, FlowPreconditioningTransform)
    assert FM.canonicalize_transform(pc, 2) is None
    assert sampler._fused_chain_spec(sampler._mutation_kwargs(), 256,
                                     torch.float32) is None
    assert set(sampler.history.mutation_route) == {"split"}
    # The default path is the host ladder: the device ladder refuses
    # preconditioning, as in the JAX package.
    assert sampler.ladder is None
    assert "preconditioning" in sampler._ladder_refusal()
    assert np.isfinite(post.log_evidence)
    assert abs(post.log_evidence - p.true_log_evidence()) < max(
        5 * post.log_evidence_error, 0.3)
    with pytest.raises(ValueError, match="preconditioning"):
        asp.sample_posterior(
            sampler="smc", n_samples=256, store_sample_history=False,
            preconditioning="flow", device_ladder=True,
            preconditioning_kwargs=dict(fit_kwargs=FIT),
            sampler_kwargs=dict(n_steps=2))


@pytest.mark.parametrize("overrides", [{}, {"affine_transform": True,
                                            "fit_kwargs": FIT}])
def test_aspire_defaults_match_jax(overrides):
    """``init_sampler(preconditioning="flow")`` takes the JAX package's
    defaults from the Aspire (no affine step; its backend, flow kwargs,
    flow matching, periodic parameters, bounds and dtype), then the
    user's overrides."""
    kw = dict(log_likelihood=None, log_prior=None, dims=D,
              parameters=list(BOUNDS), prior_bounds=BOUNDS,
              periodic_parameters=["x_1"], bounded_to_unbounded=False,
              flow_backend="nsf", flow_matching=True, n_hidden=(8, 8),
              n_steps=4)
    jt = JAspire(**kw).init_sampler(
        "smc", preconditioning="flow",
        preconditioning_kwargs=overrides).preconditioning_transform
    tt = Aspire(device="cpu", **kw).init_sampler(
        "smc", preconditioning="flow",
        preconditioning_kwargs=overrides).preconditioning_transform
    assert isinstance(tt, FlowPreconditioningTransform)
    assert tt.config_dict() == jt.config_dict()
    assert tt.affine_transform is overrides.get("affine_transform", False)


def test_unfitted_transform_raises_and_save_is_not_ported(tmp_path):
    """An unfitted transport map raises on use, saves its config alone (and
    loads back unfitted) and has no checkpoint payload; a fitted one saves
    its map, which loads back exactly (HDF5, the JAX package's layout)."""
    import h5py

    from aspire_tpu_torch.transforms import BaseTransform

    t = FlowPreconditioningTransform(parameters=["a", "b"], device="cpu")
    for fn in (t.forward, t.inverse):
        with pytest.raises(RuntimeError, match="not fitted"):
            fn(torch.zeros((4, 2)))
    assert t.checkpoint_payload() is None
    fitted = FlowPreconditioningTransform(
        parameters=["a", "b"], device="cpu", flow_backend="nsf",
        flow_kwargs=dict(architecture="nsf", n_layers=2, n_hidden=(8, 8)),
        fit_kwargs=dict(n_epochs=2))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(256, 2)),
                        dtype=torch.float32)
    fitted.fit(x)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        t.save(f, "unfitted")
        fitted.save(f, "fitted")
    with h5py.File(tmp_path / "t.h5", "r") as f:
        back = BaseTransform.load(f, "unfitted")
        loaded = BaseTransform.load(f, "fitted")
    assert back._params is None and back.config_dict() == t.config_dict()
    for a, b in zip(fitted.forward(x), loaded.forward(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
