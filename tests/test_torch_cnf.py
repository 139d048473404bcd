"""The port's flow-matching CNF against the JAX package's.

Same numpy inputs and converted parameters (float64, a velocity MLP of
(16, 16) hidden units, 8 RK4 steps): the velocity field, its exact
divergence, the ODE transport both ways, the flow's densities and draws
with a fitted data transform, the CFM loss at the JAX package's own draws
and one optimizer step against optax; then a fitted CNF driving SMC in
both packages on a 2-d Gaussian.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import flows as jflows
from aspire_tpu.flows import matching as JM
from aspire_tpu.flows.bijectors import standard_normal_sample as jnormal
from aspire_tpu.models import GaussianProblem as JGaussian
from aspire_tpu.transforms import FlowTransform as JFlowTransform
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch import flows as tflows
from aspire_tpu_torch.flows import base as tbase
from aspire_tpu_torch.flows import matching as TM
from aspire_tpu_torch.flows.train import (
    TrainConfig,
    make_optimizer,
    param_leaves,
)
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.utils import flow_matching_from_jax, flow_params_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
HIDDEN, STEPS = (16, 16), 8
# The JAX package's functions compiled once per shape (eager, each call
# traces them again).
_jvelocity, _jdivergence = jax.jit(JM._velocity), jax.jit(JM._divergence)


def _params(dims, seed=0, scale=0.3, hidden=HIDDEN):
    """The JAX velocity field's parameters, every leaf (the zero output
    layer too) moved by ``scale`` normal noise, and the port's copy."""
    field = JM._VelocityField(dims, hidden, "float64", STEPS)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda p: p + scale * rng.normal(size=p.shape),
                          field.init(jax.random.key(seed)))
    return field, params, flow_params_from_jax(params, dtype="float64")


def _x(n, dims, seed=2):
    return np.random.default_rng(seed).normal(size=(n, dims))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("dims, hidden", [(2, HIDDEN), (5, HIDDEN),
                                          (3, (16,)), (3, (8, 16, 8))])
def test_velocity_and_divergence_match_jax(dims, hidden):
    _, jp, tp = _params(dims, hidden=hidden)
    x = _x(64, dims)
    for t in (0.0, 0.3125, 1.0):
        jv = _jvelocity(jp, t, jnp.asarray(x))
        _close(TM._velocity(tp, t, torch.as_tensor(x)), jv)
        _close(TM._divergence(tp, t, torch.as_tensor(x)),
               _jdivergence(jp, t, jnp.asarray(x)))
        bias = TM._time_biases(tp, torch.tensor(t, dtype=torch.float64),
                               dims)
        v, _ = TM._velocity_and_divergence(tp, torch.as_tensor(x), bias)
        _close(v, jv)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("dims", [2, 5])
def test_ode_integrate_matches_jax(dims, forward):
    field, jp, tp = _params(dims)
    x = _x(64, dims, seed=3)
    jout, jld = JM._ode_integrate(jp, jnp.asarray(x), STEPS, forward=forward)
    tout, tld = TM._ode_integrate(tp, torch.as_tensor(x), STEPS,
                                  forward=forward)
    _close(tout, jout)
    _close(tld, jld)
    # The architecture's two directions are the two integrations.
    arch = TM._VelocityField(dims, HIDDEN, "float64", STEPS)
    out, ld = (arch.forward if forward else arch.inverse)(
        tp, torch.as_tensor(x))
    _close(out, jout)
    _close(ld, jld)


def _flows():
    """A 2-d JAX FlowMatching with a fitted logit + affine data transform
    and perturbed parameters, and the port's conversion of it."""
    dims = 2
    bounds = {f"x_{i}": [-4.0, 6.0] for i in range(dims)}
    jdt = JFlowTransform(parameters=list(bounds), prior_bounds=bounds,
                         bounded_transform="logit", dtype="float64")
    jdt.fit(jnp.asarray(1.0 + 1.2 * _x(256, dims, seed=4)))
    jflow = JM.FlowMatching(dims, data_transform=jdt, key=0, dtype="float64",
                            n_hidden=HIDDEN, n_steps=STEPS)
    jflow.params = _params(dims)[1]
    return jflow, flow_matching_from_jax(jflow, device="cpu")


def test_log_prob_and_draws_with_data_transform_match_jax(monkeypatch):
    jflow, tflow = _flows()
    x = 1.0 + 1.5 * _x(128, 2, seed=5)
    _close(tflow.log_prob(torch.as_tensor(x)), jflow.log_prob(jnp.asarray(x)))
    for t, j in zip(tflow.forward(torch.as_tensor(x)),
                    jflow.forward(jnp.asarray(x))):
        _close(t, j)
    key = jax.random.key(9)
    jx, jlq = jflow.sample_and_log_prob(100, key=key)
    z = torch.as_tensor(np.asarray(jnormal(key, (100, 2), jnp.float64)))
    monkeypatch.setattr(tbase, "standard_normal_sample",
                        lambda *a, **k: z)
    tx, tlq = tflow.sample_and_log_prob(100)
    _close(tx, jx)
    _close(tlq, jlq)


def test_cfm_loss_at_jax_draws_matches_jax():
    jflow, tflow = _flows()
    batch = _x(96, 2, seed=6)
    key = jax.random.key(13)
    jloss = jflow.loss_fn(jflow.params, jnp.asarray(batch), key)
    # The draws as matching.py's loss_fn makes them from its key.
    t_key, noise_key = jax.random.split(key)
    t = jax.random.uniform(t_key, (96, 1), dtype=jnp.float64)
    x0 = jnormal(noise_key, (96, 2), jnp.float64)
    tloss = TM.cfm_loss(tflow.params, torch.as_tensor(batch),
                        torch.as_tensor(np.asarray(t)),
                        torch.as_tensor(np.asarray(x0)))
    assert abs(float(tloss) - float(jloss)) <= 1e-10 * max(1.0,
                                                          abs(float(jloss)))


@pytest.mark.parametrize("max_grad_norm", [5.0, 0.05])
def test_adam_step_matches_optax(max_grad_norm):
    jflow, tflow = _flows()
    batch = _x(96, 2, seed=7)
    key = jax.random.key(17)
    total = 50
    tx = optax.chain(optax.clip_by_global_norm(max_grad_norm),
                     optax.adam(optax.cosine_decay_schedule(3e-3, total)))
    grads = jax.jit(jax.grad(jflow.loss_fn))(jflow.params,
                                             jnp.asarray(batch), key)
    updates, _ = jax.jit(tx.update)(grads, tx.init(jflow.params),
                                    jflow.params)
    want = flow_params_from_jax(optax.apply_updates(jflow.params, updates),
                                dtype="float64")

    t_key, noise_key = jax.random.split(key)
    t = torch.as_tensor(np.asarray(
        jax.random.uniform(t_key, (96, 1), dtype=jnp.float64)))
    x0 = torch.as_tensor(np.asarray(jnormal(noise_key, (96, 2), jnp.float64)))
    leaves = param_leaves(tflow.params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = make_optimizer(leaves, TrainConfig(learning_rate=3e-3,
                                             max_grad_norm=max_grad_norm),
                         total)
    loss = TM.cfm_loss(tflow.params, torch.as_tensor(batch), t, x0)
    opt.step(list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(leaves, param_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-8,
                                   rtol=0)


def test_config_dict_and_backend_names_match_jax():
    jflow, tflow = _flows()
    assert tflow.config_dict() == jflow.config_dict()
    for name in ("flow_matching", "cnf", "FLOW_MATCHING"):
        assert jflows.get_flow_class(name) is jflows.FlowMatching
        assert tflows.get_flow_class(name) is tflows.FlowMatching
    for name in ("maf", "nsf", "zuko"):
        assert jflows.get_flow_class(name, flow_matching=True) is (
            jflows.FlowMatching)
        assert tflows.get_flow_class(name, flow_matching=True) is (
            tflows.FlowMatching)
    asp = Aspire(log_likelihood=None, log_prior=None, dims=2,
                 flow_matching=True, n_hidden=HIDDEN, n_steps=STEPS,
                 architecture="nsf-tpu", seed=3, device="cpu")
    asp.init_flow()
    assert isinstance(asp.flow, tflows.FlowMatching)
    assert asp.flow.config_dict()["architecture_config"] == {
        "n_hidden": list(HIDDEN), "n_steps": STEPS}
    # The training loss draws afresh at every call, from the flow's
    # generator.
    batch = torch.as_tensor(_x(32, 2), dtype=torch.float32)
    assert float(asp.flow.loss_fn(asp.flow.params, batch)) != float(
        asp.flow.loss_fn(asp.flow.params, batch))


def test_cnf_fit_and_smc_slice_against_jax():
    """A CNF fitted in the port drives SMC on a 2-d Gaussian in both
    packages (the JAX package given the port's fitted parameters and a
    data transform fitted to the same draws): log Z within max(5 sigma,
    0.1) of the truth, and the two within 5 combined sigma."""
    p = GaussianProblem(dims=2)
    x = np.random.default_rng(0).normal(1.0, 1.2, size=(1024, 2))
    kw = dict(dims=2, flow_matching=True, n_hidden=HIDDEN, n_steps=STEPS,
              seed=1)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 prior_bounds=p.prior_bounds, device="cpu", **kw)
    history = asp.fit(Samples(x), n_epochs=15, batch_size=128)
    assert history.validation_loss[-1] < history.validation_loss[0]
    run = dict(sampler="smc", n_samples=512, store_sample_history=False,
               sampler_kwargs=dict(n_steps=2))
    post = asp.sample_posterior(**run)
    assert asp.sampler.ladder is not None
    assert post.x.shape == (512, 2) and bool(torch.isfinite(post.x).all())

    jp = JGaussian(dims=2)
    jasp = JAspire(log_likelihood=jp.log_likelihood, log_prior=jp.log_prior,
                   prior_bounds=jp.prior_bounds, dtype="float32", **kw)
    jasp.init_flow()
    jasp.flow.data_transform.fit(jnp.asarray(x, dtype=jnp.float32))
    jasp.flow.params = jax.tree.map(
        lambda t: jnp.asarray(t.detach().numpy()),
        asp.flow.params)
    jpost = jasp.sample_posterior(**run)

    truth = p.true_log_evidence
    for lz, err in ((post.log_evidence, post.log_evidence_error),
                    (float(jpost.log_evidence),
                     float(jpost.log_evidence_error))):
        assert abs(lz - truth) < max(5 * err, 0.1), (lz, err, truth)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < 5 * math.hypot(
        post.log_evidence_error, float(jpost.log_evidence_error))
