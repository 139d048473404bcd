"""The ported main path against the JAX package, end to end, on the CPU.

The JAX package fits the flow; its parameters and fitted data transform
are converted into the port; both packages then run adaptive-tempered SMC
on the same flow. Their random streams differ, so the comparison is
statistical: the port's log Z against the analytic value and against the
JAX package's estimate.
"""

import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.utils import (
    flow_params_from_jax,
    resolve_device,
    transform_from_jax,
)

torch.set_num_threads(1)

N, STEPS = 1024, 5
FLOW_KW = dict(flow_backend="nsf", architecture="nsf-tpu", n_hidden=(16, 16))


@pytest.fixture(scope="module")
def jax_fit():
    p = JMixture(dims=4)
    init = JSamples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=4, seed=1, **FLOW_KW)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    return asp


def _port(jasp, **kw):
    p = GaussianMixtureProblem(dims=4)
    jflow = jasp.flow
    flow = Flow(dims=4, architecture="nsf-tpu", n_hidden=(16, 16),
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow=flow, seed=1, device="cpu", **FLOW_KW)
    return p, asp.sample_posterior(
        sampler="smc", n_samples=N, sampler_kwargs=dict(n_steps=STEPS, **kw)
    ), asp


@pytest.mark.parametrize("route", ["fused_kernel", "split"])
def test_slice_log_evidence_matches_jax_and_truth(jax_fit, route):
    kw = {} if route == "fused_kernel" else {"fused_chain": False}
    p, post, asp = _port(jax_fit, **kw)
    assert set(asp.sampler.history.mutation_route) == {route}
    assert post.x.shape == (N, 4) and bool(torch.isfinite(post.x).all())
    truth = p.true_log_evidence()
    err = post.log_evidence_error
    assert abs(post.log_evidence - truth) < max(5 * err, 0.1)

    jpost = jax_fit.sample_posterior(
        sampler="smc", n_samples=N, sampler_kwargs=dict(n_steps=STEPS))
    jerr = float(jpost.log_evidence_error)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < 5 * np.hypot(
        err, jerr)


def test_slice_flow_densities_match_jax(jax_fit):
    """The converted flow gives the JAX flow's log q (float32)."""
    _, _, asp = _port(jax_fit)
    x = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
    np.testing.assert_allclose(asp.flow.log_prob(x).numpy(),
                               np.asarray(jax_fit.flow.log_prob(x)),
                               rtol=1e-4, atol=1e-4)


def test_slice_runs_with_the_port_fitting_its_own_flow():
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, seed=1, device="cpu", **FLOW_KW)
    hist = asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    assert len(hist.training_loss) == 10
    post = asp.sample_posterior(sampler="smc", n_samples=N,
                                sampler_kwargs=dict(n_steps=STEPS))
    assert abs(post.log_evidence - p.true_log_evidence()) < max(
        5 * post.log_evidence_error, 0.1)
    imp = asp.sample_posterior(sampler="importance", n_samples=N)
    assert 0.0 < float(imp.efficiency) <= 1.0


def test_aspire_requires_an_explicit_device():
    """Without an explicit device the entry points take the card:
    ``resolve_device(None)`` and ``Aspire`` (which only stores its device)
    give ``cuda``; the CPU is used only when asked for."""
    p = GaussianMixtureProblem(dims=4)
    assert resolve_device(None) == torch.device("cuda")
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4)
    assert asp.device == torch.device("cuda")
    assert Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=4, device="cpu").device == torch.device("cpu")


def test_default_device_raises_without_a_card():
    """No fallback: without a card, a default ``Flow`` and fitting a
    default ``Aspire`` raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    p = GaussianMixtureProblem(dims=2)
    with pytest.raises((RuntimeError, AssertionError)):
        Flow(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, seed=0)
    init = Samples(p.draw_initial_samples(np.random.default_rng(0), 64))
    with pytest.raises((RuntimeError, AssertionError)):
        asp.fit(init, n_epochs=1, batch_size=32)
    assert asp.flow is None or asp.flow.device.type == "cuda"
