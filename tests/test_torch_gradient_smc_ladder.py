"""The gradient and ensemble SMC samplers of ``aspire_tpu_torch`` end to end
on the CPU: the registry, each name against the mixture's analytic log Z
(``tests/test_integration.py``'s kwargs and tolerance), both ladders one
run for one seed, NUTS on the host ladder only, and the refusal of a
target autograd cannot differentiate.
"""

import numpy as np
import pytest
import torch

from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.samplers import (
    EnsembleSMC,
    HMCSMC,
    MALASMC,
    NUTSSMC,
    RWMHSMC,
    get_sampler_class,
)
from aspire_tpu_torch.samplers.smc import NUTS_LADDER_REFUSAL

torch.set_num_threads(1)

N, D = 512, 2
SMALL = dict(flow_backend="nsf", architecture="nsf-tpu", n_hidden=(16, 16),
             n_layers=2)
#: tests/test_integration.py:66-75's sampler_kwargs for these samplers
SAMPLER_CONFIGS = {
    "emcee_smc": {"n_steps": 10},
    "ensemble_smc": {"n_steps": 10},
    "hmc_smc": {"n_steps": 5, "n_leapfrog": 5},
    "blackjax_smc": {"n_steps": 5, "n_leapfrog": 5},
    "rwmh_smc": {"n_steps": 10},
    "nuts_smc": {"n_steps": 5, "n_leapfrog": 5},
    "mala_smc": {"n_steps": 10},
}


def test_registry_resolves_the_ported_names():
    want = {"ensemble_smc": EnsembleSMC, "emcee_smc": EnsembleSMC,
            "rwmh_smc": RWMHSMC, "mala_smc": MALASMC, "hmc_smc": HMCSMC,
            "blackjax_smc": HMCSMC, "nuts_smc": NUTSSMC}
    for name, cls in want.items():
        assert get_sampler_class(name) is cls
        assert get_sampler_class(name.upper()) is cls
    with pytest.raises(ValueError, match="Unknown sampler"):
        get_sampler_class("no_such_sampler")


@pytest.mark.parametrize("name", ["mcmc", "pcn", "minipcn", "ensemble",
                                  "emcee", "ptmcmc", "parallel_tempered"])
def test_unported_mcmc_samplers_raise(name):
    """The standalone MCMC samplers, once unported, all resolve to their
    classes now: pCN, ensemble and parallel-tempered."""
    want = {"ensemble": "EnsembleSampler", "emcee": "EnsembleSampler",
            "ptmcmc": "ParallelTemperedSampler",
            "parallel_tempered": "ParallelTemperedSampler"}.get(
                name, "PCNSampler")
    assert get_sampler_class(name).__name__ == want


@pytest.fixture(scope="module")
def fitted():
    p = GaussianMixtureProblem(dims=D)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=D, seed=1, device="cpu", **SMALL)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    return p, asp


def _run(asp, sampler, chain, **kw):
    kw.setdefault("store_sample_history", False)
    return asp.sample_posterior(sampler=sampler, n_samples=N,
                                return_history=True, sampler_kwargs=chain,
                                **kw)


@pytest.mark.parametrize("sampler", sorted(SAMPLER_CONFIGS))
def test_sampler_matches_the_analytic_evidence(fitted, sampler):
    """Each name through ``Aspire.sample_posterior``: finite samples, log Z
    within 0.5 of the analytic value, RWMH on the whole-chain kernel (its
    plain version here) and the others on the split chain; NUTS on the
    host ladder, every other on the device ladder."""
    p, asp = fitted
    post, hist = _run(asp, sampler, SAMPLER_CONFIGS[sampler])
    assert post.x.shape == (N, D) and bool(torch.isfinite(post.x).all())
    assert abs(post.log_evidence - p.true_log_evidence()) < 0.5
    route = "fused_kernel" if sampler == "rwmh_smc" else "split"
    assert hist.mutation_route == [route] * len(hist.beta)
    assert (asp.sampler.ladder is None) == (sampler == "nuts_smc")


@pytest.mark.parametrize("sampler,chain", [
    ("rwmh_smc", {"n_steps": 4}),
    ("mala_smc", {"n_steps": 4}),
    ("hmc_smc", {"n_steps": 2, "n_leapfrog": 3}),
    ("hmc_smc", {"n_steps": 2, "n_leapfrog": 3, "jitter_trajectory": True}),
    ("emcee_smc", {"n_steps": 4}),
])
def test_device_ladder_repeats_the_host_ladder(fitted, sampler, chain):
    """One seed, both ladders: the same rungs, history, particles and
    evaluation count, bit for bit (the gradient runs differentiate inside
    the device ladder's body; the jittered HMC keeps its drawn length on
    the device)."""
    _, asp = fitted
    host, hh = _run(asp, sampler, chain, device_ladder=False)
    hs = asp.sampler
    dev, dh = _run(asp, sampler, chain, device_ladder=True)
    ds = asp.sampler
    assert hs.ladder is None and ds.ladder is not None
    assert dh.beta[-1] == 1.0 and len(dh.beta) == len(hh.beta) > 1
    for name in ("beta", "ess", "log_norm_ratio", "log_norm_ratio_var",
                 "mcmc_acceptance", "mcmc_autocorr", "lineage_fraction",
                 "mutation_route", "nonfinite_target"):
        assert getattr(dh, name) == getattr(hh, name), name
    assert torch.equal(dev.x, host.x)
    assert ds.n_likelihood_evaluations == hs.n_likelihood_evaluations


def test_evaluation_counts(fitted):
    """A split mutation counts its start and refresh passes and its
    chain's evaluations: an HMC step n_leapfrog per particle, a jittered
    one its drawn length (so at most n_leapfrog)."""
    _, asp = fitted
    _, hist = _run(asp, "hmc_smc", {"n_steps": 2, "n_leapfrog": 3})
    rungs = len(hist.beta)
    # the initial draws count one likelihood evaluation per particle
    assert asp.sampler.n_likelihood_evaluations == N + rungs * N * (2 * 3 + 2)
    _, hist = _run(asp, "hmc_smc", {"n_steps": 2, "n_leapfrog": 3,
                                    "jitter_trajectory": True})
    evals = asp.sampler.n_likelihood_evaluations - N - 2 * N * len(hist.beta)
    assert evals % N == 0 and 2 * len(hist.beta) * N <= evals <= (
        6 * len(hist.beta) * N)


def test_nuts_runs_on_the_host_ladder_only(fitted):
    _, asp = fitted
    chain = {"n_steps": 1, "max_depth": 3}
    _run(asp, "nuts_smc", chain)
    assert asp.sampler.ladder is None
    assert asp.sampler._ladder_refusal() == NUTS_LADDER_REFUSAL
    with pytest.raises(ValueError, match="cannot capture NUTS"):
        _run(asp, "nuts_smc", chain, device_ladder=True)


@pytest.mark.parametrize("sampler", ["mala_smc", "hmc_smc", "nuts_smc"])
def test_a_target_autograd_cannot_differentiate_raises(fitted, sampler):
    """A likelihood that leaves torch (``.numpy()``) cannot give a
    gradient: the gradient kernels raise the JAX package's ValueError
    instead of running without one; RWMH and the stretch move need none."""
    p, asp = fitted

    def host_log_likelihood(samples):
        x = samples.x.numpy()
        return torch.as_tensor(np.sum(-0.5 * (x - 1.0) ** 2, axis=-1))

    host = Aspire(log_likelihood=host_log_likelihood,
                  log_prior=p.log_prior, dims=D, flow=asp.flow, seed=1,
                  device="cpu", **SMALL)
    with pytest.raises(ValueError, match="differentiable"):
        _run(host, sampler, {"n_steps": 1, "max_depth": 2,
                             "n_leapfrog": 2}, device_ladder=False)
    assert not host.sampler.target_is_differentiable()
    post, _ = _run(host, "emcee_smc", {"n_steps": 2}, device_ladder=False)
    assert bool(torch.isfinite(post.x).all())


def test_chip_smoke_gradient_checks_run_on_the_cpu():
    """``chip_smoke.py``'s gradient check (the plain VJP at the flow's own
    cotangents, here the plain pass itself) and its RWMH chain check, on
    the CPU at small sizes."""
    import chip_smoke

    cpu = torch.device("cpu")
    for name in ("nsf-tpu d=2", "maf-rqs d=4"):
        out = chip_smoke.gradient_check(cpu, name, 512)
        assert out["grad_equals_plain_vjp"] and out["value_max_abs_err"] == 0
    out = chip_smoke.phase_chain(cpu, 512, 3, chip_smoke.rwmh_chain_setup)
    assert out["max_abs_err"] == 0.0
