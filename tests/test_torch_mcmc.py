"""The port's standalone MCMC samplers and ``MCMCSamples`` against the JAX
package's.

The posterior density in the preconditioned space on the same points with
the same (converted) preconditioning, float64 1e-10; every ``MCMCSamples``
method on one numpy chain; ``run_chain``'s stored chain; the sampler
registry; then the pCN and ensemble samplers end to end on the CPU,
plain and flow-preconditioned.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import samplers as jsamplers
from aspire_tpu.samplers.mcmc import PCNSampler as JPCNSampler
from aspire_tpu.samples import MCMCSamples as JMCMCSamples
from aspire_tpu.transforms import CompositeTransform as JComposite
from aspire_tpu_torch import Aspire, MCMCSamples, Samples
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.samplers import (
    SAMPLER_REGISTRY,
    EnsembleSampler,
    ParallelTemperedSampler,
    PCNSampler,
    get_sampler_class,
)
from aspire_tpu_torch.samplers import kernels as K
from aspire_tpu_torch.utils import transform_from_jax


torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
D = 3


def _target(xp):
    """A likelihood that is NaN where x_0 > 2.5, and a normal prior, in
    the array namespace ``xp``."""
    def log_likelihood(s):
        x = s.x
        ll = -0.5 * xp.sum((x - 1.0) ** 2, axis=-1)
        return xp.where(x[:, 0] > 2.5, xp.nan, ll)

    def log_prior(s):
        return -0.5 * xp.sum(s.x**2 / 9.0, axis=-1)

    return log_likelihood, log_prior


class _TorchOps:
    nan = math.nan

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, torch.as_tensor(a, dtype=b.dtype), b)


def _preconditioning(kind):
    """None, or a fitted logit + affine composite (the flow
    preconditioning's transport is held against the JAX package's in
    ``test_torch_flow_precond.py``)."""
    names = [f"x_{i}" for i in range(D)]
    if kind == "none":
        return None, None
    bounds = {n: [-6.0, 8.0] for n in names}
    jt = JComposite(parameters=names, prior_bounds=bounds,
                    bounded_transform="logit", dtype="float64")
    jt.fit(jnp.asarray(1.0 + np.random.default_rng(0).normal(size=(256, D))))
    return jt, transform_from_jax(jt, dtype="float64", device="cpu")


@pytest.mark.parametrize("kind", ["none", "composite"])
def test_make_log_prob_matches_jax(kind):
    jt, tt = _preconditioning(kind)
    jll, jlp = _target(jnp)
    tll, tlp = _target(_TorchOps)
    common = dict(dims=D, prior_flow=None, dtype="float64",
                  parameters=[f"x_{i}" for i in range(D)])
    jfn = JPCNSampler(log_likelihood=jll, log_prior=jlp,
                      preconditioning_transform=jt, **common).make_log_prob()
    tfn = PCNSampler(log_likelihood=tll, log_prior=tlp,
                     preconditioning_transform=tt, device="cpu",
                     **common).make_log_prob()
    z = 1.2 * np.random.default_rng(5).normal(size=(200, D))
    want = np.asarray(jfn(jnp.asarray(z)))
    got = tfn(torch.as_tensor(z)).numpy()
    assert np.isneginf(want).any() and not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, **TOL)


def _chain():
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.normal(size=(60, 8, D)), axis=0) * 0.3
    return x, rng.normal(size=60 * 8), rng.normal(size=60 * 8)


def test_mcmc_samples_methods_match_jax():
    chain, ll, lp = _chain()
    j = JMCMCSamples.from_chain(jnp.asarray(chain), dtype="float64")
    t = MCMCSamples.from_chain(torch.as_tensor(chain), dtype="float64")
    j.log_likelihood, j.log_prior = jnp.asarray(ll), jnp.asarray(lp)
    t.log_likelihood, t.log_prior = torch.as_tensor(ll), torch.as_tensor(lp)
    assert t.chain_shape == j.chain_shape == (60, 8)
    np.testing.assert_array_equal(t.chain.numpy(), np.asarray(j.chain))
    np.testing.assert_allclose(t.compute_autocorrelation_time().numpy(),
                               np.asarray(j.compute_autocorrelation_time()),
                               **TOL)
    for burn_in, thin in ((None, None), (10, 3), (0, 7)):
        pj = j.post_process(burn_in=burn_in, thin=thin)
        pt = t.post_process(burn_in=burn_in, thin=thin)
        assert (pt.chain_shape, pt.burn_in, pt.thin) == (
            pj.chain_shape, pj.burn_in, pj.thin)
        for name in ("x", "log_likelihood", "log_prior"):
            np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                          np.asarray(getattr(pj, name)))
        assert pt.log_q is None and pj.log_q is None
    processed = t.post_process(burn_in=10, thin=3)
    again = processed.post_process()
    assert again.chain_shape == processed.chain_shape
    sj, st = j[5:37], t[5:37]
    assert st.chain_shape == sj.chain_shape == (32, 1)
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
    np.testing.assert_array_equal(st.autocorrelation_time.numpy(),
                                  np.asarray(sj.autocorrelation_time))
    two_d = MCMCSamples.from_chain(torch.as_tensor(chain[:, 0]))
    assert two_d.chain_shape == JMCMCSamples.from_chain(
        jnp.asarray(chain[:, 0])).chain_shape == (60, 1)
    s = t.to_samples()
    assert isinstance(s, Samples) and not isinstance(s, MCMCSamples)
    np.testing.assert_array_equal(s.x.numpy(), t.x.numpy())
    with pytest.raises(ValueError, match="chain_shape"):
        MCMCSamples(x=torch.zeros(4, 2)).chain


def test_run_chain_stores_the_chain():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(64, D)))
    ref = K.fit_gaussian_reference(x)

    def log_prob(z):
        return -0.5 * torch.sum((z - 1.0) ** 2, dim=-1)

    def run(store):
        gen = torch.Generator().manual_seed(3)
        state = K.ChainState(x=x, log_prob=log_prob(x),
                             step_size=torch.tensor(0.5, dtype=x.dtype),
                             n_accept=torch.zeros(64, dtype=x.dtype))
        return K.run_chain(lambda s: K.tpcn_step(s, gen, log_prob, ref),
                           state, 7, store_chain=store)

    final, stats, chain = run(True)
    plain_final, plain_stats = run(False)
    assert chain.shape == (7, 64, D)
    assert torch.equal(chain[-1], final.x)
    assert torch.equal(final.x, plain_final.x)
    assert torch.equal(stats.tau, plain_stats.tau)
    assert not torch.equal(chain[0], chain[-1])


def test_registry_matches_jax():
    resolved = jsamplers.SAMPLER_REGISTRY
    assert len(resolved) == 18 and set(SAMPLER_REGISTRY) == set(resolved)
    for key, cls in resolved.items():
        assert get_sampler_class(key).__name__ == cls.__name__
        assert get_sampler_class(key.upper()) is SAMPLER_REGISTRY[key]
    for key in ("ptmcmc", "parallel_tempered"):
        assert get_sampler_class(key) is ParallelTemperedSampler


@pytest.fixture(scope="module")
def gaussian():
    """The bounded 4-d Gaussian (N(2, 1) likelihood on U(-10, 10)^4) with
    a small nsf fitted to draws around it."""
    p = GaussianProblem(dims=4)
    x = np.random.default_rng(0).normal(1.8, 1.3, size=(2048, 4))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, prior_bounds=p.prior_bounds, flow_backend="nsf",
                 architecture="nsf", n_layers=2, n_hidden=(16, 16), seed=1,
                 device="cpu")
    asp.fit(Samples(x), n_epochs=10, batch_size=256)
    return p, asp


def _moments_hold(samples, walkers, kept):
    x = samples.x.double()
    tau = samples.compute_autocorrelation_time().numpy()
    assert np.all(np.isfinite(tau)) and np.all(tau > 0)
    se = x.std(0).numpy() * np.sqrt(tau / (walkers * kept))
    mean, sd = x.mean(0).numpy(), x.std(0).numpy()
    assert np.all(np.abs(mean - 2.0) < np.maximum(5 * se, 0.02)), (mean, se)
    # sd's standard error for a normal is sd / sqrt(2 N_eff).
    assert np.all(np.abs(sd - 1.0) < np.maximum(5 * se / math.sqrt(2),
                                                0.02)), (sd, se)


@pytest.mark.parametrize("run", [
    dict(sampler="minipcn", step_fn="tpcn", burn_in=10),
    dict(sampler="pcn", step_fn="pcn", n_steps=60, burn_in=20),
    dict(sampler="emcee", n_steps=150, burn_in=75),
    dict(sampler="minipcn", burn_in=10, preconditioning="flow",
         preconditioning_kwargs=dict(fit_kwargs=dict(n_epochs=5,
                                                     batch_size=256))),
], ids=["tpcn", "pcn", "emcee", "tpcn-flow"])
def test_standalone_samplers_on_the_bounded_gaussian(gaussian, run):
    """Walkers started from the flow (fitted to draws around N(1.8, 1.3)):
    each dimension's mean and sd within max(5 SE, 0.02) of 2 and 1, SE
    from N_eff = walkers x kept steps / tau; the default 5 d = 20 steps
    where none are given."""
    p, asp = gaussian
    walkers = 1024
    samples = asp.sample_posterior(n_samples=walkers, **run)
    sampler = asp.sampler
    assert isinstance(sampler, EnsembleSampler if run["sampler"] == "emcee"
                      else PCNSampler)
    steps, burn_in = run.get("n_steps", 5 * 4), run["burn_in"]
    kept = steps - burn_in
    assert isinstance(samples, MCMCSamples)
    assert samples.chain_shape == (kept, walkers)
    assert samples.burn_in == burn_in and samples.thin == 1
    assert 0.05 < samples.acceptance_rate < 1.0
    assert sampler.n_likelihood_evaluations == (
        walkers + (steps + 1) * walkers + steps * walkers)
    _moments_hold(samples, walkers, kept)


def test_unknown_step_fn_and_checkpoints_raise(gaussian, tmp_path):
    """An unknown step function raises; a chain checkpoint writes the
    finished data-space chain (before burn-in), as the JAX package's."""
    _, asp = gaussian
    with pytest.raises(ValueError, match="Unknown step function"):
        asp.sample_posterior(sampler="minipcn", n_samples=64, step_fn="rwmh")
    for sampler in ("minipcn", "emcee"):
        path = str(tmp_path / f"{sampler}.h5")
        samples = asp.sample_posterior(sampler=sampler, n_samples=64,
                                       n_steps=3, burn_in=1,
                                       checkpoint_file_path=path)
        chain, it = asp.sampler.load_chain_checkpoint(path)
        assert chain.shape == (3, 64, asp.dims) and it == 3
        np.testing.assert_array_equal(chain[1:].reshape(-1, asp.dims),
                                      samples.x.numpy())
    # checkpoint_every <= 0 disables the checkpoint, as in the JAX package
    # (the facade's run file still gets its config and flow).
    path = tmp_path / "off.h5"
    samples = asp.sample_posterior(sampler="emcee", n_samples=64, n_steps=2,
                                   checkpoint_path=str(path),
                                   checkpoint_every=0)
    assert samples.chain_shape == (2, 64)
    import h5py

    with h5py.File(path, "r") as f:
        assert "flow" in f and "checkpoint/mcmc_chain" not in f
