"""aspire_tpu_torch SMC building blocks against the JAX package (float64):
the beta bisection and per-iteration statistics, resampling with a fixed
uniform, the evidence reductions of the sample containers; the sampler's
per-temperature sample history against the JAX package's, and the
sampler options the port refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu import samples as JS
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu.ops import resampling as JR
from aspire_tpu.ops import special as JSP
from aspire_tpu.samplers import smc as JSMC
from aspire_tpu_torch import samples as TS
from aspire_tpu_torch.ops import resampling as TR
from aspire_tpu_torch.ops import special as TSP
from aspire_tpu_torch.samplers import smc as TSMC

torch.set_num_threads(1)


def _dens(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(-3.0, 2.0, n), rng.normal(-1.0, 0.5, n),
            rng.normal(-2.0, 1.0, n))


def _close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), atol=tol, rtol=0)


@pytest.mark.parametrize("beta_prev,target", [(0.0, 0.5), (0.3, 0.8),
                                              (0.9, 0.2)])
def test_bisect_beta_matches_jax(beta_prev, target):
    ll, lp, lq = _dens()
    delta = ll + lp - lq
    want = JSMC._bisect_beta(jnp.asarray(delta), beta_prev, target, 1e-8)
    got = TSMC.bisect_beta(torch.as_tensor(delta), beta_prev, target, 1e-8)
    _close(got, want)


@pytest.mark.parametrize("adaptive,adaptive_min_step",
                         [(True, False), (True, True), (False, False)])
def test_iteration_stats_match_jax(adaptive, adaptive_min_step):
    ll, lp, lq = _dens(seed=1)
    args = (0.2, 0.45, 0.5, 1e-8, 0.01, 0.6)
    want = JSMC._iteration_stats(
        jnp.asarray(ll), jnp.asarray(lp), jnp.asarray(lq), *args,
        adaptive=adaptive, adaptive_min_step=adaptive_min_step)
    got = TSMC.iteration_stats(
        torch.as_tensor(ll), torch.as_tensor(lp), torch.as_tensor(lq), *args,
        adaptive=adaptive, adaptive_min_step=adaptive_min_step)
    _close(got.numpy(), np.asarray([float(v) for v in want]))


@pytest.mark.parametrize("n_out", [None, 300])
def test_systematic_resample_with_fixed_uniform(n_out):
    log_w = np.random.default_rng(2).normal(size=500) * 2.0
    key = jax.random.key(11)
    want = JR.systematic_resample(key, jnp.asarray(log_w), n_out)
    u = float(jax.random.uniform(key, ()))
    got = TR.systematic_resample(None, torch.as_tensor(log_w), n_out,
                                 u=torch.tensor(u, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_resamplers_return_valid_indices(method):
    log_w = torch.as_tensor(np.random.default_rng(3).normal(size=400))
    log_w[:200] = -np.inf  # zero-weight particles are never picked
    gen = torch.Generator().manual_seed(0)
    idx = TR.get_resampler(method)(gen, log_w, 1000)
    assert idx.shape == (1000,)
    assert int(idx.min()) >= 200 and int(idx.max()) < 400


def test_smc_samples_evidence_matches_jax():
    ll, lp, lq = _dens(seed=4)
    x = np.random.default_rng(4).normal(size=(500, 2))
    js = JS.SMCSamples(x=jnp.asarray(x), log_likelihood=jnp.asarray(ll),
                       log_prior=jnp.asarray(lp), log_q=jnp.asarray(lq),
                       beta=0.3)
    ts = TS.SMCSamples(x=x, log_likelihood=ll, log_prior=lp, log_q=lq,
                       beta=0.3)
    for name in ("log_evidence_ratio", "log_evidence_ratio_variance",
                 "log_weights"):
        _close(getattr(ts, name)(0.55).numpy(), getattr(js, name)(0.55))


def test_samples_weights_match_jax():
    ll, lp, lq = _dens(seed=5)
    x = np.random.default_rng(5).normal(size=(500, 2))
    js = JS.Samples(x=jnp.asarray(x), log_likelihood=jnp.asarray(ll),
                    log_prior=jnp.asarray(lp), log_q=jnp.asarray(lq))
    ts = TS.Samples(x=x, log_likelihood=ll, log_prior=lp, log_q=lq)
    for name in ("log_evidence", "log_evidence_error",
                 "effective_sample_size", "efficiency"):
        _close(float(getattr(ts, name)), float(getattr(js, name)))


@pytest.mark.parametrize("case", ["normal", "all_neg_inf", "pos_inf"])
def test_special_reductions_match_jax(case):
    log_w = np.random.default_rng(6).normal(size=64) * 3.0
    if case == "all_neg_inf":
        log_w[:] = -np.inf
    elif case == "pos_inf":
        log_w[3] = np.inf
    for jf, tf in ((JSP.logsumexp, TSP.logsumexp),
                   (JSP.effective_sample_size, TSP.effective_sample_size)):
        np.testing.assert_allclose(
            float(tf(torch.as_tensor(log_w))), float(jf(jnp.asarray(log_w))),
            rtol=1e-12, equal_nan=True)
    if case == "normal":
        want = JSP.log_evidence_from_log_weights(jnp.asarray(log_w))
        got = TSP.log_evidence_from_log_weights(torch.as_tensor(log_w))
        _close([float(g) for g in got], [float(w) for w in want])


# A small problem run by both packages: a 2-d mixture, a small nsf flow
# fitted briefly, a fixed 4-rung ladder (beta 0.25, 0.5, 0.75, 1), so both
# run the same number of temperatures whatever their random streams.
HISTORY_FLOW = dict(flow_backend="nsf", n_hidden=(8, 8), n_layers=2)
HISTORY_FIT = dict(n_epochs=2, batch_size=128, learning_rate=3e-3)
HISTORY_RUN = dict(sampler="smc", n_steps=4, adaptive=False,
                   sampler_kwargs=dict(n_steps=2))


def _port_sampler(n, **kw):
    p = GaussianMixtureProblem(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, seed=1, device="cpu", **HISTORY_FLOW)
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            **HISTORY_FIT)
    asp.sample_posterior(n_samples=n, **HISTORY_RUN, **kw)
    return asp.sampler


@pytest.fixture(scope="module")
def jax_history():
    p = JMixture(dims=2)
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=2, seed=1, **HISTORY_FLOW)
    asp.fit(JSamples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            **HISTORY_FIT)
    asp.sample_posterior(n_samples=256, **HISTORY_RUN)
    return asp.sampler.history


def test_sample_history_matches_jax(jax_history):
    """``store_sample_history=None`` at n <= 10 000 records, as in the JAX
    package, the population before the first temperature and after every
    mutation: the same number of snapshots, the same shapes, the rungs in
    the same order (the values differ: the random streams do)."""
    history = _port_sampler(256).history
    want, got = jax_history.sample_history, history.sample_history
    assert len(got) == len(want) == len(history.beta) + 1 == 5
    for g, w in zip(got, want):
        for name in ("x", "log_q", "log_prior", "log_likelihood"):
            value = getattr(g, name)
            assert isinstance(value, np.ndarray)
            assert value.shape == np.shape(getattr(w, name))
    betas = [float(s.beta) for s in got]
    assert betas == [float(s.beta) for s in want] == [0.0, *history.beta]
    assert not np.shares_memory(got[0].x, got[1].x)


@pytest.mark.parametrize("n,store,count", [
    (10_240, None, 0),   # above 10 000: nothing by default
    (10_240, True, 5),   # asked for: recorded at any size
    (256, False, 0),     # refused at a small size
])
def test_sample_history_follows_its_option(n, store, count):
    history = _port_sampler(n, store_sample_history=store).history
    assert len(history.sample_history) == count
    assert all(s.x.shape == (n, 2) for s in history.sample_history)


@pytest.mark.parametrize("name", ["waste_free", "windowed_tau",
                                  "flow_moves"])
def test_unported_sampler_options_raise(name):
    """Options the JAX package reads and the port does not implement
    raise rather than return a standard-SMC result."""
    sampler = TSMC.PCNSMC(log_likelihood=lambda x: x.sum(-1),
                          log_prior=lambda x: x.sum(-1), dims=2,
                          prior_flow=None, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        sampler.sample(64, sampler_kwargs={name: True})


@pytest.mark.parametrize("where", ["Aspire", "sample_posterior"])
@pytest.mark.parametrize("name,value", [("prng_impl", "rbg"),
                                        ("resampling_impl", "ring")])
def test_unported_impl_options_raise(name, value, where):
    """``prng_impl`` and ``resampling_impl`` are in no signature of the
    port: given to ``Aspire`` (which hands unknown keywords to the flow)
    or to ``sample_posterior``, they raise instead of being dropped."""
    p = GaussianMixtureProblem(dims=2)
    init = Samples(p.draw_initial_samples(np.random.default_rng(0), 64))
    kw = {name: value}
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, device="cpu", flow_backend="nsf",
                 **(kw if where == "Aspire" else {}))
    with pytest.raises(TypeError, match=name):
        asp.fit(init, n_epochs=1, batch_size=32)
        asp.sample_posterior(sampler="smc", n_samples=256, **kw)
