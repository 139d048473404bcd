"""aspire_tpu_torch SMC building blocks against the JAX package (float64):
the beta bisection and per-iteration statistics, resampling with a fixed
uniform, the evidence reductions of the sample containers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import samples as JS
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
