"""The port's ``PTMCMCSamples``, its ladder functions and the replicate
tier against the JAX package's, and the facade's keyword rule.

Every estimator and method of ``PTMCMCSamples`` on one numpy ladder in
both packages, float64 1e-10 (the stepping stone also on a prior rung
whose logL spans 1e19 and beside an all ``-inf`` rung); ``_bisect_pt_beta``,
``adaptive_beta_ladder`` and ``refine_ladder_from_run`` on the same probe
and pilot arrays; ``combine_replicates`` and the SMC and PT
``n_replicates`` tiers; every sampler's ``sample()`` parameter names
against the JAX package's; ``sample_posterior``'s drop of keywords no
sampler takes, and the checkpoint arguments the port once refused.
"""

import inspect
import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import samplers as jsamplers
from aspire_tpu.samplers.base import combine_replicates as jcombine
from aspire_tpu.samplers.mcmc import ParallelTemperedSampler as JPT
from aspire_tpu.samplers.mcmc import _bisect_pt_beta as jbisect
from aspire_tpu.samples import PTMCMCSamples as JPTSamples
from aspire_tpu.samples import Samples as JSamples
from aspire_tpu_torch import Aspire, PTMCMCSamples, Samples
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.samplers import (
    SAMPLER_REGISTRY,
    ParallelTemperedSampler,
    PCNSMC,
    get_sampler_class,
)
from aspire_tpu_torch.samplers.base import combine_replicates
from aspire_tpu_torch.samplers.mcmc import _bisect_pt_beta

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
BETAS = np.array([1.0, 0.6, 0.25, 0.05, 0.0])
T, S, W, D = len(BETAS), 40, 6, 2


def _ladder(log_l=None, seed=0):
    """One ladder ``(T, S, W, d)`` with its densities, numpy."""
    rng = np.random.default_rng(seed)
    chain = np.cumsum(rng.normal(size=(T, S, W, D)), axis=1) * 0.3
    if log_l is None:
        # Rung means rise toward the cold rung, each an AR(1) series.
        log_l = np.empty((T, S, W))
        e = rng.normal(size=(T, W))
        for s in range(S):
            e = 0.7 * e + rng.normal(size=(T, W))
            log_l[:, s] = -5.0 * (1 - BETAS)[:, None] ** 2 + e
    log_p = rng.normal(size=(T, S, W))
    return chain, log_l, log_p


def _both(chain, log_l, log_p, betas=BETAS, move=None, swap=None):
    kw = dict(chain_shape=chain.shape[:-1], dtype="float64", betas=betas,
              move_acceptance=move, swap_acceptance=swap)
    j = JPTSamples(x=jnp.asarray(chain.reshape(-1, D)),
                   log_likelihood=jnp.asarray(log_l.reshape(-1)),
                   log_prior=jnp.asarray(log_p.reshape(-1)), **kw)
    t = PTMCMCSamples(x=torch.as_tensor(chain.reshape(-1, D)),
                      log_likelihood=torch.as_tensor(log_l.reshape(-1)),
                      log_prior=torch.as_tensor(log_p.reshape(-1)), **kw)
    return j, t


def _same(t, j, names=("x", "log_likelihood", "log_prior")):
    for name in names:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_pt_samples_methods_match_jax():
    move, swap = np.linspace(0.3, 0.7, T), np.linspace(0.2, 0.9, T - 1)
    j, t = _both(*_ladder(), move=move, swap=swap)
    assert t.n_temperatures == j.n_temperatures == T
    np.testing.assert_array_equal(t.chain.numpy(), np.asarray(j.chain))
    np.testing.assert_allclose(t.compute_autocorrelation_time().numpy(),
                               np.asarray(j.compute_autocorrelation_time()),
                               **TOL)
    assert t.autocorrelation_time.shape == (T, D)
    for idx in (0, 3):
        rj, rt = j.at_temperature(idx), t.at_temperature(idx)
        assert rt.chain_shape == rj.chain_shape == (S, W)
        _same(rt, rj)
        np.testing.assert_allclose(rt.autocorrelation_time.numpy(),
                                   np.asarray(rj.autocorrelation_time),
                                   **TOL)
    _same(t.cold_chain(), j.cold_chain())
    for burn_in, thin in ((None, None), (5, 2), (0, 7)):
        pj = j.post_process(burn_in=burn_in, thin=thin)
        pt = t.post_process(burn_in=burn_in, thin=thin)
        assert (pt.chain_shape, pt.burn_in, pt.thin) == (
            pj.chain_shape, pj.burn_in, pj.thin)
        _same(pt, pj)
        np.testing.assert_array_equal(pt.betas, pj.betas)
        np.testing.assert_array_equal(pt.move_acceptance, move)
        np.testing.assert_array_equal(pt.swap_acceptance, swap)
    with pytest.raises(NotImplementedError, match="at_temperature"):
        t[0:3]
    # The JAX package's ladder plot: two panels, the pairs and the rungs.
    import matplotlib

    matplotlib.use("Agg")
    fig = t.plot_ladder()
    assert len(fig.axes) == 2
    np.testing.assert_array_equal(fig.axes[1].get_lines()[0].get_ydata(),
                                  move)
    import matplotlib.pyplot as plt

    plt.close(fig)


@pytest.mark.parametrize("burn_in_fraction", [0.1, None, 0.3])
@pytest.mark.parametrize("correlated", [True, False])
def test_evidence_estimators_match_jax(burn_in_fraction, correlated):
    j, t = _both(*_ladder())
    kw = dict(burn_in_fraction=burn_in_fraction, correlated=correlated)
    for method in ("variance", "coarse", "total"):
        np.testing.assert_allclose(
            t.log_evidence_thermodynamic_integration(method=method, **kw),
            j.log_evidence_thermodynamic_integration(method=method, **kw),
            **TOL)
    np.testing.assert_allclose(t.log_evidence_stepping_stone(**kw),
                               j.log_evidence_stepping_stone(**kw), **TOL)
    with pytest.raises(ValueError, match="Unknown TI error method"):
        t.log_evidence_thermodynamic_integration(method="other")


def test_stepping_stone_on_a_funnel_prior_rung_and_an_empty_rung():
    """A prior rung whose logL spans 1e19 stays finite and equal; an all
    ``-inf`` rung gives ``-inf`` (its error NaN) in both packages."""
    chain, log_l, log_p = _ladder(seed=1)
    wide = log_l.copy()
    wide[-1] = -np.logspace(0, 19, S * W).reshape(S, W)
    j, t = _both(chain, wide, log_p)
    got = t.log_evidence_stepping_stone()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, j.log_evidence_stepping_stone(), **TOL)
    empty = log_l.copy()
    empty[2] = -np.inf
    j, t = _both(chain, empty, log_p)
    got, want = t.log_evidence_stepping_stone(), j.log_evidence_stepping_stone()
    assert got[0] == want[0] == -np.inf
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_estimator_refusals_match_jax():
    chain, log_l, log_p = _ladder()
    hot = np.array([1.0, 0.6, 0.25, 0.05, 0.01])
    for betas, call, burn_in, match in (
            (hot, "log_evidence_stepping_stone", 0.1, "beta=0"),
            (None, "log_evidence_thermodynamic_integration", 0.1,
             "betas=None"),
            (BETAS, "log_evidence_stepping_stone", 1.0, "Burn-in removed")):
        for s in _both(chain, log_l, log_p, betas=betas):
            with pytest.raises(ValueError, match=match):
                getattr(s, call)(burn_in_fraction=burn_in)


@pytest.mark.parametrize("betas,match", [
    (np.ones((T, 1)), "one-dimensional"),
    (BETAS[:-1], "temperature rungs"),
    (BETAS[::-1], "strictly decreasing"),
    (np.array([0.9, 0.6, 0.25, 0.05, 0.0]), "start at 1"),
])
def test_betas_contract_matches_jax(betas, match):
    chain, log_l, log_p = _ladder()
    for cls, arr in ((JPTSamples, jnp.asarray), (PTMCMCSamples,
                                                 torch.as_tensor)):
        with pytest.raises(ValueError, match=match):
            cls(x=arr(chain.reshape(-1, D)), chain_shape=(T, S, W),
                betas=betas)


def test_subsample_draws_each_rung_on_its_own():
    move, swap = np.linspace(0.3, 0.7, T), np.linspace(0.2, 0.9, T - 1)
    chain, log_l, log_p = _ladder()
    # Every (step, walker) entry of every rung carries its own index.
    tag = np.broadcast_to(np.arange(S * W).reshape(S, W), (T, S, W))
    _, t = _both(chain, tag.astype(float), log_p, move=move, swap=swap)
    sub = t.subsample(50, generator=torch.Generator().manual_seed(0))
    assert sub.chain_shape == (T, 50, 1) and sub.x.shape == (T * 50, D)
    np.testing.assert_array_equal(sub.betas, BETAS)
    np.testing.assert_array_equal(sub.move_acceptance, move)
    np.testing.assert_array_equal(sub.swap_acceptance, swap)
    idx = sub.log_likelihood.numpy().reshape(T, 50).astype(int)
    assert all(len(set(row)) == 50 for row in idx)  # without replacement
    assert len({tuple(row) for row in idx}) == T  # independent per rung
    # x and the densities stay paired with their entries.
    flat = chain.reshape(T, S * W, D)
    np.testing.assert_array_equal(
        sub.x.numpy().reshape(T, 50, D),
        np.take_along_axis(flat, idx[:, :, None], axis=1))
    again = t.subsample(50, rng=np.random.default_rng(3))
    assert again.chain_shape == (T, 50, 1)
    with pytest.raises(ValueError, match="Cannot subsample"):
        t.subsample(S * W + 1)


def _probe(seed=0, n=600):
    """Probe densities: q = N(0, 1), prior N(0, 3^2), a likelihood
    N(1, 0.4^2) in two dims; a few entries -inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    log_q = -0.5 * np.sum(x**2, 1) - np.log(2 * np.pi)
    log_p = -0.5 * np.sum(x**2, 1) / 9.0 - np.log(2 * np.pi * 9.0)
    log_l = -0.5 * np.sum((x - 1.0) ** 2, 1) / 0.16
    log_l[:5] = -np.inf
    log_p[5:8] = -np.inf
    return x, log_l, log_p, log_q


def _samplers():
    common = dict(log_likelihood=None, log_prior=None, dims=2,
                  prior_flow=None, dtype="float64")
    return JPT(**common), ParallelTemperedSampler(device="cpu", **common)


def test_bisect_pt_beta_matches_jax():
    _, log_l, log_p, log_q = _probe()
    ok = np.isfinite(log_l) & np.isfinite(log_p)
    log_l, log_base = log_l[ok], (log_p - log_q)[ok]
    for beta_prev, target in ((0.0, 0.9), (0.01, 0.5), (0.3, 0.99)):
        want = jbisect(jnp.asarray(log_l), jnp.asarray(log_base),
                       jnp.asarray(beta_prev), target, 1e-8)
        got = _bisect_pt_beta(torch.as_tensor(log_l),
                              torch.as_tensor(log_base),
                              torch.tensor(beta_prev, dtype=torch.float64),
                              target, 1e-8)
        np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(target_efficiency=0.5, min_n_temperatures=9),
    dict(target_efficiency=0.99, max_n_temperatures=4),  # the cap
    dict(target_efficiency=0.3, ti_quadrature_tol=1e-3,
         max_n_temperatures=14),
], ids=["default", "floor", "cap", "quadrature"])
def test_adaptive_beta_ladder_matches_jax(kw):
    x, log_l, log_p, log_q = _probe()
    jp, tp = _samplers()
    want = jp.adaptive_beta_ladder(JSamples(
        x=jnp.asarray(x), log_likelihood=jnp.asarray(log_l),
        log_prior=jnp.asarray(log_p), log_q=jnp.asarray(log_q)), **kw)
    got = tp.adaptive_beta_ladder(Samples(
        x=torch.as_tensor(x), log_likelihood=torch.as_tensor(log_l),
        log_prior=torch.as_tensor(log_p), log_q=torch.as_tensor(log_q)), **kw)
    assert len(got) == len(want) and got[0] == 1.0 and got[-1] == 0.0
    np.testing.assert_allclose(got, want, **TOL)
    bad = Samples(x=torch.as_tensor(x[:3]),
                  log_likelihood=torch.full((3,), -np.inf,
                                            dtype=torch.float64),
                  log_prior=torch.as_tensor(log_p[:3]),
                  log_q=torch.as_tensor(log_q[:3]))
    with pytest.raises(ValueError, match="at least one probe sample"):
        tp.adaptive_beta_ladder(bad)


@pytest.mark.parametrize("case", [
    "equal_dE", "rescue", "cap", "rescue_cap", "flat", "flat_cap",
    "unmeasured"])
def test_refine_ladder_from_run_matches_jax(case):
    betas = np.array([1.0, 0.5, 0.2, 0.1, 0.02, 0.0])
    rng = np.random.default_rng(4)
    shape = (len(betas), 12, 5)
    means = -40.0 * (1 - betas) ** 4
    log_l = means[:, None, None] + rng.normal(size=shape)
    swap = None
    kw = dict(n_temperatures=8)
    if case.startswith("rescue"):
        swap = np.array([0.6, 0.05, 0.4, 0.1, 0.9])
    if case.endswith("cap"):
        kw["max_n_temperatures"] = 5
    if case.startswith("flat"):
        log_l = np.full(shape, -3.0)
        swap = np.array([0.6, 0.05, 0.4, 0.1, 0.9])
    if case == "unmeasured":
        log_l[1:] = -np.inf
    log_l[0, 0, 0] = -np.inf  # a non-finite entry is left out of a mean
    chain = rng.normal(size=shape + (D,))
    kws = dict(chain_shape=shape, dtype="float64", betas=betas,
               swap_acceptance=swap)
    j = JPTSamples(x=jnp.asarray(chain.reshape(-1, D)),
                   log_likelihood=jnp.asarray(log_l.reshape(-1)), **kws)
    t = PTMCMCSamples(x=torch.as_tensor(chain.reshape(-1, D)),
                      log_likelihood=torch.as_tensor(log_l.reshape(-1)),
                      **kws)
    jp, tp = _samplers()
    want = jp.refine_ladder_from_run(j, **kw)
    got = tp.refine_ladder_from_run(t, **kw)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("logzs,errs", [
    ([-3.0, -3.02, -2.99], [0.05, 0.04, 0.06]),  # consistent
    ([-3.0, -3.6, -2.5], [0.01, 0.02, 0.01]),  # scattered
    ([-1.0, -1.0], [0.1, 0.3]),
])
def test_combine_replicates_matches_jax(logzs, errs):
    got = combine_replicates(types.SimpleNamespace(), logzs, errs, "t")
    want = jcombine(types.SimpleNamespace(), logzs, errs, "t")
    for name in ("log_evidence", "log_evidence_error",
                 "log_evidence_error_single"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   **TOL)
    np.testing.assert_array_equal(got.log_evidence_replicates,
                                  want.log_evidence_replicates)


def _gaussian_target():
    def log_likelihood(s):
        return -0.5 * torch.sum((s.x - 1.0) ** 2 / 0.25, dim=-1)

    def log_prior(s):
        return -0.5 * torch.sum(s.x**2 / 4.0, dim=-1)

    return log_likelihood, log_prior


@pytest.fixture(scope="module")
def fitted():
    """A small nsf fitted to draws of the bounded 4-d Gaussian."""
    p = GaussianProblem(dims=4)
    x = np.random.default_rng(0).normal(1.8, 1.3, size=(1024, 4))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, prior_bounds=p.prior_bounds, flow_backend="nsf",
                 architecture="nsf", n_layers=2, n_hidden=(8, 8), seed=1,
                 device="cpu")
    asp.fit(Samples(x), n_epochs=2, batch_size=256)
    return asp


@pytest.mark.parametrize("sampler", ["smc", "ptmcmc"])
def test_replicate_tier_combines_the_runs(fitted, sampler):
    """``n_replicates=3`` continues the sampler's generator: its
    replicates are three plain runs of a sampler of the same seed in a
    row, combined by the JAX package's ``combine_replicates``."""
    kw = (dict(sampler_kwargs=dict(n_steps=3), store_sample_history=False)
          if sampler == "smc" else
          dict(n_steps=8, n_temperatures=3, ladder_probe_size=64))
    post = fitted.sample_posterior(sampler=sampler, n_samples=128,
                                   n_replicates=3, **kw)
    fresh = fitted.init_sampler(sampler)
    runs = [fresh.sample(128, **kw) for _ in range(3)]
    if sampler == "smc":
        logzs = [r.log_evidence for r in runs]
        errs = [r.log_evidence_error for r in runs]
    else:
        logzs, errs = zip(*(r.log_evidence_stepping_stone() for r in runs))
    np.testing.assert_allclose(post.log_evidence_replicates, logzs, **TOL)
    want = jcombine(types.SimpleNamespace(), list(logzs), list(errs), "t")
    np.testing.assert_allclose(post.log_evidence, want.log_evidence, **TOL)
    np.testing.assert_allclose(post.log_evidence_error,
                               want.log_evidence_error, **TOL)
    if sampler == "smc":
        assert len(fitted.sampler.replicate_histories) == 3
    with pytest.raises(ValueError, match="n_replicates"):
        fitted.sample_posterior(sampler=sampler, n_samples=128,
                                n_replicates=2,
                                checkpoint_file_path="run.h5", **kw)


@pytest.mark.parametrize("key", sorted(jsamplers.SAMPLER_REGISTRY))
def test_sample_signatures_match_jax(key):
    want = inspect.signature(jsamplers.SAMPLER_REGISTRY[key].sample)
    got = inspect.signature(SAMPLER_REGISTRY[key].sample)
    assert list(got.parameters) == list(want.parameters)
    for name, param in got.parameters.items():
        if name not in ("self", "n_samples"):
            assert param.default == want.parameters[name].default, name
    assert get_sampler_class(key) is SAMPLER_REGISTRY[key]


def test_unknown_kwargs_are_dropped_with_the_jax_warning(fitted, caplog):
    """``benchmarks/validate.py``'s own call: ``store_sample_history`` is
    no parameter of the pCN sampler's ``sample``."""
    with caplog.at_level(logging.WARNING, logger="aspire_tpu_torch"):
        samples = fitted.sample_posterior(sampler="minipcn", n_samples=64,
                                          n_steps=5,
                                          store_sample_history=False)
    assert samples.chain_shape == (5, 64)
    assert ("Ignoring kwargs not supported by minipcn.sample: "
            "['store_sample_history']") in caplog.text


def test_unported_checkpoint_arguments_raise(fitted, tmp_path):
    """The checkpoint arguments the port once refused are ported: SMC hands
    states to ``checkpoint_callback``, writes ``checkpoint_file_path`` and
    resumes from it; PT writes its chain and states and resumes from them;
    the facade writes ``checkpoint_path``. A replicated run still refuses
    them, and PT still needs ``n_steps >= swap_every``."""
    ll, lp = _gaussian_target()
    smc = PCNSMC(log_likelihood=ll, log_prior=lp, dims=4,
                 prior_flow=fitted.flow, device="cpu")
    states = []
    smc.sample(64, checkpoint_callback=states.append,
               sampler_kwargs=dict(n_steps=2))
    assert states[-1]["iteration"] == len(smc.history.beta)
    run = str(tmp_path / "run.h5")
    smc.sample(64, checkpoint_every=2, checkpoint_file_path=run,
               sampler_kwargs=dict(n_steps=2))
    smc.sample(64, resume_from=run, sampler_kwargs=dict(n_steps=2))
    assert smc.history.beta[-1] == 1.0
    with pytest.raises(ValueError, match="checkpoint_file_path"):
        smc.sample(64, checkpoint_every=2)
    with pytest.raises(ValueError, match="n_replicates"):
        smc.sample(64, n_replicates=2, checkpoint_callback=print)
    pt = ParallelTemperedSampler(log_likelihood=ll, log_prior=lp, dims=4,
                                 prior_flow=fitted.flow, device="cpu")
    pt_run = str(tmp_path / "pt.h5")
    out = pt.sample(64, n_steps=2, checkpoint_file_path=pt_run,
                    state_checkpoint_every=1)
    chain, it = pt.load_chain_checkpoint(pt_run)
    assert chain.shape == (*out.chain_shape, 4) and it == 2
    assert pt.load_pt_state(pt_run)["rounds_done"] == 2
    again = pt.sample(64, n_steps=2, resume_from=pt_run)
    np.testing.assert_array_equal(again.x.numpy(), out.x.numpy())
    with pytest.raises(ValueError, match="at least swap_every"):
        pt.sample(64, n_steps=2, swap_every=3)
    import h5py

    fitted.sample_posterior(sampler="smc", n_samples=64,
                            checkpoint_path=str(tmp_path / "facade.h5"),
                            sampler_kwargs=dict(n_steps=2))
    with h5py.File(tmp_path / "facade.h5", "r") as f:
        assert {"aspire_config", "flow", "sampler_config",
                "checkpoint"} <= set(f)
