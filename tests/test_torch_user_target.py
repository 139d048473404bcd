"""A user's own target on the chain kernel, against the JAX package.

The user's problem is ``chip_smoke.PolynomialRegression`` (Bayesian
polynomial regression at d = 4, 128 points, analytic evidence): its
``kernel_target`` gives a ``KernelSource`` and its constants, the port's
form of the JAX package's ``log_likelihood_td``/``log_prior_td`` protocol.
Its JAX twin here gives the ``_td`` methods. Held against the JAX package
on the CPU: the whole chain on the user target (the port's plain version,
which evaluates the user's torch callables, beside the JAX package's fused
chain in Pallas interpret mode with ``target_td``, on the same injected
noise); the dispatch (``_fused_chain_spec``) for the source form, the
bare-callable form and the cases that take the split route; and the slice
end to end at a small size (nsf-tpu cut to 2 layers of (16, 16) hidden
units): the whole-chain and split routes, the analytic evidence and the
JAX package's SMC on the same flow. About 35 s of one worker alone, 45 s
in the tier-1 run's six loaded workers (no case above 21 s).
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu import transforms as JT
from aspire_tpu.flows.architectures import nsf as jnsf
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch import Aspire
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.flows.architectures import nsf
from aspire_tpu_torch.models import KernelSource
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

torch.set_num_threads(1)

D, N, STEPS, TILE = 4, 512, 3, 256
SLICE_N, SLICE_STEPS = 2048, 8
SLICE_FLOW = dict(flow_backend="nsf", architecture="nsf-tpu",
                  n_hidden=(16, 16), n_layers=2)
#: ll is a 128-term float32 sum of positive squares in both packages, in
#: other orders: each sum is within 127 u of its exact value relative to
#: its magnitude (u = 2^-24), so the two within 2 * 128 u = 1.5e-5
#: relative, beside the 3e-3 absolute the other densities take.
LL_RTOL = 2 * 128 * 2.0**-24


class JaxRegression:
    """``PolynomialRegression``'s twin in the JAX package's protocol: its
    callables on ``samples.x`` (n, d) and the transposed-tile ``_td``
    methods on a (d, T) tile, float32."""

    def __init__(self, problem):
        self.dims = problem.dims
        self.t = jnp.asarray(problem.t, jnp.float32)
        self.y = jnp.asarray(problem.y, jnp.float32)
        self.const = chip_smoke.REGRESSION_POINTS * (
            0.5 * math.log(2 * math.pi) + math.log(chip_smoke.REGRESSION_SIGMA))

    def _ll_columns(self, xt):
        m = jnp.broadcast_to(xt[-1][None, :], (self.t.shape[0], xt.shape[1]))
        for k in range(self.dims - 2, -1, -1):
            m = m * self.t[:, None] + xt[k][None, :]
        r = (self.y[:, None] - m) / chip_smoke.REGRESSION_SIGMA
        return -0.5 * jnp.sum(r * r, axis=0) - self.const

    def _lp_columns(self, xt):
        return (-0.5 * jnp.sum(xt * xt, axis=0)
                - self.dims * 0.5 * math.log(2 * math.pi))

    def log_likelihood(self, samples):
        return self._ll_columns(jnp.asarray(samples.x).T)

    def log_prior(self, samples):
        return self._lp_columns(jnp.asarray(samples.x).T)

    def log_likelihood_td(self, xt):
        return self._ll_columns(xt)[None, :]

    def log_prior_td(self, xt):
        return self._lp_columns(xt)[None, :]


def test_chain_matches_jax_fused_chain():
    """The port's chain on the user target (plain version: the user's
    torch callables) and the JAX package's fused chain kernel in interpret
    mode with the twin's ``target_td``: a 2-layer (16, 16) 8-bin flow, the
    affine data transform fitted on the existing samples, two tiles, three
    tpCN steps (nu + d = 9: gamma_m 4, gamma_odd 1), the same injected
    noise. Accept counts identical; z, lq and lpi at the JAX package's
    parity bounds, ll at ``LL_RTOL`` beside them."""
    problem = chip_smoke.PolynomialRegression(D)
    jp = JaxRegression(problem)
    jarch = jnsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=8)
    jparams = jarch.init(jax.random.key(0))
    jparams = jax.tree.map(
        lambda p: (p + 0.1 * jax.random.normal(jax.random.key(7), p.shape,
                                               p.dtype)).astype(jnp.float32),
        jparams)
    tarch = nsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=8)
    tparams = flow_params_from_jax(jparams, dtype="float32")
    nu, k2 = 5.0, 5 + D
    rng = np.random.default_rng(3)
    x0 = problem.draw_initial_samples(rng, N).astype(np.float32)
    jt = JT.FlowTransform(parameters=problem.parameters, dtype="float32")
    jt.fit(jnp.asarray(x0))
    tt = transform_from_jax(jt, dtype="float32")
    jcfg = JFM.ChainConfig(jarch, "tpcn", STEPS, nu=nu,
                           target_acceptance=0.234, adaptation_rate=0.1,
                           gamma_m=k2 // 2, gamma_odd=k2 % 2,
                           dt_prog=JFM.canonicalize_transform(jt, D))
    noise = np.clip(rng.uniform(size=(STEPS, jcfg.noise_rows, N)),
                    1e-4, 1 - 1e-4).astype(np.float32)

    def target_td(xt):
        return jp.log_prior_td(xt), jp.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(x0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(x0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, "tpcn", STEPS, nu=nu, gamma_m=k2 // 2,
                          gamma_odd=k2 % 2)
    dt = FM.canonicalize_transform(tt, D)
    assert [op for op, _ in dt.ops] == ["affine"]
    refs = [torch.as_tensor(np.array(a, dtype=np.float32)) for a in gref]
    target = chip_smoke.user_target_of(problem, "cpu")
    assert isinstance(target[0], FM.UserTarget)
    assert target[1].shape == (2 * chip_smoke.REGRESSION_POINTS + 1,)
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs, target, data_transform=dt,
        noise=torch.as_tensor(noise))
    (zj, lqj, lpij, llj, naccj, sj, statsj) = [np.asarray(a) for a in out_j]
    (zt, lqt, lpit, llt, nacct, st, statst) = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < N * STEPS
    np.testing.assert_allclose(zt, zj, atol=3e-4, rtol=0)
    for t, j in ((lqt, lqj), (lpit, lpij)):
        np.testing.assert_allclose(t, j, atol=3e-3, rtol=1e-6)
    np.testing.assert_allclose(llt, llj, atol=3e-3, rtol=LL_RTOL)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    tau_j, mix_j = JFM.combine_tile_stats(jnp.asarray(statsj), D, TILE)
    tau_t, mix_t = FM.combine_tile_stats(torch.as_tensor(statst), D, TILE)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-4)
    np.testing.assert_allclose(float(mix_t), float(mix_j), rtol=1e-4)


def _sampler(problem, ll, lp, flow=SLICE_FLOW):
    """The port's SMC sampler for callables ll and lp, its flow's data
    transform and its preconditioning fitted on the existing samples."""
    asp = Aspire(log_likelihood=ll, log_prior=lp, dims=D,
                 parameters=problem.parameters, seed=1, device="cpu", **flow)
    asp.init_flow()
    x = torch.as_tensor(problem.draw_initial_samples(
        np.random.default_rng(4), 1024), dtype=torch.float32)
    asp.flow.data_transform.fit(x)
    sampler = asp.init_sampler("smc")
    sampler.fit_preconditioning_transform(x)
    return sampler


@pytest.mark.parametrize("form", ["bound", "bare"])
def test_fused_chain_spec_takes_the_user_source(form):
    """A problem whose ``kernel_target`` gives a ``KernelSource`` takes the
    whole-chain spec with a ``UserTarget`` (its plain version the user's
    callables), whether the callables are bound to it or are bare
    functions that both carry the same ``kernel_target``."""
    problem = chip_smoke.PolynomialRegression(D)
    if form == "bound":
        ll, lp = problem.log_likelihood, problem.log_prior
    else:
        def ll(samples):
            return problem.log_likelihood(samples)

        def lp(samples):
            return problem.log_prior(samples)

        ll.kernel_target = lp.kernel_target = problem.kernel_target
    sampler = _sampler(problem, ll, lp)
    spec = sampler._fused_chain_spec({}, 1024, torch.float32)
    assert spec is not None
    user, consts = spec["target"]
    assert isinstance(user, FM.UserTarget)
    assert user.source == KernelSource("polynomial_regression",
                                       chip_smoke.REGRESSION_CUDA)
    assert torch.equal(consts, problem.kernel_target("cpu")[1])
    x = torch.as_tensor(problem.posterior_draws(np.random.default_rng(2), 64),
                        dtype=torch.float32)
    lpi, llk = user.plain(x)
    view = types.SimpleNamespace(x=x)
    torch.testing.assert_close(llk, problem.log_likelihood(view))
    torch.testing.assert_close(lpi, problem.log_prior(view))


@pytest.mark.parametrize("case", ["no_kernel_target", "fused_chain_off",
                                  "maf", "one_callable"])
def test_fused_chain_spec_splits_as_the_rule_says(case):
    """The split route, as the JAX package takes its XLA path, only where
    the dispatch predicate says no: a user target with no
    ``kernel_target`` (or one on a single callable only),
    ``fused_chain=False``, and a MAF flow."""
    problem = chip_smoke.PolynomialRegression(D)
    ll, lp, flow, kwargs = (problem.log_likelihood, problem.log_prior,
                            SLICE_FLOW, {})
    if case in ("no_kernel_target", "one_callable"):
        def ll(samples):
            return problem.log_likelihood(samples)

        def lp(samples):
            return problem.log_prior(samples)

        if case == "one_callable":
            ll.kernel_target = problem.kernel_target
    elif case == "fused_chain_off":
        kwargs = dict(fused_chain=False)
    else:
        flow = dict(flow_backend="maf-rqs")
    sampler = _sampler(problem, ll, lp, flow)
    assert sampler._fused_chain_spec(kwargs, 1024, torch.float32) is None


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX package's ``Aspire`` on the twin, nsf-tpu cut to 2 layers
    of (16, 16), fitted for 5 epochs on 4096 existing samples."""
    problem = chip_smoke.PolynomialRegression(D)
    jp = JaxRegression(problem)
    init = JSamples(problem.draw_initial_samples(np.random.default_rng(0),
                                                 4096))
    asp = JAspire(log_likelihood=jp.log_likelihood, log_prior=jp.log_prior,
                  dims=D, parameters=problem.parameters, seed=1,
                  **SLICE_FLOW)
    asp.fit(init, n_epochs=5, batch_size=256)
    return problem, asp


def _port(problem, jasp):
    """The port's ``Aspire`` on the JAX package's fitted flow."""
    jflow = jasp.flow
    flow = Flow(dims=D, architecture="nsf-tpu", n_layers=2, n_hidden=(16, 16),
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    return Aspire(log_likelihood=problem.log_likelihood,
                  log_prior=problem.log_prior, dims=D,
                  parameters=problem.parameters, flow=flow, seed=1,
                  device="cpu", **SLICE_FLOW)


def _smc(asp, **kwargs):
    return asp.sample_posterior(
        sampler="smc", n_samples=SLICE_N, store_sample_history=False,
        sampler_kwargs=dict(n_steps=SLICE_STEPS, **kwargs))


def test_slice_routes_agree_with_each_other_and_the_truth(jax_fit):
    """SMC on the regression: every mutation on the whole-chain route (the
    user's callables in the plain chain), finite samples of the expected
    shape; the split route's log Z within max(5 combined sigma, 0.15) of
    it; both within max(5 sigma, 0.02) of the analytic evidence."""
    problem, jasp = jax_fit
    asp = _port(problem, jasp)
    truth = problem.true_log_evidence()
    posts = {}
    for route, kwargs in (("fused_kernel", {}),
                          ("split", dict(fused_chain=False))):
        posts[route] = _smc(asp, **kwargs)
        assert set(asp.sampler.history.mutation_route) == {route}
        post = posts[route]
        assert post.x.shape == (SLICE_N, D)
        assert bool(torch.isfinite(post.x).all())
        err = post.log_evidence_error
        assert np.isfinite(post.log_evidence) and np.isfinite(err)
        assert abs(post.log_evidence - truth) < max(5 * err, 0.02)
    f, s = posts["fused_kernel"], posts["split"]
    assert abs(f.log_evidence - s.log_evidence) < max(
        5 * np.hypot(f.log_evidence_error, s.log_evidence_error), 0.15)


def test_slice_log_evidence_matches_jax(jax_fit):
    """The port's whole-chain SMC and the JAX package's SMC on the same
    fitted flow and seed: log Z within max(5 combined sigma, 0.15), the
    JAX package's within max(5 sigma, 0.02) of the analytic evidence."""
    problem, jasp = jax_fit
    post = _smc(_port(problem, jasp))
    jpost = _smc(jasp)
    jlz, jerr = float(jpost.log_evidence), float(jpost.log_evidence_error)
    assert abs(jlz - problem.true_log_evidence()) < max(5 * jerr, 0.02)
    assert abs(post.log_evidence - jlz) < max(
        5 * np.hypot(post.log_evidence_error, jerr), 0.15)
