"""The SMC options ``windowed_tau``, ``tau_walkers``, ``waste_free`` and
``flow_moves`` of ``aspire_tpu_torch`` against the JAX package, on the CPU.

The pieces run in both packages on the same seeded inputs: the windowed
Sokal tau (float32 and float64; the JAX package rounds the spectrum's
product to ``complex64``, the port keeps the chain's precision, so float64
agrees to 1e-6 relative), the ``tau_walkers`` subset and the waste-free
pooling through a deterministic step fed to both chain runners, the flow's
independence move on the JAX package's own proposal and uniforms (float64),
the waste-free lineage update, and the final mutation's tau choice. Then
the port end to end: both ladders one run for each option, and the JAX
package's statistical and validation assertions
(``tests/test_integration.py``, ``tests/test_kernels.py``) at n <= 512.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu.samplers import kernels as JK
from aspire_tpu.samplers import smc as JSMC
from aspire_tpu.samplers.smc import _value_and_grad_batch
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.samplers import kernels as K
from aspire_tpu_torch.samplers import smc as TSMC

torch.set_num_threads(1)

#: the float64 windowed tau's tolerance (the JAX package's complex64 cast)
TAU_RTOL = 1e-6
TOL = dict(rtol=1e-10, atol=1e-10)
N, D = 512, 2
SMALL = dict(flow_backend="nsf", architecture="nsf-tpu", n_hidden=(16, 16),
             n_layers=2)


@pytest.fixture(scope="module")
def fitted():
    p = GaussianMixtureProblem(dims=D)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=D, seed=1, device="cpu", **SMALL)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    return p, asp


def _run(asp, sampler, chain, n=N, **kw):
    kw.setdefault("store_sample_history", False)
    return asp.sample_posterior(sampler=sampler, n_samples=n,
                                return_history=True, sampler_kwargs=chain,
                                **kw)


def _host_target(p):
    """``p``'s likelihood through numpy: a target no CUDA graph captures."""
    def log_likelihood(x):
        return p.log_likelihood(x).numpy()
    return log_likelihood


# -- the windowed tau ----------------------------------------------------------


def _ar_chain(a1, a2, n_steps=400, n_walkers=64, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_steps + 2, n_walkers, d))
    eps = rng.normal(size=x.shape)
    for t in range(2, n_steps + 2):
        x[t] = a1 * x[t - 1] + a2 * x[t - 2] + eps[t]
    return x[2:], x[1]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("chain", ["ar1", "ar2", "frozen"])
def test_sokal_tau_matches_jax(chain, dtype):
    """AR(1) (rho 0.6: tau about 4), AR(2) (lag-2 correlation the AR(1)
    surrogate misses) and a frozen chain (the 2e4 saturation)."""
    if chain == "frozen":
        x0 = np.ones((8, 2))
        c = np.broadcast_to(x0, (20, 8, 2)).copy()
    else:
        c, x0 = _ar_chain(*((0.6, 0.0) if chain == "ar1" else (0.0, 0.9)))
    c, x0 = c.astype(dtype), x0.astype(dtype)
    want = float(JK.sokal_tau_from_chain(jnp.asarray(c), jnp.asarray(x0)))
    got = K.sokal_tau_from_chain(torch.as_tensor(c), torch.as_tensor(x0))
    assert got.dtype == getattr(torch, dtype)
    assert float(got) == pytest.approx(want, rel=TAU_RTOL)
    if chain == "frozen":
        assert float(got) == K._FROZEN_TAU == JK._FROZEN_TAU
    elif chain == "ar1":
        assert float(got) == pytest.approx(4.0, rel=0.35)


def _jax_state(x):
    return JK.ChainState(x=jnp.asarray(x), log_prob=jnp.zeros(len(x)),
                         key=jax.random.key(0), step_size=jnp.asarray(0.5),
                         n_accept=jnp.zeros(len(x)),
                         n_evals=JK.eval_counter_init())


def _torch_state(x):
    x = torch.as_tensor(x)
    return K.ChainState(x=x, log_prob=torch.zeros(len(x), dtype=x.dtype),
                        step_size=torch.tensor(0.5, dtype=x.dtype),
                        n_accept=torch.zeros(len(x), dtype=x.dtype))


def _steps():
    """One deterministic step in both packages, exact to the last bit in
    each (a halving, then one rounded sum): each walker contracts towards
    a point of its own."""
    def jstep(s):
        target = jnp.arange(s.x.shape[0])[:, None] * jnp.asarray([0.1, -0.2])
        return s._replace(x=0.5 * s.x + target)

    def tstep(s):
        target = (torch.arange(s.x.shape[0], dtype=s.x.dtype)[:, None]
                  * torch.tensor([0.1, -0.2], dtype=s.x.dtype))
        return K.ChainState(x=0.5 * s.x + target,
                            log_prob=s.log_prob, step_size=s.step_size,
                            n_accept=s.n_accept)
    return jstep, tstep


@pytest.mark.parametrize("n,w", [(48, 32), (64, 32), (40, 64), (48, 7)])
def test_tau_walkers_subset_matches_jax(n, w):
    """Without a stored chain the windowed tau comes from the strided
    subset ``(arange(w) * n) // w``, ``w = min(tau_walkers, n)`` (w <= n <
    2w included: no contiguous prefix), in both packages; the subset's tau
    is the stored chain's subset's."""
    idx = K.tau_walker_indices(n, w)
    m = max(1, min(w, n))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray((jnp.arange(m) * n) // m))
    assert len(set(idx.tolist())) == m and int(idx[-1]) >= n - n // m - 1
    x = np.random.default_rng(3).normal(size=(n, 2))
    jstep, tstep = _steps()
    _, _, jstats = JK.run_chain(jstep, _jax_state(x), 12, track_autocorr=True,
                                windowed_tau=True, tau_walkers=w)
    _, tstats = K.run_chain(tstep, _torch_state(x), 12,
                                 windowed_tau=True, tau_walkers=w)
    assert float(tstats.tau) == pytest.approx(float(jstats.tau),
                                              rel=TAU_RTOL)
    _, _, chain = K.run_chain(tstep, _torch_state(x), 12,
                                    store_chain=True)
    assert float(tstats.tau) == float(K.sokal_tau_from_chain(
        chain[:, idx], torch.as_tensor(x)[idx]))
    with pytest.raises(ValueError, match="store_chain"):
        K.run_chain(tstep, _torch_state(x), 4, windowed_tau=True)


def test_waste_free_pooling_matches_jax():
    """The stored chain pooled ancestor-major, ``(k, M, d) -> (M, k, d) ->
    (M k, d)``, and its windowed tau: the JAX package's ``run_chain`` and
    pooling against the port's on the same deterministic step."""
    x = np.random.default_rng(4).normal(size=(24, 2))
    jstep, tstep = _steps()
    _, jchain, jstats = JK.run_chain(jstep, _jax_state(x), 5,
                                     store_chain=True, track_autocorr=True,
                                     windowed_tau=True)
    _, tstats, tchain = K.run_chain(tstep, _torch_state(x), 5,
                                    store_chain=True, windowed_tau=True)
    want = np.asarray(jnp.swapaxes(jchain, 0, 1).reshape(-1, 2))
    got = K.pool_chain(tchain)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (24 * 5, 2)
    np.testing.assert_array_equal(got[5:10].numpy(), tchain[:, 1].numpy())
    assert float(tstats.tau) == pytest.approx(float(jstats.tau),
                                              rel=TAU_RTOL)
    assert float(tstats.mixing) == pytest.approx(float(jstats.mixing),
                                                 rel=1e-12)


# -- the flow's independence move -----------------------------------------------

MU, SIG, BETA = np.array([0.3, -0.2]), 1.3, 0.6


def _jflow_log_prob(_, x):
    z = (x - jnp.asarray(MU)) / SIG
    return jnp.sum(jax.scipy.stats.norm.logpdf(z), -1) - D * math.log(SIG)


def _jflow_draw(_, key, n):
    z = jax.random.normal(key, (n, D), jnp.float64)
    return (jnp.asarray(MU) + SIG * z,
            jnp.sum(jax.scipy.stats.norm.logpdf(z), -1) - D * math.log(SIG))


def _tflow_log_prob(x):
    z = (x - torch.as_tensor(MU)) / SIG
    return (torch.sum(-0.5 * z**2, -1) - D * 0.5 * math.log(2 * math.pi)
            - D * math.log(SIG))


def _jtarget(x):
    return (-jnp.sum((x - 1.0) ** 2, -1) / 0.5, -jnp.sum(x**2, -1) / 18.0)


def _ttarget(x):
    return -torch.sum((x - 1.0) ** 2, -1) / 0.5 - torch.sum(x**2, -1) / 18.0


@pytest.mark.parametrize("needs_grad", [False, True])
def test_flow_imh_move_matches_jax(needs_grad):
    """The move on the JAX package's own proposal (the flow draw of its
    key) and acceptance uniforms, through ``_make_flow_imh_step`` with
    ``flow_move_every=1`` (every step the move): the accept mask, the
    positions, the densities (refreshed with their gradients for a
    gradient kernel) and the evaluations, in float64."""
    n = 64
    stub = types.SimpleNamespace(
        flow_draw_fn=lambda: _jflow_draw,
        flow_log_prob_params=lambda: (_jflow_log_prob, None),
        log_likelihood=lambda x: _jtarget(x)[0],
        log_prior=lambda x: _jtarget(x)[1], _make_view=lambda x: x)

    def jlp(x):
        return ((1 - BETA) * _jflow_log_prob(None, x)
                + BETA * sum(_jtarget(x)))

    def tlp(x):
        return (1 - BETA) * _tflow_log_prob(x) + BETA * _ttarget(x)

    x = np.random.default_rng(5).normal(size=(n, D)) * 1.5
    jx = jnp.asarray(x)
    jlp0, jg0 = _value_and_grad_batch(jlp, jx)
    jstate = JK.ChainState(x=jx, log_prob=jlp0, key=jax.random.key(9),
                           step_size=jnp.asarray(0.3), n_accept=jnp.zeros(n),
                           grad=jg0 if needs_grad else None,
                           n_evals=JK.eval_counter_init())
    step = JSMC.SMCSampler._make_flow_imh_step(
        stub, lambda s: s, jlp, None, BETA, 1, needs_grad)
    jnew = step(jstate)
    key, _ = jax.random.split(jstate.key)
    _, k_prop, k_acc = jax.random.split(key, 3)
    x_prop, lq_prop = _jflow_draw(None, k_prop, n)
    u = jax.random.uniform(k_acc, (n,), jnp.float64)
    tx = torch.as_tensor(x)
    tlp0, tg0 = TSMC.value_and_grad_batch(tlp, tx)
    tstate = K.ChainState(x=tx, log_prob=tlp0,
                          step_size=torch.tensor(0.3, dtype=torch.float64),
                          n_accept=torch.zeros(n, dtype=torch.float64),
                          grad=tg0 if needs_grad else None)
    tnew = K.flow_imh_move(
        tstate, torch.as_tensor(np.asarray(x_prop)),
        torch.as_tensor(np.asarray(lq_prop)),
        torch.as_tensor(np.asarray(u)), BETA, _ttarget, _tflow_log_prob,
        (lambda z: TSMC.value_and_grad_batch(tlp, z)) if needs_grad
        else None)
    np.testing.assert_array_equal(tnew.n_accept.numpy(),
                                  np.asarray(jnew.n_accept))
    assert 0 < float(tnew.n_accept.sum()) < n
    for name in ("x", "log_prob", "step_size") + (
            ("grad",) if needs_grad else ()):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   err_msg=name, **TOL)
    assert int(tnew.n_evals) == JK.eval_counter_total(jnew.n_evals) == (
        2 * n if needs_grad else n)


@pytest.mark.parametrize("coin,moved", [(0.2, True), (0.5, False)])
def test_flow_moves_keep_one_branch(monkeypatch, coin, moved):
    """Both branches run; one device coin (``u < 1 / flow_moves``) keeps
    the move's state or the local step's, evaluations included."""
    base = _torch_state(np.zeros((4, 2)))

    def branch(shift, evals):
        def step(s):
            return K.ChainState(x=s.x + shift, log_prob=s.log_prob + shift,
                                step_size=s.step_size * shift,
                                n_accept=s.n_accept + shift,
                                n_evals=s.n_evals + evals)
        return step

    monkeypatch.setattr(K, "_uniform", lambda gen, shape, like: torch.tensor(
        coin, dtype=like.dtype))
    step = K.mix_flow_moves(branch(1.0, 4), branch(2.0, 8), None, 3)
    new = step(base)
    want = 2.0 if moved else 1.0
    assert torch.equal(new.x, torch.full((4, 2), want, dtype=torch.float64))
    assert float(new.step_size) == 0.5 * want and new.grad is None
    assert int(new.n_evals) == (8 if moved else 4)


# -- lineage and the final mutation --------------------------------------------


@pytest.mark.parametrize("waste_free", [False, True])
@pytest.mark.parametrize("tau,mixing", [(0.5, 0.9), (3.7, 0.6),
                                        (40.0, 1.0)])
def test_lineage_update_matches_jax(waste_free, tau, mixing):
    """After a mutation: the recovered fraction, then (waste-free) the
    division by ``max(min(tau, k), 1)``, as in the JAX package."""
    def stub(module):
        s = types.SimpleNamespace(
            _last_chain_stats=(tau, mixing), sampler_kwargs={"n_steps": 8},
            dims=2, _lineage_fraction=0.3, _last_waste_free=waste_free,
            history=types.SimpleNamespace(mcmc_autocorr=[tau]))
        module.SMCSampler._update_lineage_after_mutation(s)
        return s._lineage_fraction

    assert stub(TSMC) == stub(JSMC)


def _final_calls(module, sampler, kwargs):
    """The ``(waste_free, windowed_tau)`` of every mutation of a one-rung
    run with ``n_final_samples``, its ``mutate`` replaced by a recorder."""
    calls = []

    def record(samples, beta, n_steps=None, waste_free=None,
               windowed_tau=None):
        calls.append((waste_free, windowed_tau))
        return samples

    sampler.mutate = record
    sampler.sample(64, n_steps=1, adaptive=False, n_final_samples=32,
                   sampler_kwargs=kwargs)
    return calls


@pytest.fixture(scope="module")
def jax_mixture():
    p = JMixture(dims=2)
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=2, seed=1, flow_backend="nsf", n_hidden=(8, 8),
                  n_layers=2)
    asp.fit(JSamples(p.draw_initial_samples(np.random.default_rng(0), 256)),
            n_epochs=1, batch_size=128)
    return p, asp


@pytest.mark.parametrize("capturable", [True, False])
@pytest.mark.parametrize("user", [None, True, False])
def test_final_mutation_tau_matches_jax(jax_mixture, fitted, capturable,
                                        user):
    """C16: the final mutation's windowed tau defaults to whether the
    target can be captured (the JAX package: jit-traced), and an explicit
    ``windowed_tau`` wins either way; never waste-free."""
    jp, jasp = jax_mixture
    p, asp = fitted
    kwargs = {"n_steps": 2} | ({} if user is None else {"windowed_tau": user})
    jsampler = jasp.init_sampler("smc")
    tsampler = asp.init_sampler("smc")
    if not capturable:
        jsampler.log_likelihood = lambda x: np.asarray(jp.log_likelihood(x))
        tsampler.log_likelihood = _host_target(p)
    want = _final_calls(JSMC, jsampler, kwargs)
    got = _final_calls(TSMC, tsampler, kwargs)
    assert got == want
    assert got[-1] == (False, capturable if user is None else user)


@pytest.mark.parametrize("user", [None, True, False])
def test_final_mutation_records_its_tau(monkeypatch, fitted, user):
    """C16 end to end: after ``n_final_samples`` the last mutation takes
    the split route with the windowed tau (its value recorded last) unless
    ``windowed_tau=False`` is explicit, which keeps the whole-chain kernel
    (its plain version here) and its AR(1) tau."""
    _, asp = fitted
    taus = []
    sokal = K.sokal_tau_from_chain

    def spy(*args, **kw):
        taus.append(float(sokal(*args, **kw)))
        return sokal(*args, **kw)

    monkeypatch.setattr(K, "sokal_tau_from_chain", spy)
    chain = {"n_steps": 4} | ({} if user is None else {"windowed_tau": user})
    _, hist = _run(asp, "smc", chain, n=256, n_final_samples=512)
    rungs = len(hist.beta)
    assert hist.mutation_route[:rungs] == (
        ["split"] * rungs if user else ["fused_kernel"] * rungs)
    windowed = user is not False
    assert hist.mutation_route[-1] == ("split" if windowed
                                       else "fused_kernel")
    assert len(hist.mcmc_autocorr) == rungs + 1
    assert len(taus) == (rungs + 1 if user else int(windowed))
    if windowed:
        assert hist.mcmc_autocorr[-1] == taus[-1]


# -- both ladders ---------------------------------------------------------------

LADDER_CASES = {
    "windowed_tau": ("smc", {"n_steps": 8, "windowed_tau": True}),
    "tau_walkers": ("smc", {"n_steps": 8, "windowed_tau": True,
                            "tau_walkers": 64}),
    "waste_free": ("smc", {"n_steps": 8, "waste_free": True}),
    "flow_moves": ("smc", {"n_steps": 6, "flow_moves": 3}),
    "flow_moves_mala": ("mala_smc", {"n_steps": 4, "flow_moves": 3}),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_device_ladder_repeats_the_host_ladder(fitted, case):
    """One seed, both ladders, each option: the same rungs, history
    (windowed taus, the waste-free lineage), particles and evaluations,
    bit for bit; every mutation on the split route."""
    _, asp = fitted
    sampler, chain = LADDER_CASES[case]
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
    assert dh.mutation_route == ["split"] * len(dh.beta)
    assert torch.equal(dev.x, host.x)
    assert ds.n_likelihood_evaluations == hs.n_likelihood_evaluations
    assert ds.particle_steps == hs.particle_steps


# -- the JAX package's assertions, mirrored ----------------------------------------


def test_waste_free_matches_standard_at_fraction_of_evals(fitted):
    p, asp = fitted
    std, _ = _run(asp, "smc", {"n_steps": 16})
    std_evals = asp.sampler.n_likelihood_evaluations
    wf, hist = _run(asp, "smc", {"n_steps": 16, "waste_free": True})
    wf_evals = asp.sampler.n_likelihood_evaluations
    assert len(wf) == len(std) == N
    assert abs(wf.log_evidence - p.true_log_evidence()) < 0.5
    assert wf_evals < 0.4 * std_evals
    assert all(1.0 <= t <= 2e4 for t in hist.mcmc_autocorr)


def test_waste_free_population_is_pool_of_chain_states(fitted):
    _, asp = fitted
    wf, hist = _run(asp, "smc", {"n_steps": 10, "waste_free": True}, n=300)
    assert len(wf) == 300 and hist.beta[-1] == 1.0


def test_waste_free_ladder_saves_evals(fitted):
    p, asp = fitted
    _run(asp, "smc", {"n_steps": 8, "waste_free": True}, n=320,
         device_ladder=False)
    n_it_host = len(asp.sampler.history.beta)
    post, _ = _run(asp, "smc", {"n_steps": 8, "waste_free": True}, n=320,
                   device_ladder=True)
    assert asp.sampler.ladder is not None and len(post) == 320
    assert abs(post.log_evidence - p.true_log_evidence()) < 0.5
    assert asp.sampler.n_likelihood_evaluations < 0.6 * 320 * 8 * (
        n_it_host + 4)


def test_waste_free_divisibility_is_validated(fitted):
    _, asp = fitted
    with pytest.raises(ValueError, match="divisible"):
        _run(asp, "smc", {"n_steps": 8, "waste_free": True}, n=250)


@pytest.mark.parametrize("chain", [{"n_steps": 5, "waste_free": True},
                                   {"n_steps": 4, "flow_moves": 2}])
def test_options_reject_an_uncapturable_target(fitted, chain):
    p, asp = fitted
    sampler = TSMC.PCNSMC(log_likelihood=_host_target(p),
                          log_prior=p.log_prior, dims=D,
                          prior_flow=asp.flow, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph can capture"):
        sampler.sample(100, sampler_kwargs=chain,
                       store_sample_history=False)


def test_windowed_tau_falls_back_on_an_uncapturable_target(fitted, caplog):
    """The JAX package's warning, and the AR(1) surrogate recorded."""
    p, asp = fitted
    sampler = TSMC.PCNSMC(log_likelihood=_host_target(p),
                          log_prior=p.log_prior, dims=D,
                          prior_flow=asp.flow, device="cpu")
    sampler.sample(256, sampler_kwargs={"n_steps": 4, "windowed_tau": True},
                   store_sample_history=False)
    assert "recording the AR(1) surrogate" in caplog.text
    assert sampler.ladder is None
    assert all(t >= 1.0 for t in sampler.history.mcmc_autocorr)


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("tau_walkers", [None, 64])
def test_windowed_tau_recorded(fitted, ladder, tau_walkers):
    p, asp = fitted
    chain = {"n_steps": 8, "windowed_tau": True}
    if tau_walkers:
        chain["tau_walkers"] = tau_walkers
    post, hist = _run(asp, "smc", chain, device_ladder=ladder)
    assert len(hist.mcmc_autocorr) >= 1
    assert all(1.0 <= t <= 2e4 for t in hist.mcmc_autocorr)
    assert abs(post.log_evidence - p.true_log_evidence()) < 0.5


def test_flow_moves_preserve_accuracy(fitted):
    p, asp = fitted
    post, hist = _run(asp, "smc", {"n_steps": 8, "flow_moves": 3})
    assert abs(post.log_evidence - p.true_log_evidence()) < 0.5
    assert hist.mutation_route == ["split"] * len(hist.beta)


@pytest.mark.parametrize("ladder", [False, True])
def test_flow_moves_with_a_gradient_kernel(fitted, ladder):
    p, asp = fitted
    post, _ = _run(asp, "mala_smc", {"n_steps": 6, "flow_moves": 3}, n=256,
                   device_ladder=ladder)
    assert (asp.sampler.ladder is not None) == ladder
    assert abs(post.log_evidence - p.true_log_evidence()) < 0.6


def test_flow_moves_reject_preconditioning(fitted):
    _, asp = fitted
    with pytest.raises(ValueError, match="preconditioning"):
        _run(asp, "smc", {"n_steps": 4, "flow_moves": 2}, n=128,
             preconditioning="flow", device_ladder=False,
             preconditioning_kwargs={"fit_kwargs": {"n_epochs": 1}})


@pytest.mark.parametrize("ladder", [False, True])
def test_a_resumed_waste_free_run_pools(fitted, ladder):
    """The options ride in a checkpoint's ``sampler_kwargs``: a run stopped
    after one rung and resumed by a fresh sampler given no options pools
    as the uninterrupted run does (M = n / k chains of k steps a rung, M k
    + M + n evaluations), and keeps the stopped run's rungs as its
    history's prefix."""
    _, asp = fitted
    n, k = 320, 8
    chain = {"n_steps": k, "waste_free": True, "tau_walkers": 64}
    states = []
    first = asp.init_sampler("smc")
    first.sample(n, max_n_steps=1, min_beta_step=0.0, sampler_kwargs=chain,
                 store_sample_history=False, device_ladder=ladder,
                 checkpoint_callback=states.append)
    assert states[-1]["sampler_kwargs"]["waste_free"] is True
    assert states[-1]["sampler_kwargs"]["tau_walkers"] == 64
    resumed = asp.init_sampler("smc")
    post = resumed.sample(n, resume_from=states[-1],
                          store_sample_history=False, device_ladder=ladder)
    rungs = len(resumed.history.beta) - 1
    assert rungs >= 1 and resumed.history.beta[:1] == first.history.beta
    assert resumed.sampler_kwargs["waste_free"] is True
    assert len(post) == n and resumed.history.beta[-1] == 1.0
    m = n // k
    assert resumed.n_likelihood_evaluations - states[-1][
        "n_likelihood_evaluations"] == rungs * (m * k + m + n)
    assert resumed.particle_steps == rungs * m * k
