"""The port's parallel-tempered sampler against the JAX package's.

A run from the same initial states on a fixed ladder in both packages,
float64: the port draws through ``kernels._randint`` and ``_uniform``; the
test replaces them with the JAX run's own draws, made here from the
sampler's key as ``ParallelTemperedSampler.sample`` splits it (round keys;
per round the move, even and odd keys; per rung the moves; per move six
keys, three a half), in the port's order, so both runs see the same
numbers. Then the port alone: its stepping-stone log Z on a Gaussian
against the analytic value, the slice through ``Aspire`` with the
adaptive ladder and its pilots, a flow-preconditioned run, and
``chip_smoke.py``'s card-against-CPU check run on the CPU twice.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu.samplers.mcmc import ParallelTemperedSampler as JPT
from aspire_tpu_torch import Aspire, PTMCMCSamples, Samples
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.samplers import ParallelTemperedSampler
from aspire_tpu_torch.samplers import kernels as K

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
D = 3


def _target(xp, where):
    """A Gaussian likelihood that is NaN where x_0 > 2.5 and -inf where
    x_1 < -3 (a hard constraint), and a wide normal prior, in the array
    namespace ``xp``."""
    def log_likelihood(s):
        x = s.x
        ll = -0.5 * xp.sum((x - 1.0) ** 2, -1)
        ll = where(x[:, 1] < -3.0, -math.inf, ll)
        return where(x[:, 0] > 2.5, math.nan, ll)

    def log_prior(s):
        return -0.5 * xp.sum(s.x**2 / 4.0, -1)

    return log_likelihood, log_prior


def _torch_where(c, a, b):
    return torch.where(c, torch.as_tensor(a, dtype=b.dtype), b)


class _TorchSum:
    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)


def _jax_draws(key, n_temps, n, swap_every, n_rounds):
    """The JAX run's draws in the port's order (``sample``'s key splits:
    ``mcmc.py:1295``, ``:1217-1218``, ``:1147``, ``:1084-1118``,
    ``:1169-1171``)."""
    _, sub = jax.random.split(key)
    half = n // 2
    blocks = ((half, n - half), (n - half, half))
    draws = []
    for key_round in jax.random.split(sub, n_rounds):
        step_key, even_key, odd_key = jax.random.split(key_round, 3)
        move_keys = jax.vmap(lambda k: jax.random.split(k, swap_every))(
            jax.random.split(step_key, n_temps))  # (T, swap_every)
        for m in range(swap_every):
            keys = jax.vmap(lambda k: jax.random.split(k, 6))(
                move_keys[:, m])  # (T, 6)
            for b, (n_move, n_other) in enumerate(blocks):
                draws += [
                    jax.vmap(lambda k: jax.random.randint(
                        k, (n_move,), 0, n_other))(keys[:, 3 * b]),
                    jax.vmap(lambda k: jax.random.uniform(
                        k, (n_move,), dtype=jnp.float64))(keys[:, 3 * b + 1]),
                    jax.vmap(lambda k: jax.random.uniform(
                        k, (n_move,)))(keys[:, 3 * b + 2])]
        for parity, k in ((0, even_key), (1, odd_key)):
            n_pairs = len(range(parity, n_temps - 1, 2))
            if n_pairs:
                draws.append(jax.random.uniform(k, (n_pairs, n)))
    return draws


def _inject(monkeypatch, draws):
    """The port's draw functions return ``draws`` in order, each checked
    against the shape asked for."""
    queue = list(draws)

    def take(shape, like, dtype=None):
        v = torch.as_tensor(np.array(queue.pop(0)))
        assert tuple(v.shape) == tuple(shape), (v.shape, shape)
        return v.to(dtype or like.dtype)

    monkeypatch.setattr(K, "_uniform",
                        lambda gen, shape, like: take(shape, like))
    monkeypatch.setattr(K, "_randint", lambda gen, lo, hi, shape, like: take(
        shape, like, torch.int64))
    return queue


@pytest.mark.parametrize("n_temps,swap_every,n", [
    (2, 3, 16), (5, 1, 17), (5, 3, 16), (2, 1, 17)])
def test_run_matches_jax_under_replayed_draws(monkeypatch, n_temps,
                                              swap_every, n):
    """Chain, logL, logPi, both acceptances and the evaluation count; T =
    2 (one swap pass a round) and 5, swap_every 1 and 3, an even and an
    odd n (its halves uneven)."""
    n_rounds = 2
    n_steps = n_rounds * swap_every
    betas = np.array([1.0, 0.3, 0.1, 0.02, 0.0])[-n_temps:]
    betas[0] = 1.0
    x0 = np.random.default_rng(n).normal(0.0, 2.0, size=(n_temps * n, D))
    jll, jlp = _target(jnp, jnp.where)
    js = JPT(jll, jlp, D, prior_flow=None, dtype="float64", rng=n)
    draws = _jax_draws(js.key, n_temps, n, swap_every, n_rounds)
    want = js.sample(n, n_steps=n_steps, betas=betas, swap_every=swap_every,
                     _init_x=x0)
    queue = _inject(monkeypatch, draws)
    tll, tlp = _target(_TorchSum, _torch_where)
    ts = ParallelTemperedSampler(tll, tlp, D, prior_flow=None,
                                 dtype="float64", device="cpu")
    got = ts.sample(n, n_steps=n_steps, betas=betas, swap_every=swap_every,
                    _init_x=x0)
    assert not queue
    assert isinstance(got, PTMCMCSamples)
    assert got.chain_shape == want.chain_shape == (n_temps, n_rounds, n)
    np.testing.assert_array_equal(got.betas, want.betas)
    np.testing.assert_allclose(got.chain.numpy(), np.asarray(want.chain),
                               **TOL)
    for name in ("log_likelihood", "log_prior"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    for name in ("move_acceptance", "swap_acceptance"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   err_msg=name, **TOL)
    assert ts.n_likelihood_evaluations == js.n_likelihood_evaluations == (
        n_temps * n * (1 + n_steps))
    # The run moved, swapped and met both the NaN and the -inf region.
    ll = np.asarray(want.log_likelihood)
    assert 0 < got.move_acceptance.min() and got.swap_acceptance.max() > 0
    assert np.isnan(ll).any() or np.isneginf(ll).any()


def _gaussian(d=2):
    """N(1, 0.5^2) likelihood under a N(0, 2^2) prior (both normalised),
    and its log Z."""
    def log_likelihood(s):
        return (-0.5 * torch.sum((s.x - 1.0) ** 2 / 0.25, dim=-1)
                - 0.5 * d * math.log(2 * math.pi * 0.25))

    def log_prior(s):
        return (-0.5 * torch.sum(s.x**2 / 4.0, dim=-1)
                - 0.5 * d * math.log(2 * math.pi * 4.0))

    truth = d * (-0.5 * math.log(2 * math.pi * 4.25) - 0.5 / 4.25)
    return log_likelihood, log_prior, truth


def test_geometric_ladder_evidence_on_a_gaussian():
    """The geometric ladder (8 rungs), 256 walkers from the prior, 400
    steps: the stepping-stone log Z within max(5 sigma, 0.02) of the
    analytic value; TI's total bar covers it too."""
    ll, lp, truth = _gaussian()
    sampler = ParallelTemperedSampler(ll, lp, 2, prior_flow=None,
                                      device="cpu", rng=3)
    x0 = np.random.default_rng(0).normal(0.0, 2.0, size=(8 * 256, 2))
    post = sampler.sample(256, n_steps=400, n_temperatures=8, _init_x=x0)
    np.testing.assert_allclose(
        post.betas, np.concatenate([0.5 ** np.arange(7), [0.0]]))
    lz, err = post.log_evidence_stepping_stone()
    assert abs(lz - truth) < max(5 * err, 0.02), (lz, err, truth)
    ti, ti_err = post.log_evidence_thermodynamic_integration(method="total")
    assert abs(ti - truth) < max(5 * ti_err, 0.02), (ti, ti_err, truth)
    assert np.all((0.3 < post.move_acceptance) & (post.move_acceptance < 1))
    assert np.all(post.swap_acceptance > 0.3)


@pytest.fixture(scope="module")
def bounded():
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


def test_adaptive_ladder_with_pilots_through_aspire(bounded):
    """``sampler="ptmcmc"`` as ``benchmarks/validate.py`` calls it, at a
    small size: the adaptive ladder on a 1024-draw probe, two pilots of 20
    steps warm-starting the run, ``store_sample_history`` dropped with a
    warning; the stepping-stone log Z against -4 ln 20 within max(5
    sigma, 0.05)."""
    p, asp = bounded
    walkers, n_steps, swap_every = 128, 200, 5
    post = asp.sample_posterior(
        sampler="ptmcmc", n_samples=walkers, n_steps=n_steps,
        n_temperatures=6, betas="adaptive", swap_every=swap_every,
        ladder_probe_size=1024, ladder_pilot_steps=20,
        ladder_pilot_iterations=2, store_sample_history=False)
    sampler = asp.sampler
    assert isinstance(sampler, ParallelTemperedSampler)
    n_temps = len(post.betas)
    assert post.chain_shape == (n_temps, n_steps // swap_every, walkers)
    assert n_temps >= 6 and post.betas[-1] == 0.0
    # The probe's draws, each pilot's (its states warm) and the run's.
    assert sampler.n_likelihood_evaluations >= 1024 + n_temps * walkers * (
        1 + n_steps)
    x = post.cold_chain().x
    assert torch.isfinite(x).all() and (x.abs() < 10).all()
    lz, err = post.log_evidence_stepping_stone()
    truth = -4 * math.log(20.0)
    assert abs(lz - truth) < max(5 * err, 0.05), (lz, err, truth)


def test_flow_preconditioned_run_inverts_its_own_transform(bounded):
    """``preconditioning="flow"``: the chain runs in the fitted flow's
    latent space, the samples come back in data space with logPi the
    prior's exactly (the Jacobian taken off the carried density)."""
    p, asp = bounded
    post = asp.sample_posterior(
        sampler="ptmcmc", n_samples=64, n_steps=6, n_temperatures=3,
        preconditioning="flow",
        preconditioning_kwargs=dict(fit_kwargs=dict(n_epochs=2,
                                                    batch_size=64)))
    x = post.x
    assert post.chain_shape == (3, 6, 64)
    view = Samples(x=x)
    np.testing.assert_allclose(post.log_prior.numpy(),
                               p.log_prior(view).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(post.log_likelihood.numpy(),
                               p.log_likelihood(view).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_chip_smoke_device_check_replays_its_draws():
    """``chip_smoke.pt_device_check`` on the CPU for both sides: the
    recorded draws replayed (every one consumed) give the same run."""
    out = chip_smoke.pt_device_check(torch.device("cpu"))
    assert out["draws"] == out["rounds"] * (out["swap_every"] * 6 + 2)
    assert all(v == 0.0 for v in out["max_abs_diff"].values())
