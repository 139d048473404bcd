"""The gradient and ensemble mutation kernels of ``aspire_tpu_torch``
against the JAX package's, and the tempered density's gradient.

Each step runs in float64 on one state in both packages. The port draws
through ``kernels._normal``, ``_uniform`` and ``_randint``; the tests
replace them with the JAX package's own draws, made here from the step's
``jax.random.split`` of its key in the order the port draws, so both
steps see the same numbers. NUTS replays each particle's JAX key chain
over the whole tree (a stopped particle's later draws are discarded in
both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import transforms as JT
from aspire_tpu.models import RosenbrockProblem as JRosenbrock
from aspire_tpu.samplers import kernels as JK
from aspire_tpu.samplers.smc import HMCSMC as JHMCSMC
from aspire_tpu.samplers.smc import _value_and_grad_batch
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.models import RosenbrockProblem
from aspire_tpu_torch.samplers import kernels as K
from aspire_tpu_torch.samplers import smc as TSMC
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
N, D = 64, 3
PREC = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 0.5]])


def jax_log_prob(x):
    """A correlated Gaussian with a quartic tail, batched."""
    return (-0.5 * jnp.einsum("ni,ij,nj->n", x, jnp.asarray(PREC), x)
            - 0.05 * jnp.sum(x**4, axis=-1))


def torch_log_prob(x):
    prec = torch.as_tensor(PREC, dtype=x.dtype)
    return (-0.5 * torch.einsum("ni,ij,nj->n", x, prec, x)
            - 0.05 * torch.sum(x**4, dim=-1))


def _states(step_size, seed=0, n=N, grad=True):
    """One start state in both packages: the JAX state (its key, a split
    eval counter) and the port's."""
    x = np.random.default_rng(seed).normal(size=(n, D))
    jx = jnp.asarray(x)
    lp, g = _value_and_grad_batch(jax_log_prob, jx)
    jstate = JK.ChainState(
        x=jx, log_prob=lp, key=jax.random.key(seed + 11),
        step_size=jnp.asarray(step_size), n_accept=jnp.zeros(n),
        grad=g if grad else None, n_evals=JK.eval_counter_init())
    tx = torch.as_tensor(x)
    tlp, tg = TSMC.value_and_grad_batch(torch_log_prob, tx)
    tstate = K.ChainState(
        x=tx, log_prob=tlp, step_size=torch.tensor(step_size,
                                                    dtype=torch.float64),
        n_accept=torch.zeros(n, dtype=torch.float64),
        grad=tg if grad else None)
    return jstate, tstate


def _inject(monkeypatch, draws):
    """Make the port's draw functions return ``draws`` in order (numpy or
    JAX arrays), each checked against the shape asked for."""
    queue = list(draws)

    def take(shape, like, dtype=None):
        v = torch.as_tensor(np.array(queue.pop(0)))
        assert tuple(v.shape) == tuple(torch.Size(shape)), (v.shape, shape)
        return v.to(dtype or like.dtype)

    monkeypatch.setattr(K, "_normal",
                        lambda gen, like: take(like.shape, like))
    monkeypatch.setattr(K, "_uniform", lambda gen, shape, like: take(
        (shape,) if isinstance(shape, int) else shape, like))
    monkeypatch.setattr(K, "_randint", lambda gen, lo, hi, shape, like: take(
        shape, like, torch.int64))
    return queue


def _assert_states_agree(jnew, tnew, grad=True):
    for name in ("x", "log_prob", "step_size", "n_accept") + (
            ("grad",) if grad else ()):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   err_msg=name, **TOL)
    assert int(tnew.n_evals) == JK.eval_counter_total(jnew.n_evals)


def test_mala_step_matches_jax(monkeypatch):
    jstate, tstate = _states(0.4)
    jvg = lambda x: _value_and_grad_batch(jax_log_prob, x)  # noqa: E731
    jnew = JK.mala_step(jstate, jvg, target_acceptance=0.574,
                        adaptation_rate=0.05)
    _, prop_key, accept_key = jax.random.split(jstate.key, 3)
    queue = _inject(monkeypatch, [
        jax.random.normal(prop_key, (N, D), dtype=jnp.float64),
        jax.random.uniform(accept_key, (N,))])
    tnew = K.mala_step(tstate, None, lambda x: TSMC.value_and_grad_batch(
        torch_log_prob, x), target_acceptance=0.574, adaptation_rate=0.05)
    assert not queue
    _assert_states_agree(jnew, tnew)
    assert 0 < float(tnew.n_accept.sum()) < N


@pytest.mark.parametrize("jitter", [False, True])
def test_hmc_step_matches_jax(monkeypatch, jitter):
    """Five leapfrogs (with jitter, the JAX package's drawn length, kept on
    the device as a masked trajectory)."""
    jstate, tstate = _states(0.15, seed=1)
    jvg = lambda x: _value_and_grad_batch(jax_log_prob, x)  # noqa: E731
    jnew = JK.hmc_step(jstate, jvg, n_leapfrog=5, target_acceptance=0.651,
                       adaptation_rate=0.05, jitter_trajectory=jitter)
    _, mom_key, len_key, accept_key = jax.random.split(jstate.key, 4)
    draws = [jax.random.normal(mom_key, (N, D), dtype=jnp.float64)]
    if jitter:
        draws.append(jax.random.randint(len_key, (), 1, 6))
    draws.append(jax.random.uniform(accept_key, (N,)))
    queue = _inject(monkeypatch, draws)
    tnew = K.hmc_step(tstate, None, lambda x: TSMC.value_and_grad_batch(
        torch_log_prob, x), n_leapfrog=5, target_acceptance=0.651,
        adaptation_rate=0.05, jitter_trajectory=jitter)
    assert not queue
    _assert_states_agree(jnew, tnew)
    if jitter:
        assert int(tnew.n_evals) == int(draws[1]) * N < 5 * N


@pytest.mark.parametrize("n", [64, 65])
def test_stretch_step_matches_jax(monkeypatch, n):
    """Both red-black halves, and the uneven split of an odd n."""
    jstate, tstate = _states(1.0, seed=2, n=n, grad=False)
    jnew = JK.stretch_step(jstate, jax_log_prob, a=2.0)
    draws, key = [], jstate.key
    for n_move, n_other in ((n // 2, n - n // 2), (n - n // 2, n // 2)):
        key, z_key, pick_key, accept_key = jax.random.split(key, 4)
        draws += [jax.random.randint(pick_key, (n_move,), 0, n_other),
                  jax.random.uniform(z_key, (n_move,), dtype=jnp.float64),
                  jax.random.uniform(accept_key, (n_move,))]
    queue = _inject(monkeypatch, draws)
    tnew = K.stretch_step(tstate, None, torch_log_prob, a=2.0)
    assert not queue
    _assert_states_agree(jnew, tnew, grad=False)


def test_trailing_ones_and_uturn_match_jax():
    for i in range(1 << 9):
        for bits in (3, 9):
            assert K._trailing_ones(i, bits) == int(
                JK._trailing_ones(jnp.int32(i), bits))
    rng = np.random.default_rng(3)
    za, pa, zb, pb = (rng.normal(size=(200, D)) for _ in range(4))
    want = jax.vmap(JK._is_uturn)(*map(jnp.asarray, (za, pa, zb, pb)))
    got = K._is_uturn(*map(torch.as_tensor, (za, pa, zb, pb)))
    assert got.tolist() == np.asarray(want).tolist()
    assert 0 < int(got.sum()) < 200


def _nuts_draws(key, n, max_depth):
    """Each particle's draws of the JAX package's NUTS trajectory over the
    whole tree, batched as the port draws them: the momenta, then per
    doubling the directions (as uniforms: forward below 1/2), the pick
    uniforms of its leaves and the swap uniforms."""
    _, traj_key = jax.random.split(key)

    def one(k):
        k, mom_key = jax.random.split(k)
        out = [jax.random.normal(mom_key, (D,), dtype=jnp.float64)]
        for depth in range(max_depth):
            k, dir_key, inner = jax.random.split(k, 3)
            out.append(jnp.where(jax.random.bernoulli(dir_key), 0.25, 0.75))
            picks = []
            for _ in range(1 << depth):
                inner, pick_key = jax.random.split(inner)
                picks.append(jax.random.uniform(pick_key, dtype=jnp.float64))
            out.append(jnp.stack(picks))
            k, swap_key = jax.random.split(k)
            out.append(jax.random.uniform(swap_key, dtype=jnp.float64))
        return out

    per = jax.vmap(one)(jax.random.split(traj_key, n))
    return [np.asarray(per[0])] + [
        np.asarray(v).T if v.ndim == 2 else np.asarray(v) for v in per[1:]]


def test_nuts_step_matches_jax(monkeypatch):
    """One NUTS transition at max_depth 4 on the same draws: positions,
    densities, gradients, step size, acceptance statistics and the true
    evaluation count (some trees stop early, by a U-turn)."""
    max_depth = 4
    jstate, tstate = _states(0.35, seed=4)
    jnew = JK.nuts_step(jstate, jax_log_prob, max_depth=max_depth,
                        target_acceptance=0.8, adaptation_rate=0.05)
    _inject(monkeypatch, _nuts_draws(jstate.key, N, max_depth))
    tnew = K.nuts_step(tstate, None, lambda x: TSMC.value_and_grad_batch(
        torch_log_prob, x), max_depth=max_depth, target_acceptance=0.8,
        adaptation_rate=0.05)
    _assert_states_agree(jnew, tnew)
    evals = int(tnew.n_evals)
    assert N < evals < N * ((1 << max_depth) - 1)


def test_nuts_keeps_a_correlated_gaussian_invariant():
    """Ten NUTS steps on N(0, PREC^-1) from exact draws stay there."""
    gen = torch.Generator().manual_seed(0)
    cov = torch.as_tensor(np.linalg.inv(PREC))
    x = torch.randn((4000, D), generator=gen, dtype=torch.float64) @ (
        torch.linalg.cholesky(cov).T)

    def gaussian(z):
        return -0.5 * torch.einsum("ni,ij,nj->n", z,
                                   torch.as_tensor(PREC), z)

    def vg(z):
        return TSMC.value_and_grad_batch(gaussian, z)

    lp, g = vg(x)
    state = K.ChainState(x=x, log_prob=lp,
                         step_size=torch.tensor(0.3, dtype=torch.float64),
                         n_accept=torch.zeros(4000, dtype=torch.float64),
                         grad=g)
    final, stats = K.run_chain(
        lambda s: K.nuts_step(s, gen, vg, max_depth=5), state, 10)
    assert 0.5 < float(final.n_accept.mean()) / 10 <= 1.0
    np.testing.assert_allclose(final.x.mean(0).numpy(), 0.0, atol=0.08)
    np.testing.assert_allclose(torch.cov(final.x.T).numpy(), cov.numpy(),
                               atol=0.1)
    assert float(stats.tau) >= 1.0
    assert 10 * 4000 < int(final.n_evals) <= 10 * 4000 * 31


def test_a_nan_gradient_is_a_rejection():
    """A proposal whose gradient is NaN has a NaN log alpha, which the
    guard turns into a rejection: the particle keeps its position and its
    gradient, never a zero."""
    x = torch.randn((32, D), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    lp, g = TSMC.value_and_grad_batch(torch_log_prob, x)
    state = K.ChainState(x=x, log_prob=lp, step_size=torch.tensor(
        0.1, dtype=torch.float64), n_accept=torch.zeros(32,
                                                        dtype=torch.float64),
        grad=g)

    def nan_below(z):
        v, grad = TSMC.value_and_grad_batch(torch_log_prob, z)
        return v, torch.where(z[:, :1] < 0, torch.nan, grad)

    new = K.mala_step(state, torch.Generator().manual_seed(2), nan_below)
    hole = new.x[:, 0] < 0
    assert bool(torch.isfinite(new.grad).all())
    moved = (new.x != x).any(dim=1)
    assert not bool((moved & hole).any()) and bool(moved.any())
    assert torch.equal(new.grad[~moved], g[~moved])


@pytest.fixture(scope="module")
def rosenbrock_flow():
    """nsf-tpu at d = 2 (narrow) on Rosenbrock's box, fitted for 3 epochs
    by the JAX package; its weights and logit + affine data transform in
    float64 for both packages (the transform refitted in float64 on the
    same draws)."""
    from aspire_tpu import Aspire as JAspire
    from aspire_tpu import Samples as JSamples

    jp = JRosenbrock(dims=2)
    draws = jp.draw_initial_samples(np.random.default_rng(0), 1000)
    asp = JAspire(log_likelihood=jp.log_likelihood, log_prior=jp.log_prior,
                  dims=2, prior_bounds=jp.prior_bounds, flow_backend="nsf",
                  architecture="nsf-tpu", n_hidden=(16, 16), seed=1)
    asp.fit(JSamples(draws), n_epochs=3, batch_size=256)
    dt = JT.FlowTransform(parameters=asp.parameters,
                          prior_bounds=jp.prior_bounds,
                          bounded_transform="logit", dtype="float64")
    dt.fit(jnp.asarray(draws))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          asp.flow.params)
    return asp.flow, params, dt


def test_tempered_gradient_matches_jax(rosenbrock_flow):
    """The tempered log-density and its gradient (the flow through its
    logit + affine data transform, the box prior, the likelihood) against
    ``_value_and_grad_batch`` of the JAX package's tempered density, in
    float64, near the box's edges too."""
    jflow, jparams, jdt = rosenbrock_flow
    jp, tp = JRosenbrock(dims=2), RosenbrockProblem(dims=2)
    jsampler = JHMCSMC(log_likelihood=jp.log_likelihood,
                       log_prior=jp.log_prior, dims=2, prior_flow=jflow)
    tempered = jsampler.make_tempered_log_prob()
    flow = Flow(dims=2, architecture="nsf-tpu", n_hidden=(16, 16),
                dtype="float64", device="cpu",
                data_transform=transform_from_jax(jdt, dtype="float64"))
    flow.params = flow_params_from_jax(jparams, dtype="float64")
    sampler = TSMC.HMCSMC(log_likelihood=tp.log_likelihood,
                          log_prior=tp.log_prior, dims=2, prior_flow=flow,
                          dtype="float64", device="cpu")
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-4.9, 4.9, (96, 2)),
                        rng.uniform(4.99, 4.9999, (16, 2))
                        * rng.choice([-1.0, 1.0], (16, 2))])
    jax_value_and_grad = jax.jit(lambda z, beta: _value_and_grad_batch(
        lambda zz: tempered((jparams, jdt), None, zz, beta), z))
    for beta in (0.0, 0.3, 1.0):
        lp, g = jax_value_and_grad(jnp.asarray(x), beta)
        tlp, tg = TSMC.value_and_grad_batch(
            lambda z: sampler.tempered_log_prob(z, beta), torch.as_tensor(x))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(lp), **TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), **TOL)
        assert bool(torch.isfinite(tg).all())
