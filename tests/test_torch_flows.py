"""aspire_tpu_torch flows against the JAX package.

Same inputs (numpy, from a seed) and converted parameters go through the
JAX function and its port: the plain coupling path against the JAX XLA
path in float64, against the JAX Pallas kernel run in interpret mode in
float32, the spline bijector, the autograd wrapper of the coupling
kernel, and the optimizer step of flow training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aspire_tpu.flows import bijectors as jbij
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.flows.base import Flow as JFlow
from aspire_tpu.ops.fused_coupling import _pallas_apply, prepare_params
from aspire_tpu_torch.flows import bijectors as tbij
from aspire_tpu_torch.flows.architectures import Coupling
from aspire_tpu_torch.flows.base import Flow
from aspire_tpu_torch.flows.train import TrainConfig, make_optimizer, param_leaves
from aspire_tpu_torch.ops.fused_coupling import (
    coupling_kernel_apply,
    fused_coupling_apply,
)
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)


def _pair(transformer, dims=4, dtype="float64", hidden=(16, 16), bins=8,
          n_layers=3, perturb=0.2):
    jarch = JCoupling(dims=dims, n_layers=n_layers, n_hidden=hidden,
                      transformer=transformer, num_bins=bins, dtype=dtype)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + perturb * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype),
        params,
    )
    tarch = Coupling(dims=dims, n_layers=n_layers, n_hidden=hidden,
                     transformer=transformer, num_bins=bins, dtype=dtype)
    tparams = flow_params_from_jax(params, dtype=dtype)
    return jarch, params, tarch, tparams


def _x(n, dims, dtype=np.float64, seed=0, scale=2.5):
    return (scale * np.random.default_rng(seed).normal(size=(n, dims))
            ).astype(dtype)


@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_bijector_matches_jax_f64(inverse):
    rng = np.random.default_rng(3)
    K = 6
    x = 3.0 * rng.normal(size=(200, 3))
    raw = rng.normal(size=(200, 3, 3 * K - 1))
    y_j, ld_j = jbij.rational_quadratic_spline(
        jnp.asarray(x), jnp.asarray(raw), K, 4.0, inverse=inverse)
    y_t, ld_t = tbij.rational_quadratic_spline(
        torch.as_tensor(x), torch.as_tensor(raw), K, 4.0, inverse=inverse)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=1e-10,
                               rtol=0)


def test_affine_bijector_and_base_match_jax_f64():
    rng = np.random.default_rng(4)
    x, shift, raw = (rng.normal(size=(50, 3)) for _ in range(3))
    ls_j = jbij.constrain_log_scale(jnp.asarray(raw))
    ls_t = tbij.constrain_log_scale(torch.as_tensor(raw))
    np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j), atol=1e-12)
    for jf, tf in ((jbij.affine_forward, tbij.affine_forward),
                   (jbij.affine_inverse, tbij.affine_inverse)):
        yj, lj = jf(jnp.asarray(x), jnp.asarray(shift), ls_j)
        yt, lt = tf(torch.as_tensor(x), torch.as_tensor(shift), ls_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-12)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-12)
    np.testing.assert_allclose(
        tbij.standard_normal_log_prob(torch.as_tensor(x)).numpy(),
        np.asarray(jbij.standard_normal_log_prob(jnp.asarray(x))),
        atol=1e-12)


@pytest.mark.parametrize("transformer", ["rqs", "affine"])
@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_coupling_plain_matches_jax_xla_f64(transformer, mode):
    jarch, params, tarch, tparams = _pair(transformer)
    x = _x(300, 4)
    if mode == "forward":
        yj, ldj = jarch._forward_xla(params, jnp.asarray(x))
        yt, ldt = tarch.forward_plain(tparams, torch.as_tensor(x))
    else:
        yj, ldj = jarch._inverse_xla(params, jnp.asarray(x))
        yt, ldt = tarch.inverse_plain(tparams, torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-10,
                               rtol=0)


@pytest.mark.parametrize("transformer", ["rqs", "affine"])
@pytest.mark.parametrize("dims", [4, 5])
@pytest.mark.parametrize("n", [256, 1000])
@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_coupling_matches_jax_pallas_interpret(transformer, dims, n, mode):
    """The port's wrapper on a CPU tensor (its plain version) against the
    JAX Pallas kernel in interpret mode, float32, at the JAX package's
    own kernel tolerance and input scale (odd d exercises the dummy
    parameter group)."""
    jarch, params, tarch, tparams = _pair(transformer, dims=dims,
                                          dtype="float32", perturb=0.1)
    x = _x(n, dims, np.float32, seed=n + dims, scale=1.0)
    yj, ldj = _pallas_apply(jarch, mode, prepare_params(jarch, params),
                            jnp.asarray(x), interpret=True)
    yt, ldt = coupling_kernel_apply(tarch, mode, tparams, torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_fused_coupling_autograd_recomputes_plain(mode):
    """The autograd.Function around the kernel gives the plain path's
    gradients (its backward recomputes through the plain version)."""
    _, _, tarch, tparams = _pair("rqs")
    x = torch.as_tensor(_x(64, 4)).requires_grad_(True)
    leaves = param_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)

    def loss(fn):
        y, ld = fn(tparams, x)
        return (y**2).sum() + ld.sum()

    plain = tarch.forward_plain if mode == "forward" else tarch.inverse_plain
    g_ref = torch.autograd.grad(loss(plain), [x, *leaves])
    g = torch.autograd.grad(
        loss(lambda p, xx: fused_coupling_apply(tarch, mode, p, xx)),
        [x, *leaves])
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_grad_norm", [5.0, 0.05])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_adam_steps_match_optax_f64(max_grad_norm, n_steps):
    """Clip + Adam + cosine decay from identical parameters on a fixed
    batch, against the JAX trainer's optax chain."""
    jarch, params, tarch, tparams = _pair("rqs")
    jflow = JFlow(dims=4, architecture=jarch, dtype="float64")
    batch = _x(128, 4, seed=7, scale=1.0)
    total = 100
    tx = optax.chain(
        optax.clip_by_global_norm(max_grad_norm),
        optax.adam(optax.cosine_decay_schedule(3e-3, total)),
    )
    state = tx.init(params)
    p = params
    for _ in range(n_steps):
        grads = jax.grad(jflow.loss_fn)(p, jnp.asarray(batch), None)
        updates, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, updates)

    tflow = Flow(dims=4, architecture=tarch, dtype="float64", device="cpu")
    leaves = param_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    opt = make_optimizer(
        leaves, TrainConfig(learning_rate=3e-3, max_grad_norm=max_grad_norm),
        total)
    for _ in range(n_steps):
        loss = tflow.loss_fn(tparams, torch.as_tensor(batch))
        opt.step(list(torch.autograd.grad(loss, leaves)))
    want = flow_params_from_jax(p, dtype="float64")
    for a, b in zip(param_leaves(tparams), param_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-8,
                                   rtol=0)


def test_flow_fit_trains_and_restores_best():
    rng = np.random.default_rng(0)
    x = rng.normal(loc=1.0, scale=0.5, size=(600, 2))
    flow = Flow(dims=2, architecture="nsf", n_layers=2, n_hidden=(16, 16),
                seed=0, device="cpu")
    before = float(-flow.log_prob(x).mean())
    hist = flow.fit(x, n_epochs=15, batch_size=64, learning_rate=3e-3)
    after = float(-flow.log_prob(x).mean())
    assert len(hist.validation_loss) == 15
    assert after < before
    xs, lq = flow.sample_and_log_prob(256)
    torch.testing.assert_close(lq, flow.log_prob(xs), rtol=1e-4, atol=1e-4)
