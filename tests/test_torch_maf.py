"""The port's MAF family against the JAX package.

Same inputs (numpy, from a seed) and converted parameters go through the
JAX function and its port: MADE masks and passes, the plain MAF passes in
float64, the MAF-RQS kernel wrapper on a CPU tensor (its plain version)
against the JAX Pallas kernel in interpret mode in float32, the autograd
wrapper, the optimizer step, the packed kernel layout, the backend names
and defaults, the mutation route, and the MAF slice end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu import flows as jflows
from aspire_tpu.flows import nets as jnets
from aspire_tpu.flows.architectures import MAF as JMAF
from aspire_tpu.flows.base import Flow as JFlow
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu.ops.fused_coupling import (
    _pallas_maf_forward,
    prepare_maf_params as j_prepare_maf_params,
)
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch import flows as tflows
from aspire_tpu_torch.flows import nets as tnets
from aspire_tpu_torch.flows.architectures import MAF, maf_rqs, nsf
from aspire_tpu_torch.flows.base import Flow
from aspire_tpu_torch.flows.train import TrainConfig, make_optimizer, param_leaves
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

torch.set_num_threads(1)

HIDDEN = (16, 16)
N, STEPS = 1024, 5


def _pair(transformer="rqs", dtype="float64", n_layers=3, bins=8,
          perturb=0.2):
    kw = dict(dims=4, n_layers=n_layers, n_hidden=HIDDEN,
              transformer=transformer, num_bins=bins, dtype=dtype)
    jarch = JMAF(**kw)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + perturb * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype), params)
    return jarch, params, MAF(**kw), flow_params_from_jax(params, dtype=dtype)


def _x(n, dtype=np.float64, seed=0, scale=2.5):
    return (scale * np.random.default_rng(seed).normal(size=(n, 4))
            ).astype(dtype)


# -- MADE -------------------------------------------------------------------


@pytest.mark.parametrize("dims", [1, 2, 4, 5])
def test_made_masks_match_jax_exactly(dims):
    jm, jdeg = jnets.made_masks(dims, [16, 12], 23)
    tm, tdeg = tnets.made_masks(dims, [16, 12], 23)
    assert len(tm) == len(jm)
    for a, b in zip(tm, jm):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tdeg.numpy(), jdeg)


def test_apply_made_matches_jax_f64():
    params, masks = jnets.init_made(jax.random.key(2), 4, list(HIDDEN), 23,
                                    dtype=jnp.float64)
    params = jax.tree.map(
        lambda p: p + 0.3 * jax.random.normal(jax.random.key(3), p.shape,
                                              p.dtype), params)
    x = _x(200)
    want = jnets.apply_made(params, masks, jnp.asarray(x))
    tmasks = [m.double() for m in tnets.made_masks(4, list(HIDDEN), 23)[0]]
    got = tnets.apply_made(flow_params_from_jax(params, dtype="float64"),
                           tmasks, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10,
                               rtol=0)


# -- plain MAF passes -----------------------------------------------------------


@pytest.mark.parametrize("transformer", ["affine", "rqs"])
@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_maf_plain_matches_jax_f64(transformer, mode):
    jarch, params, tarch, tparams = _pair(transformer)
    x = _x(300)
    if mode == "forward":
        yj, ldj = jarch._forward_xla(params, jnp.asarray(x))
        yt, ldt = tarch.forward_plain(tparams, torch.as_tensor(x))
    else:
        yj, ldj = jarch.inverse(params, jnp.asarray(x))
        yt, ldt = tarch.inverse(tparams, torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-10,
                               rtol=0)


@pytest.mark.parametrize("transformer", ["affine", "rqs"])
def test_maf_round_trip_f64(transformer):
    _, _, tarch, tparams = _pair(transformer)
    x = torch.as_tensor(_x(300, scale=1.5))
    z, ld = tarch.forward(tparams, x)
    back, ld_inv = tarch.inverse(tparams, z)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-8)
    torch.testing.assert_close(ld_inv, -ld, rtol=0, atol=1e-8)


# -- the B4 kernel wrapper --------------------------------------------------------


@pytest.fixture(scope="module", params=[256, 1000])
def pallas_reference(request):
    """The JAX Pallas MAF kernel in interpret mode, computed once per n."""
    n = request.param
    jarch, params, tarch, tparams = _pair(dtype="float32", perturb=0.1)
    x = _x(n, np.float32, seed=n, scale=1.0)
    z, ld = _pallas_maf_forward(jarch, j_prepare_maf_params(jarch, params),
                                jnp.asarray(x), interpret=True)
    return tarch, tparams, x, np.asarray(z), np.asarray(ld)


def test_maf_wrapper_matches_jax_pallas_interpret(pallas_reference):
    """The wrapper on a CPU tensor (its plain version) against the JAX
    Pallas kernel in interpret mode, float32, at the JAX package's own
    kernel tolerance."""
    tarch, tparams, x, zj, ldj = pallas_reference
    z, ld = FC.maf_kernel_apply(tarch, tparams, torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), zj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), ldj, rtol=1e-3, atol=1e-4)


def test_maf_autograd_wrapper_matches_jax_grad_f64():
    """Gradients through the autograd wrapper (backward recomputed on the
    plain path) against ``jax.grad`` of ``_forward_xla``, in x and the
    parameters."""
    jarch, params, tarch, tparams = _pair()
    x = _x(64, seed=5, scale=1.5)

    def jloss(p, xx):
        z, ld = jarch._forward_xla(p, xx)
        return jnp.sum(z**2) + jnp.sum(ld)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    leaves = param_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    z, ld = FC.fused_maf_forward(tarch, tparams, xt)
    got = torch.autograd.grad((z**2).sum() + ld.sum(), [xt, *leaves])
    want = [np.asarray(gx)] + [t.numpy() for t in param_leaves(
        flow_params_from_jax(gp, dtype="float64"))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-8, rtol=1e-8)


def test_maf_adam_step_matches_optax_f64():
    """One clip + Adam step of flow training from the same parameters and
    batch, against the JAX trainer's optax chain."""
    jarch, params, tarch, tparams = _pair()
    jflow = JFlow(dims=4, architecture=jarch, dtype="float64")
    batch = _x(128, seed=7, scale=1.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(optax.cosine_decay_schedule(3e-3, 100)))
    grads = jax.grad(jflow.loss_fn)(params, jnp.asarray(batch), None)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = flow_params_from_jax(optax.apply_updates(params, updates),
                                dtype="float64")

    tflow = Flow(dims=4, architecture=tarch, dtype="float64", device="cpu")
    leaves = param_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    opt = make_optimizer(
        leaves, TrainConfig(learning_rate=3e-3, max_grad_norm=5.0), 100)
    loss = tflow.loss_fn(tparams, torch.as_tensor(batch))
    opt.step(list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(param_leaves(tparams), param_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-8,
                                   rtol=0)


@pytest.mark.parametrize("bins", [4, 8])
def test_prepare_maf_params_matches_jax_sections(bins):
    """Every section of the packed buffer holds the JAX package's
    mask-premultiplied weights, and is zero where the masks are zero."""
    jarch, params, tarch, tparams = _pair(dtype="float32", bins=bins)
    packed = FC.prepare_maf_params(tarch, tparams)
    L, P, G = tarch.n_layers, tarch.n_params_per_dim, FC.maf_group(tarch)
    assert packed.dtype == torch.float32
    assert packed.numel() == L * FC.maf_layer_floats(tarch)
    jw = [np.asarray(a) for a in j_prepare_maf_params(jarch, params)]
    jG = jw[4].shape[1] // 4
    want = {
        "w1": jw[0], "b1": jw[1][..., 0],
        "w2": jw[2].transpose(0, 2, 1), "b2": jw[3][..., 0],
        "w3": jw[4].reshape(L, 4, jG, -1)[:, :, :P].transpose(0, 1, 3, 2),
        "b3": jw[5][..., 0].reshape(L, 4, jG)[..., :P],
    }
    masks = tarch.masks(packed)
    mask_of = {"w1": masks[0].t(), "w2": masks[1],
               "w3": masks[2].reshape(-1, 4, P).permute(1, 0, 2)}
    layers = packed.reshape(L, -1)
    off = 0
    for name, shape in FC.maf_sections(tarch):
        off = -(-off // 4) * 4
        size = int(np.prod(shape))
        sec = layers[:, off:off + size].reshape(L, *shape)
        off += size
        if name in ("w3", "b3"):
            assert bool((sec[..., P:] == 0).all())
            sec = sec[..., :P]
        np.testing.assert_allclose(sec.numpy(), want[name], rtol=1e-6,
                                   atol=1e-7)
        if name in mask_of:
            assert bool((sec[:, mask_of[name] == 0] == 0).all())


def test_maf_kernel_layout_fits_one_block():
    """maf_rqs(4) is compiled, has the kernel's layer size (10720 floats)
    and fits one block's shared memory."""
    arch = maf_rqs(4)
    assert FC.maf_config_id(arch) == 0
    assert FC.maf_layer_floats(arch) == 10720
    assert 4 * 4 * 10720 <= FC.MAX_SHARED_BYTES


def test_maf_and_coupling_kernel_tables_stay_apart():
    """A 4-d MAF-RQS with (64, 64) hidden and 8 bins has the coupling
    kernel's configuration-0 shape, yet is never packed for it; affine
    MAF never fuses; a CPU batch never fuses."""
    assert FC.config_id(maf_rqs(4)) is None
    assert FC.config_id(nsf(4)) == 0
    assert FC.maf_config_id(nsf(4)) is None
    assert FC.maf_config_id(MAF(dims=4, transformer="affine")) is None
    assert not FC.should_fuse_maf(maf_rqs(4), torch.zeros(8192, 4))


def test_maf_wrapper_raises_off_cpu_and_cuda():
    _, _, tarch, tparams = _pair(dtype="float32")
    with pytest.raises(ValueError):
        FC.maf_kernel_apply(tarch, tparams,
                            torch.empty((8192, 4), device="meta"))


def test_packed_maf_params_pack_once_per_parameter_set():
    _, _, tarch, tparams = _pair(dtype="float32")
    first = FC.packed_maf_params(tarch, tparams)
    assert FC.packed_maf_params(tarch, tparams) is first
    rebuilt = {"layers": [{"layers": list(net["layers"])}
                          for net in tparams["layers"]]}
    assert FC.packed_maf_params(tarch, rebuilt) is first
    with torch.no_grad():
        tparams["layers"][1]["layers"][2]["b"].add_(1.0)
    second = FC.packed_maf_params(tarch, tparams)
    assert second is not first
    torch.testing.assert_close(second, FC.prepare_maf_params(tarch, tparams))


# -- factory, defaults and the mutation route ---------------------------------------


@pytest.mark.parametrize("name", sorted(jflows._KNOWN_BACKENDS))
def test_backend_names_match_jax(name):
    assert (tflows.default_architecture_for_backend(name)
            == jflows.default_architecture_for_backend(name))
    if name in ("flow_matching", "cnf"):
        with pytest.raises(NotImplementedError):
            tflows.get_flow_class(name)
    else:
        assert jflows.get_flow_class(name) is jflows.Flow
        assert tflows.get_flow_class(name) is tflows.Flow


def test_defaults_are_maf_as_in_jax():
    import inspect

    for fn in (Aspire.__init__, Flow.__init__, tflows.get_flow_class):
        params = inspect.signature(fn).parameters
        key = "flow_backend" if "flow_backend" in params else (
            "architecture" if "architecture" in params else "backend")
        assert params[key].default == "maf"
    assert tflows.get_flow_class() is tflows.Flow
    assert tflows.default_architecture_for_backend(None) == "maf"
    assert isinstance(Flow(dims=2, device="cpu").architecture, MAF)


@pytest.mark.parametrize("fused_chain", ["auto", True])
@pytest.mark.parametrize("architecture,route", [("maf-rqs", "split"),
                                                ("nsf-tpu", "fused_kernel")])
def test_mutation_route_follows_the_flow_family(architecture, route,
                                                fused_chain):
    """A MAF flow takes the split chain even with an in-kernel target and
    ``fused_chain`` on, as in the JAX package; a coupling flow still takes
    the whole-chain kernel's route."""
    p = GaussianMixtureProblem(dims=4)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow_backend=architecture, n_hidden=(8, 8),
                 n_layers=2, seed=0, device="cpu")
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            n_epochs=1, batch_size=256)
    post = asp.sample_posterior(
        sampler="smc", n_samples=512, n_steps=2, adaptive=False,
        sampler_kwargs=dict(n_steps=2, fused_chain=fused_chain))
    assert asp.sampler.history.mutation_route == [route, route]
    assert bool(torch.isfinite(post.x).all())


# -- the MAF slice end to end ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fit():
    p = JMixture(dims=4)
    init = JSamples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=4, seed=1, flow_backend="maf-rqs", n_hidden=HIDDEN)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    return asp


def _port(jasp):
    p = GaussianMixtureProblem(dims=4)
    jflow = jasp.flow
    flow = Flow(dims=4, architecture="maf-rqs", n_hidden=HIDDEN,
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow=flow, seed=1, device="cpu",
                 flow_backend="maf-rqs")
    return p, asp


def test_maf_slice_flow_densities_match_jax(jax_fit):
    """The converted flow, with its fitted data transform, gives the JAX
    flow's log q (float32)."""
    _, asp = _port(jax_fit)
    x = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
    np.testing.assert_allclose(asp.flow.log_prob(x).numpy(),
                               np.asarray(jax_fit.flow.log_prob(x)),
                               rtol=1e-4, atol=1e-4)


def test_maf_slice_log_evidence_matches_jax_and_truth(jax_fit):
    p, asp = _port(jax_fit)
    post = asp.sample_posterior(sampler="smc", n_samples=N,
                                sampler_kwargs=dict(n_steps=STEPS))
    assert set(asp.sampler.history.mutation_route) == {"split"}
    assert post.x.shape == (N, 4) and bool(torch.isfinite(post.x).all())
    truth = p.true_log_evidence()
    err = post.log_evidence_error
    assert abs(post.log_evidence - truth) < max(5 * err, 0.1)
    jpost = jax_fit.sample_posterior(
        sampler="smc", n_samples=N, sampler_kwargs=dict(n_steps=STEPS))
    jerr = float(jpost.log_evidence_error)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < 5 * np.hypot(
        err, jerr)


@pytest.mark.parametrize("backend", ["maf-rqs", "maf"])
def test_maf_slice_with_the_port_fitting_its_own_flow(backend):
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, seed=1, device="cpu", flow_backend=backend,
                 n_hidden=HIDDEN)
    hist = asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    assert len(hist.training_loss) == 10
    assert isinstance(asp.flow.architecture, MAF)
    post = asp.sample_posterior(sampler="smc", n_samples=N,
                                sampler_kwargs=dict(n_steps=STEPS))
    assert set(asp.sampler.history.mutation_route) == {"split"}
    assert abs(post.log_evidence - p.true_log_evidence()) < max(
        5 * post.log_evidence_error, 0.1)
