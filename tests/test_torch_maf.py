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
    """The packed buffer, un-permuted from degree order and with the
    blocks the masks zero put back as zeros, holds the JAX package's
    ``prepare_maf_params`` sections (mask-premultiplied weights)."""
    jarch, params, tarch, tparams = _pair(dtype="float32", bins=bins)
    packed = FC.prepare_maf_params(tarch, tparams)
    L, P, G = tarch.n_layers, tarch.n_params_per_dim, FC.maf_group(tarch)
    h1, h2 = HIDDEN
    assert packed.dtype == torch.float32 and G % 8 == 0
    assert packed.numel() == L * FC.maf_layer_floats(tarch)
    jw = [np.asarray(a) for a in j_prepare_maf_params(jarch, params)]
    jG = jw[4].shape[1] // 4
    want = {
        "w1": jw[0], "b1": jw[1][..., 0],
        "w2": jw[2].transpose(0, 2, 1), "b2": jw[3][..., 0],
        "w3": jw[4].reshape(L, 4, jG, -1)[:, :, :P].transpose(0, 3, 1, 2),
        "b3": jw[5][..., 0].reshape(L, 4, jG)[..., :P],
    }
    o1 = FC.degree_order(tarch, h1)
    o2 = FC.degree_order(tarch, h2)
    for layer, buf in enumerate(packed.reshape(L, -1)):
        sec = FC.unpack_maf_layer(tarch, buf)
        got = {"w1": torch.zeros(h1, 4), "b1": torch.zeros(h1),
               "w2": torch.zeros(h1, h2), "b2": torch.zeros(h2),
               "w3": torch.zeros(h2, 4, G)}
        got["w1"][o1] = sec["w1"]
        got["b1"][o1] = sec["b1"]
        got["w2"][o1[:, None], o2[None, :]] = sec["w2"]
        got["b2"][o2] = sec["b2"]
        got["w3"][o2] = sec["w3"].reshape(h2, 4, G)
        assert bool((got["w3"][..., P:] == 0).all())
        assert bool((sec["b3"][:, P:] == 0).all())
        got["w3"] = got["w3"][..., :P]
        got["b3"] = sec["b3"][:, :P]
        for name, value in got.items():
            np.testing.assert_allclose(value.numpy(), want[name][layer],
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_maf_kernel_layout_fits_one_block():
    """maf_rqs(4) is compiled, has the kernel's layer size (6816 floats:
    48 W2 and 51 W3 fragments of the kept 8-wide blocks, against 10720 for
    the dense layout), and its weights with 16 warps' buffers fit one
    block's shared memory."""
    arch = maf_rqs(4)
    assert FC.maf_config_id(arch) == 0
    ks2, ks3 = FC.maf_ksteps(arch)
    assert ks2 == (3, 3, 6, 6, 6, 8, 8, 8) and ks3 == (0, 3, 6, 8)
    assert dict(FC.maf_sections(arch))["w2"] == (48, 32, 2)
    assert dict(FC.maf_sections(arch))["w3"] == (51, 32, 2)
    assert FC.maf_layer_floats(arch) == 6816
    assert FC.maf_stage_floats(arch) == 1216
    assert 4 * (4 * 6816 + 16 * 1216) <= FC.MAX_SHARED_BYTES
    assert FC.maf_shared_bytes(arch) == 4 * (4 * 6816 + 1216)


def test_maf_kernel_configs_mirror_common_cuh():
    """``MAF_KERNEL_CONFIGS`` is ``ASPIRE_MAF_CONFIGS``, and every compiled
    shape takes the kernel's hidden widths (multiples of 8)."""
    from aspire_tpu_torch.ops import _build

    parsed = {(d, hidden, k): cid for cid, d, hidden, k
              in _build.config_rows("ASPIRE_MAF_CONFIGS")}
    assert parsed == FC.MAF_KERNEL_CONFIGS
    assert all(h % 8 == 0 for _, hidden, _ in parsed for h in hidden)


@pytest.mark.parametrize("dims,hidden", [(1, (8, 8)), (2, (16, 8)),
                                         (4, (16, 16)), (4, (64, 64)),
                                         (5, (24, 16))])
def test_maf_kept_blocks_cover_every_mask_entry(dims, hidden):
    """In degree order the blocks the kernel multiplies hold every weight
    the MADE masks keep: W1 row u sees inputs below its degree, W2 n-tile j
    reads its first 8 * ks2[j] units, dim i's W3 columns its first
    8 * ks3[i] (none for dim 0)."""
    arch = maf_rqs(dims, n_hidden=hidden)
    m1, m2, m3 = tnets.made_masks(dims, list(hidden), arch.n_params_per_dim)[0]
    o1, o2 = FC.degree_order(arch, hidden[0]), FC.degree_order(arch, hidden[1])
    e1 = FC.degree_ends(arch, hidden[0])
    ks2, ks3 = FC.maf_ksteps(arch)
    w1 = m1[:, o1].t()
    for deg in range(1, len(e1)):
        seg = w1[e1[deg - 1]:e1[deg]]
        assert bool((seg[:, deg:] == 0).all()) and bool((seg[:, :deg] == 1).all())
    w2 = m2[o1][:, o2]
    for j, k in enumerate(ks2):
        assert bool((w2[8 * k:, 8 * j:8 * j + 8] == 0).all())
    w3 = m3[o2].reshape(hidden[1], dims, -1)
    for i, k in enumerate(ks3):
        assert bool((w3[8 * k:, i] == 0).all())
    assert ks3[0] == 0 and bool((w3[:, 0] == 0).all())


def _maf_rqs4_pair(n_layers, dtype):
    """A ``maf_rqs(4)``-shaped flow ((64, 64) hidden, 8 bins) of
    ``n_layers`` layers in both packages, perturbed from its init."""
    kw = dict(dims=4, n_layers=n_layers, n_hidden=(64, 64), transformer="rqs",
              num_bins=8, dtype=dtype)
    jarch = JMAF(**kw)
    params = jarch.init(jax.random.key(3))
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(4), p.shape,
                                              p.dtype), params)
    return jarch, params, MAF(**kw), flow_params_from_jax(params, dtype=dtype)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_maf_packed_plain_matches_jax_f64(n_layers):
    """The kernel's reading of its buffer (degree order, kept blocks only,
    dim 0 from the bias) against the JAX package's ``_forward_xla`` in
    float64 (float64 parameters pack to a float64 buffer, unrounded)."""
    jarch, params, tarch, tparams = _maf_rqs4_pair(n_layers, "float64")
    x = _x(300, seed=n_layers)
    zj, ldj = jarch._forward_xla(params, jnp.asarray(x))
    packed = FC.prepare_maf_params(tarch, tparams)
    assert packed.dtype == torch.float64
    z, ld = FC.maf_packed_plain(tarch, packed, torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), atol=1e-10,
                               rtol=0)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_maf_packed_plain_matches_jax_pallas_interpret(n_layers):
    """The same against the JAX Pallas MAF kernel in interpret mode, in
    float32 at the JAX package's own kernel bound."""
    jarch, params, tarch, tparams = _maf_rqs4_pair(n_layers, "float32")
    x = _x(256, np.float32, seed=10 + n_layers, scale=1.5)
    zj, ldj = _pallas_maf_forward(jarch, j_prepare_maf_params(jarch, params),
                                  jnp.asarray(x), interpret=True)
    packed = FC.prepare_maf_params(tarch, tparams)
    z, ld = FC.maf_packed_plain(tarch, packed, torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


def test_maf_main_path_never_reads_the_packed_plain(monkeypatch):
    """The kernel wrapper and the flow's density pass do not go through
    ``maf_packed_plain`` (it exists for the layout's tests)."""
    def refuse(*args, **kwargs):
        raise AssertionError("maf_packed_plain on the main path")

    monkeypatch.setattr(FC, "maf_packed_plain", refuse)
    _, _, tarch, tparams = _pair(dtype="float32")
    x = torch.as_tensor(_x(64, np.float32))
    z, ld = FC.fused_maf_forward(tarch, tparams, x)
    z2, ld2 = tarch.forward(tparams, x)
    torch.testing.assert_close(z, z2)
    torch.testing.assert_close(ld, ld2)


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
        assert jflows.get_flow_class(name) is jflows.FlowMatching
        assert tflows.get_flow_class(name) is tflows.FlowMatching
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
