"""BASELINE config 5 in the port against the JAX package, on the CPU.

The d = 32 hierarchical posterior (``HierarchicalProblem``): its densities
and initial draws, its in-kernel target id, the whole chain on it (the
port's plain version beside the JAX package's fused chain in Pallas
interpret mode, on the same injected noise), the wide tensor-core layout
of the config's flow shape (d = 32, (128, 128), 8 bins) read back as the
kernels read it, a CPU slice of the pipeline on JAX-fitted weights, and
the quadrature value of log Z that ``chip_smoke.py`` prints beside its
run. Flows are cut to 2 layers (the chain and slice also to (16, 16)
hidden units) so the tests stay quick.
"""

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
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.flows.architectures import nsf as jnsf
from aspire_tpu.models import HierarchicalProblem as JHierarchical
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.ops.fused_coupling import _pallas_apply, prepare_params
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch import Aspire
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.flows.architectures import Coupling, nsf
from aspire_tpu_torch.models import HierarchicalProblem, target_densities
from aspire_tpu_torch.models.targets import HIERARCHICAL
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import (
    flow_params_from_jax,
    transform_from_jax,
)

torch.set_num_threads(1)

D = 32
#: log Z of the d = 32 problem by quadrature on a 2801 x 2001 grid
#: (scipy's dblquad gives -46.24484).
QUADRATURE_LOG_Z = -46.2448


def _points(n: int = 400) -> np.ndarray:
    """The problem's initial draws, then a wider spread (s from -4 to 3,
    where exp(s) and the prior on theta change by orders of magnitude)."""
    p = HierarchicalProblem(D)
    rng = np.random.default_rng(11)
    x = p.draw_initial_samples(rng, n)
    wide = x + rng.normal(scale=1.5, size=x.shape)
    wide[:, 1] = np.linspace(-4.0, 3.0, n)
    return np.concatenate([x, wide])


def test_problem_matches_jax_f64():
    """Same data, same initial draws from the same generator, and the
    likelihood and prior equal in float64."""
    jp, tp = JHierarchical(D), HierarchicalProblem(D)
    np.testing.assert_array_equal(tp.y_obs, jp.y_obs)
    np.testing.assert_array_equal(
        tp.draw_initial_samples(np.random.default_rng(7), 300),
        jp.draw_initial_samples(np.random.default_rng(7), 300))
    x = _points()
    view = types.SimpleNamespace(x=torch.as_tensor(x))
    jview = types.SimpleNamespace(x=jnp.asarray(x))
    np.testing.assert_allclose(tp.log_likelihood(view).numpy(),
                               np.asarray(jp.log_likelihood(jview)),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(tp.log_prior(view).numpy(),
                               np.asarray(jp.log_prior(jview)),
                               rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_target_matches_jax_td(dtype):
    """``target_densities(HIERARCHICAL, ...)``, the plain version of the
    chain kernel's target, against the JAX problem's ``log_*_td`` (its
    fused chain's target): float64 to 1e-10, float32 (constants as the
    kernel gets them) to 1e-4."""
    jp, tp = JHierarchical(D), HierarchicalProblem(D)
    target_id, consts = tp.kernel_target()
    assert target_id == HIERARCHICAL and consts.shape == (D - 2,)
    x = _points()
    # float64: the data unrounded; float32: as the kernel gets it.
    if dtype == torch.float64:
        consts = torch.as_tensor(tp.y_obs)
    lpi, ll = target_densities(target_id, consts,
                               torch.as_tensor(x, dtype=dtype))
    xt = jnp.asarray(x.T)
    tol = (dict(rtol=0, atol=1e-10) if dtype == torch.float64 else
           dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(lpi.double().numpy(),
                               np.asarray(jp.log_prior_td(xt))[0], **tol)
    np.testing.assert_allclose(ll.double().numpy(),
                               np.asarray(jp.log_likelihood_td(xt))[0],
                               **tol)
    # exp(s) under- and overflows go to -inf, never NaN.
    far = torch.zeros((3, D), dtype=dtype)
    far[:, 1] = torch.tensor([-1e3, 1e3, float("nan")], dtype=dtype)
    lpi, _ = target_densities(target_id, consts, far)
    assert bool((lpi == -np.inf).all())


N, STEPS, TILE = 512, 3, 256


def test_chain_matches_jax_fused_chain_on_hierarchical():
    """The port's chain (plain version) and the JAX package's fused chain
    kernel in interpret mode on the hierarchical target at d = 32: tpCN
    with nu + d = 37 (gamma_m 18, gamma_odd 1), the affine data transform,
    a 2-layer (16, 16) 8-bin flow, two tiles, three steps, the same
    injected noise; the JAX package's own parity bounds (as
    ``tests/test_torch_chain.py``)."""
    jarch = jnsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=8)
    jparams = jarch.init(jax.random.key(0))
    jparams = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(7), p.shape,
                                               p.dtype), jparams)
    jparams = jax.tree.map(lambda p: p.astype(jnp.float32), jparams)
    tarch = nsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=8)
    tparams = flow_params_from_jax(jparams, dtype="float32")
    nu = 5.0
    gm, go = 37 // 2, 37 % 2
    jp, tp = JHierarchical(D), HierarchicalProblem(D)
    rng = np.random.default_rng(3)
    x0 = tp.draw_initial_samples(rng, N).astype(np.float32)
    jt = JT.AffineTransform(dtype="float32")
    jt.fit(jnp.asarray(x0))
    dt = FM.affine_program(torch.as_tensor(np.array(jt._mean)),
                           torch.as_tensor(np.array(jt._std)))
    jcfg = JFM.ChainConfig(jarch, "tpcn", STEPS, nu=nu,
                           target_acceptance=0.234, adaptation_rate=0.1,
                           gamma_m=gm, gamma_odd=go,
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
    tcfg = FM.ChainConfig(tarch, "tpcn", STEPS, nu=nu, gamma_m=gm,
                          gamma_odd=go)
    assert tcfg.noise_rows == jcfg.noise_rows == D + gm + go + 1
    refs = [torch.as_tensor(np.array(a, dtype=np.float32)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs, tp.kernel_target(),
        data_transform=dt, noise=torch.as_tensor(noise))
    (zj, lqj, lpij, llj, naccj, sj, statsj) = [np.asarray(a) for a in out_j]
    (zt, lqt, lpit, llt, nacct, st, statst) = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < N * STEPS
    np.testing.assert_allclose(zt, zj, atol=2e-4, rtol=0)
    np.testing.assert_allclose(lqt, lqj, atol=2e-3, rtol=0)
    np.testing.assert_allclose(lpit, lpij, atol=2e-3, rtol=0)
    np.testing.assert_allclose(llt, llj, atol=2e-3, rtol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    tau_j, mix_j = JFM.combine_tile_stats(jnp.asarray(statsj), D, TILE)
    tau_t, mix_t = FM.combine_tile_stats(torch.as_tensor(statst), D, TILE)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-4)
    np.testing.assert_allclose(float(mix_t), float(mix_j), rtol=1e-4)


def _wide_pair(dtype):
    """Config 5's flow shape cut to 2 layers, in both packages, weights
    perturbed by 0.1 N(0, 1)."""
    jarch = JCoupling(dims=D, n_layers=2, n_hidden=(128, 128),
                      transformer="rqs", num_bins=8, dtype=dtype)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype), params)
    tarch = Coupling(dims=D, n_layers=2, n_hidden=(128, 128),
                     transformer="rqs", num_bins=8, dtype=dtype)
    return jarch, params, tarch, flow_params_from_jax(params, dtype=dtype)


def test_wide_layout_is_config_2_and_fits():
    """Config 5's flow takes configuration 2 of both kernels at any depth,
    in the wide form: resident part and chunks in shared memory, not
    whole layers (a layer alone is 273 KB)."""
    for layers in (2, 6, 12):
        arch = chip_smoke.hierarchical_flow(layers)
        assert FC.config_id(arch) == 2 and FC.mma_wide(arch)
        assert FM.kernel_supports(FM.ChainConfig(arch, "tpcn", 32))
    arch = chip_smoke.hierarchical_flow()
    size, w1, b1, w2, b2, w3, b3, row, stage, res, chunk = FC.mma_layout(arch)
    assert 4 * size > FC.MAX_SHARED_BYTES
    assert (w1, b1, b2, b3, w2) == (0, 2048, 2176, 2304, 2688) == (
        0, 2048, 2176, 2304, res)
    assert (w3, size, row, stage, chunk) == (19072, 68224, 52, 1888, 4096)
    assert FC.coupling_shared_bytes(arch) == 114688 <= FC.MAX_SHARED_BYTES
    # Two coupling blocks per SM: 228 KB less 1 KB reserved per block.
    assert 2 * (FC.coupling_shared_bytes(arch) + 1024) <= 233472
    assert FM.chain_shared_bytes(arch, 2212) == 189136 <= FC.MAX_SHARED_BYTES
    assert not any(FC.mma_wide(a) for a in (
        Coupling(dims=4, n_hidden=(64, 64)),
        Coupling(dims=4, n_hidden=(64, 64), transformer="affine")))


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_wide_packed_plain_matches_jax(mode):
    """The wide layout (resident sections first, W3 by groups of two
    active dims) read back as the kernels read it, against the JAX
    package's prepare_params and Pallas coupling kernel in interpret mode
    at the JAX package's f32 kernel bound (its kernel computes in float32
    whatever the parameters' dtype): weights packed in float64, and in
    float32 (rounded to TF32 sums). In float64 it is also the plain
    coupling pass to 1e-10: every weight is where the kernels read it."""
    x = np.random.default_rng(4).normal(size=(256, D))
    tol = dict(rtol=1e-3, atol=1e-4)
    for dtype in ("float64", "float32"):
        jarch, params, tarch, tparams = _wide_pair(dtype)
        xs = x.astype(dtype)
        yj, ldj = _pallas_apply(jarch, mode, prepare_params(jarch, params),
                                jnp.asarray(xs), interpret=True)
        packed = FC.prepare_mma_params(tarch, tparams)
        assert packed.numel() == 2 * FC.mma_layout(tarch)[0]
        yt, ldt = FC.coupling_packed_plain(tarch, mode, packed,
                                           torch.as_tensor(xs))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **tol)
        np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), **tol)
        if dtype == "float64":
            plain = (tarch.forward_plain if mode == "forward"
                     else tarch.inverse_plain)
            for a, b in zip((yt, ldt), plain(tparams, torch.as_tensor(xs))):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


SLICE_N, SLICE_STEPS = 2048, 8
SLICE_FLOW = dict(flow_backend="nsf", n_layers=2, n_hidden=(16, 16))


@pytest.fixture(scope="module")
def jax_fit():
    p = JHierarchical(D)
    init = JSamples(p.draw_initial_samples(np.random.default_rng(7), 4096))
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=D, seed=3, **SLICE_FLOW)
    asp.fit(init, n_epochs=5, batch_size=256)
    return asp


@pytest.mark.parametrize("route", ["fused_kernel", "split"])
def test_slice_log_evidence_matches_jax(jax_fit, route):
    """The pipeline's SMC on the JAX package's fitted flow, carried
    across: the port's log Z (the whole-chain route, and the split chain)
    within max(5 combined sigma, 0.15) of the JAX package's, finite samples
    of the expected shape. Both sit below the quadrature value (PERF.md
    section 7): the comparison is with the reference, not the truth."""
    p = HierarchicalProblem(D)
    jflow = jax_fit.flow
    flow = Flow(dims=D, architecture="nsf", n_layers=2, n_hidden=(16, 16),
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=D, flow=flow, seed=3, device="cpu", **SLICE_FLOW)
    kw = {} if route == "fused_kernel" else {"fused_chain": False}
    post, hist = asp.sample_posterior(
        sampler="smc", n_samples=SLICE_N,
        sampler_kwargs=dict(n_steps=SLICE_STEPS, **kw),
        store_sample_history=False, return_history=True)
    assert hist is asp.sampler.history and not hist.sample_history
    assert set(hist.mutation_route) == {route}
    assert len(hist.mutation_route) == len(hist.beta)
    assert post.x.shape == (SLICE_N, D) and bool(torch.isfinite(post.x).all())
    jpost = jax_fit.sample_posterior(
        sampler="smc", n_samples=SLICE_N,
        sampler_kwargs=dict(n_steps=SLICE_STEPS))
    err, jerr = post.log_evidence_error, float(jpost.log_evidence_error)
    assert np.isfinite(post.log_evidence) and np.isfinite(err)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < max(
        5 * np.hypot(err, jerr), 0.15)


def test_quadrature_log_evidence():
    """The quadrature helper gives the value chip_smoke.py prints as the
    truth, -46.2448, to 1e-3."""
    assert abs(HierarchicalProblem(D).log_evidence_quadrature()
               - QUADRATURE_LOG_Z) < 1e-3
