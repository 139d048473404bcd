"""aspire_tpu_torch mutation chains against the JAX package.

The port's whole-chain wrapper on a CPU tensor (its plain version) runs
with injected noise beside the JAX package's fused chain kernel in Pallas
interpret mode: the same flow, start points, reference, target and
uniforms go into both. Also the chain statistics, the Gaussian
reference, the port's Philox4x32-10 against its published
known-answer vectors, and the chain kernel's packed weights (read back
in float64) against the JAX conditioner and the JAX coupling kernel's
packed layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu import transforms as JT
from aspire_tpu.flows.architectures import nsf as jnsf
from aspire_tpu.flows.nets import apply_mlp as japply_mlp
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu.models import GaussianProblem as JGaussian
from aspire_tpu.ops import fused_coupling as JFC
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch.flows.architectures import nsf
from aspire_tpu_torch.models import GaussianMixtureProblem, GaussianProblem
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.samplers import kernels as K
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)

N, STEPS, TILE = 512, 3, 256


def _flow():
    jarch = jnsf(dims=4, n_layers=2, n_hidden=(16, 16), num_bins=4)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(7), p.shape,
                                               p.dtype), params)
    tarch = nsf(dims=4, n_layers=2, n_hidden=(16, 16), num_bins=4)
    return jarch, params, tarch, flow_params_from_jax(params,
                                                      dtype="float32")


def _run_both(kernel, problem="mixture", affine_dt=False, seed=3):
    jarch, jparams, tarch, tparams = _flow()
    nu, d = 5.0, 4
    k2 = int(round(nu + d))
    gm, go = (k2 // 2, k2 % 2) if kernel == "tpcn" else (0, 0)
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(N, d)).astype(np.float32)
    if problem == "gaussian":
        x0 = x0 + 2.0
    jcfg_kw = dict(nu=nu, target_acceptance=0.234, adaptation_rate=0.1,
                   gamma_m=gm, gamma_odd=go)
    dt = None
    if affine_dt:
        jt = JT.AffineTransform(dtype="float32")
        jt.fit(jnp.asarray(1.3 * x0 + 0.4))
        jcfg_kw["dt_prog"] = JFM.canonicalize_transform(jt, d)
        dt = FM.affine_program(torch.as_tensor(np.array(jt._mean)),
                               torch.as_tensor(np.array(jt._std)))
    jcfg = JFM.ChainConfig(jarch, kernel, STEPS, **jcfg_kw)
    noise = np.clip(rng.uniform(size=(STEPS, jcfg.noise_rows, N)),
                    1e-4, 1 - 1e-4).astype(np.float32)
    jprob, tprob = ((JMixture(4), GaussianMixtureProblem(4))
                    if problem == "mixture" else
                    (JGaussian(4), GaussianProblem(4)))

    def target_td(xt):
        return jprob.log_prior_td(xt), jprob.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(x0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(x0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, kernel, STEPS, nu=nu, gamma_m=gm,
                          gamma_odd=go)
    assert tcfg.noise_rows == jcfg.noise_rows
    refs = [torch.as_tensor(np.array(a)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs, tprob.kernel_target(),
        data_transform=dt, noise=torch.as_tensor(noise))
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


@pytest.mark.parametrize(
    "kernel,problem,affine_dt",
    [("tpcn", "mixture", False), ("pcn", "mixture", False),
     ("rwmh", "mixture", False), ("tpcn", "mixture", True),
     ("tpcn", "gaussian", False)],
)
def test_chain_matches_jax_fused_chain_injected_noise(kernel, problem,
                                                      affine_dt):
    """Two tiles, three steps, at the JAX package's own parity bounds."""
    (zj, lqj, lpij, llj, naccj, sj, statsj), (zt, lqt, lpit, llt, nacct, st,
                                             statst) = _run_both(
        kernel, problem, affine_dt)
    np.testing.assert_array_equal(nacct, naccj)
    np.testing.assert_allclose(zt, zj, atol=2e-4, rtol=0)
    np.testing.assert_allclose(lqt, lqj, atol=2e-3, rtol=0)
    np.testing.assert_allclose(lpit, lpij, atol=2e-3, rtol=0)
    np.testing.assert_allclose(llt, llj, atol=2e-3, rtol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    tau_j, mix_j = JFM.combine_tile_stats(jnp.asarray(statsj), 4, TILE)
    tau_t, mix_t = FM.combine_tile_stats(torch.as_tensor(statst), 4, TILE)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-4)
    np.testing.assert_allclose(float(mix_t), float(mix_j), rtol=1e-4)


def test_combine_tile_stats_matches_jax_f64():
    rng = np.random.default_rng(1)
    stats = rng.normal(size=(6, 17))
    stats[:, 1 + 8:1 + 12] = np.abs(stats[:, 1 + 8:1 + 12])
    tj, mj = JFM.combine_tile_stats(jnp.asarray(stats), 4, 32)
    tt, mt = FM.combine_tile_stats(torch.as_tensor(stats), 4, 32)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-12)
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-12)


def test_chain_statistics_match_jax_f64():
    rng = np.random.default_rng(2)
    x0, s1, c1 = (rng.normal(size=(300, 3)) for _ in range(3))
    s2 = s1**2 + rng.uniform(size=(300, 3))
    for jf, tf, args in (
        (JK.lag1_autocorr_time, K.lag1_autocorr_time, (s1, s2, c1)),
        (JK.chain_mixing_ratio, K.chain_mixing_ratio, (x0, s1, s2)),
    ):
        want = float(jf(*[jnp.asarray(a) for a in args], 7))
        got = float(tf(*[torch.as_tensor(a) for a in args], 7))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_fit_gaussian_reference_matches_jax_f64():
    x = np.random.default_rng(5).normal(size=(400, 4)) @ np.diag(
        [1.0, 2.0, 0.5, 3.0])
    jref = JK.fit_gaussian_reference(jnp.asarray(x))
    tref = K.fit_gaussian_reference(torch.as_tensor(x))
    for a, b in zip(tref, jref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10,
                                   rtol=0)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    def words(c, k):
        ct = [torch.tensor([v], dtype=torch.int64) for v in c]
        return [int(w) for w in FM.philox4x32_10(*ct, *k)]

    assert words((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert words((f, f, f, f), (f, f)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                 (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_chain_equals_injected_philox_stream():
    """With a seed the plain chain draws exactly the uniforms that
    ``philox_uniforms`` gives, and they are on the 2^-23 grid in [0, 1)."""
    _, _, tarch, tparams = _flow()
    cfg = FM.ChainConfig(tarch, "tpcn", STEPS, gamma_m=4, gamma_odd=1)
    x0 = torch.as_tensor(
        np.random.default_rng(0).normal(size=(N, 4)).astype(np.float32))
    ref = K.fit_gaussian_reference(x0)
    target = GaussianMixtureProblem(4).kernel_target()
    step0 = torch.full((N // TILE,), 0.5)
    seed = (123, 456)
    a = FM.fused_mh_chain(cfg, tparams, x0, 0.5, seed, step0, *ref, target)
    noise = torch.stack([FM.philox_uniforms(seed, t, cfg.noise_rows, N, "cpu")
                         for t in range(STEPS)])
    assert float(noise.min()) >= 0.0 and float(noise.max()) < 1.0
    assert torch.equal(noise * 2**23, torch.round(noise * 2**23))
    b = FM.fused_mh_chain(cfg, tparams, x0, 0.5, None, step0, *ref, target,
                          noise=noise)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("step", ["tpcn", "pcn"])
def test_split_chain_keeps_a_gaussian_invariant(step):
    """The per-step chain on N(0, I) from exact draws stays N(0, I)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4000, 3), generator=gen, dtype=torch.float64)
    ref = K.fit_gaussian_reference(x)

    def log_prob(z):
        return -0.5 * (z**2).sum(-1)

    state = K.ChainState(x=x, log_prob=log_prob(x),
                         step_size=torch.tensor(0.5, dtype=torch.float64),
                         n_accept=torch.zeros(4000, dtype=torch.float64))
    fn = K.tpcn_step if step == "tpcn" else K.pcn_step
    final, stats = K.run_chain(
        lambda s: fn(s, gen, log_prob, ref), state, 10)
    assert 0.05 < float(final.n_accept.mean()) / 10 < 1.0
    np.testing.assert_allclose(final.x.mean(0).numpy(), 0.0, atol=0.1)
    np.testing.assert_allclose(final.x.var(0).numpy(), 1.0, atol=0.1)
    assert 1.0 <= float(stats.tau) and 0.0 <= float(stats.mixing) <= 1.0
    assert final.n_evals == 10 * 4000


def _coupling_layout_conditioner(jarch, prepared, layer, x):
    """The spline parameters of layer ``layer``'s active dims, from the JAX
    coupling kernel's packed weights (``prepare_params``: per dense level
    W (L, out, in) and b (L, out, 1); the output level's rows the active
    dims' groups, each P parameters zero-padded to its group size)."""
    d, P = jarch.dims, jarch._n_params_per_dim
    cond = np.array([(i % 2) != (layer % 2) for i in range(d)])
    h = np.where(cond, x, 0.0)
    levels = [np.asarray(a[layer], dtype=np.float64) for a in prepared]
    for j in range(0, len(levels), 2):
        h = h @ levels[j].T + levels[j + 1][:, 0]
        if j + 2 < len(levels):
            h = np.maximum(h, 0.0)
    return h.reshape(x.shape[0], (d + 1) // 2, -1)[:, :, :P]


@pytest.mark.parametrize("hidden,bins", [(64, 8), (16, 4)])
def test_chain_packing_matches_jax_and_the_coupling_layout(hidden, bins):
    """Float64: the chain kernel's packed buffer, read back the way the
    kernel reads it (``chain_conditioner_plain``), gives every layer's
    spline parameters as the JAX ``Coupling``'s conditioner on the same
    weights (carried across by ``flow_params_from_jax``) and as the
    JAX coupling kernel's packed layout (``prepare_params``). The weights
    are float32 values, so the three agree to float64 rounding."""
    jarch = jnsf(dims=4, n_layers=3, n_hidden=(hidden, hidden),
                 num_bins=bins)
    jparams = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(3), p.shape,
                                              p.dtype),
        jarch.init(jax.random.key(0)))
    tarch = nsf(dims=4, n_layers=3, n_hidden=(hidden, hidden),
                num_bins=bins)
    tparams = flow_params_from_jax(jparams, dtype="float64")
    chain_packed = FM.prepare_chain_params(tarch, tparams)
    coupling_packed = JFC.prepare_params(jarch, jparams)
    x = np.random.default_rng(4).normal(size=(200, 4)) * 2.0
    for layer in range(3):
        cond = np.array([(i % 2) != (layer % 2) for i in range(4)])
        want = np.asarray(japply_mlp(
            jparams["layers"][layer],
            jnp.where(cond, jnp.asarray(x), 0.0))).reshape(200, 4, -1)
        want = want[:, ~cond]
        got = FM.chain_conditioner_plain(tarch, chain_packed, layer,
                                         torch.as_tensor(x))
        other = _coupling_layout_conditioner(jarch, coupling_packed, layer,
                                             x)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
        np.testing.assert_allclose(got.numpy(), other, atol=1e-10, rtol=0)


def test_chain_packing_rounds_wide_weights_to_tf32_sums():
    """In float32 every packed W2 and W3 weight is a sum of two TF32 values
    within 2^-21 of the weight (the kernel splits it exactly), and W1 and
    the biases are packed as they are."""
    _, _, tarch, tparams = _flow()
    exact = FM.prepare_chain_params(tarch, chip_smoke.as_float64(tparams))
    packed = FM.prepare_chain_params(tarch, tparams)
    names = [name for name, _ in FM.chain_sections(tarch)]
    layout = FM.chain_layout(tarch)
    for layer in range(tarch.n_layers):
        base = layer * layout[0]
        ends = list(layout[2:7]) + [layout[0]]
        for name, start, end in zip(names, layout[1:7], ends):
            a = packed[base + start:base + end]
            b = exact[base + start:base + end]
            if name in ("w2", "w3"):
                assert torch.equal(FC.split_tf32_sum(a), a)
                np.testing.assert_allclose(a.double().numpy(), b.numpy(),
                                           rtol=2.0**-21, atol=0)
            else:
                assert torch.equal(a.double(), b)
