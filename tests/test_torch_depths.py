"""The flow kernels at every hidden depth, against the JAX package, on the
CPU.

The JAX package's kernels take a conditioner of any depth
(``aspire_tpu/ops/fused_coupling.py`` ``prepare_params``,
``_layer_matmuls``, ``_made_matmuls``); so do the port's. Same seeded
weights (the JAX flow's, carried across by
``aspire_tpu_torch.utils.flow_params_from_jax``) and inputs go through
both:

- **The packed passes**: the port's packing read as its kernels read it
  (``coupling_packed_plain``, ``maf_packed_plain``) against the JAX Pallas
  kernels in interpret mode (``_pallas_apply``, ``_pallas_maf_forward``),
  float32, at the JAX package's own bound (rtol 1e-3, atol 1e-4); and the
  port's plain passes against the JAX plain passes in float64 (1e-10).
  One, three and four hidden layers, and none; an odd d; an affine flow.
- **The mutation chain** of a one- and a three-hidden-layer coupling flow
  on injected noise at 1024 particles (the method of
  ``tests/test_torch_chain.py``), the port's against the JAX package's
  ``fused_mh_chain`` in interpret mode.
- **Admission**: ``should_fuse``, ``should_fuse_maf`` and
  ``kernel_supports`` against the JAX predicates over a grid of depths
  0-4 (the JAX predicates ask for a TPU backend, which the test names for
  them).
- **The kill switch** (the JAX package's ``ASPIRE_TPU_FUSED`` read at
  every call, ``ASPIRE_TPU_FUSED_MIN_N`` at import): the predicates and the
  whole-chain dispatch (``_fused_chain_spec``) under it, and
  ``fused_chain=True`` forcing the chain kernel past it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu.flows.architectures import MAF as JMAF
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu.ops import fused_coupling as JFC
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch import Aspire
from aspire_tpu_torch.flows.architectures import MAF, Coupling
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(jcls, tcls, dtype="float32", scale=0.05, **kw):
    jarch = jcls(dtype=dtype, **kw)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + scale * jax.random.normal(jax.random.key(1), p.shape,
                                                p.dtype), params)
    return jarch, params, tcls(dtype=dtype, **kw), flow_params_from_jax(
        params, dtype=dtype)


#: (transformer, d, hidden, bins): coupling flows at depths other than two
COUPLING_CASES = [
    ("rqs", 4, (16,), 8),
    ("rqs", 5, (16, 16, 16), 8),        # odd d
    ("affine", 4, (16, 16, 16), 8),     # affine
    ("rqs", 6, (16, 8, 16, 8), 4),      # four hidden layers
    ("rqs", 5, (), 8),                  # none
]
#: (d, hidden, bins): RQS MAFs at depths other than two
MAF_CASES = [
    (4, (16,), 8),
    (5, (16, 16, 16), 8),
    (6, (16, 16, 8, 16), 4),
    (5, (), 8),
]


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("transformer,d,hidden,bins", COUPLING_CASES)
def test_coupling_packed_plain_matches_jax_pallas_interpret(
        transformer, d, hidden, bins, mode):
    """The port's packing at this depth, read as its kernels read it,
    against the JAX Pallas coupling kernel in interpret mode."""
    jarch, params, tarch, tparams = _pair(
        JCoupling, Coupling, dims=d, n_layers=2, n_hidden=hidden,
        transformer=transformer, num_bins=bins)
    assert FC.coupling_takes(tarch)
    x = np.random.default_rng(d).normal(size=(256, d)).astype(np.float32)
    yj, ldj = JFC._pallas_apply(jarch, mode, JFC.prepare_params(jarch, params),
                                jnp.asarray(x), interpret=True)
    yt, ldt = FC.coupling_packed_plain(
        tarch, mode, FC.prepare_mma_params(tarch, tparams), torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("transformer,d,hidden,bins", COUPLING_CASES)
def test_coupling_plain_matches_jax_f64(transformer, d, hidden, bins):
    """The port's plain passes (the CPU path of every wrapper) against the
    JAX plain passes in float64."""
    jarch, params, tarch, tparams = _pair(
        JCoupling, Coupling, dtype="float64", scale=0.2, dims=d, n_layers=3,
        n_hidden=hidden, transformer=transformer, num_bins=bins)
    x = 2.0 * np.random.default_rng(d).normal(size=(128, d))
    for jfn, tfn in ((jarch.forward, tarch.forward_plain),
                     (jarch.inverse, tarch.inverse_plain)):
        yj, ldj = jfn(params, jnp.asarray(x))
        yt, ldt = tfn(tparams, torch.as_tensor(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-10,
                                   rtol=0)
        np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-10,
                                   rtol=0)


@pytest.mark.parametrize("d,hidden,bins", MAF_CASES)
def test_maf_packed_plain_matches_jax_pallas_interpret(d, hidden, bins):
    """The port's MAF packing at this depth (every hidden product's kept
    blocks in degree order) read as its kernel reads it, against the JAX
    Pallas MAF kernel in interpret mode; and the port's plain pass against
    the JAX plain pass in float64."""
    jarch, params, tarch, tparams = _pair(
        JMAF, MAF, dims=d, n_layers=2, n_hidden=hidden, transformer="rqs",
        num_bins=bins)
    assert FC.maf_takes(tarch)
    x = (1.5 * np.random.default_rng(d).normal(size=(256, d))).astype(
        np.float32)
    zj, ldj = JFC._pallas_maf_forward(
        jarch, JFC.prepare_maf_params(jarch, params), jnp.asarray(x),
        interpret=True)
    z, ld = FC.maf_packed_plain(tarch, FC.prepare_maf_params(tarch, tparams),
                                torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)
    jarch, params, tarch, tparams = _pair(
        JMAF, MAF, dtype="float64", scale=0.2, dims=d, n_layers=2,
        n_hidden=hidden, transformer="rqs", num_bins=bins)
    x64 = 1.5 * np.random.default_rng(d).normal(size=(128, d))
    zj, ldj = jarch.forward(params, jnp.asarray(x64))
    z, ld = tarch.forward_plain(tparams, torch.as_tensor(x64))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), atol=1e-10,
                               rtol=0)


N, STEPS, TILE = 1024, 3, 256


@pytest.mark.parametrize("hidden", [(16,), (16, 16, 16)])
def test_chain_matches_jax_fused_chain_injected_noise(hidden):
    """The mutation chain (tpCN on the mixture, three steps) of a coupling
    flow with one and with three hidden layers: the port's (its plain
    version, the kernel's on a CPU tensor) against the JAX package's
    ``fused_mh_chain`` in interpret mode, the same uniforms injected, at
    the parity bounds of ``tests/test_torch_chain.py``."""
    jarch, jparams, tarch, tparams = _pair(
        JCoupling, Coupling, dims=4, n_layers=2, n_hidden=hidden,
        transformer="rqs", num_bins=4)
    nu, d = 5.0, 4
    gm, go = int(nu + d) // 2, int(nu + d) % 2
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(N, d)).astype(np.float32)
    jcfg = JFM.ChainConfig(jarch, "tpcn", STEPS, nu=nu,
                           target_acceptance=0.234, adaptation_rate=0.1,
                           gamma_m=gm, gamma_odd=go)
    noise = np.clip(rng.uniform(size=(STEPS, jcfg.noise_rows, N)), 1e-4,
                    1 - 1e-4).astype(np.float32)
    jprob = JMixture(4)

    def target_td(xt):
        return jprob.log_prior_td(xt), jprob.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(x0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(x0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, "tpcn", STEPS, nu=nu, gamma_m=gm,
                          gamma_odd=go)
    assert FM.kernel_supports(tcfg, 1)
    refs = [torch.as_tensor(np.array(a)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs,
        GaussianMixtureProblem(4).kernel_target(),
        noise=torch.as_tensor(noise))
    zj, lqj, lpij, llj, naccj, sj, _ = [np.asarray(a) for a in out_j]
    zt, lqt, lpit, llt, nacct, st, _ = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < N * STEPS
    np.testing.assert_allclose(zt, zj, atol=2e-4, rtol=0)
    for t, j in ((lqt, lqj), (lpit, lpij), (llt, llj)):
        np.testing.assert_allclose(t, j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5)


class _Batch:
    """What the port's predicates read of a batch."""

    def __init__(self, n=8192, d=4, dtype=torch.float32, cuda=True):
        self.is_cuda, self.shape, self.dtype = cuda, (n, d), dtype

    def dim(self):
        return 2


def _reference(monkeypatch, jarch, n=8192, maf=False) -> bool:
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x = jnp.zeros((n, jarch.dims), jnp.float32)
    return (JFC.should_fuse_maf if maf else JFC.should_fuse)(jarch, x)


DEPTHS = [(), (48,), (40, 24), (64, 64, 64), (32, 96, 32, 16)]
GRID = [(d, transformer, bins) for d in (2, 7, 16, 32)
        for transformer, bins in (("rqs", 8), ("rqs", 32), ("affine", 8))]


@pytest.mark.parametrize("hidden", DEPTHS, ids=lambda h: f"depth{len(h)}")
def test_predicates_mirror_the_reference_at_every_depth(monkeypatch, hidden):
    """Over d in {2, 7, 16, 32}, 8- and 32-bin splines and affine maps, at
    depths 0-4: ``should_fuse`` is the JAX ``should_fuse``,
    ``kernel_supports`` takes every such flow for the chain (the JAX
    chain takes what ``should_fuse`` takes), the wide chain's 32 bins from
    d = 26 too (its block's state in global memory,
    ``FM.chain_wide_plan``), and ``should_fuse_maf`` is the JAX
    ``should_fuse_maf`` for the RQS MAFs of the grid."""
    for d, transformer, bins in GRID:
        kw = dict(dims=d, n_layers=3, n_hidden=hidden,
                  transformer=transformer, num_bins=bins)
        ref = _reference(monkeypatch, JCoupling(**kw))
        arch = Coupling(**kw)
        assert FC.should_fuse(arch, _Batch(d=d)) == ref, kw
        assert FM.kernel_supports(FM.ChainConfig(arch, "tpcn", 20)) == ref, kw
        ref_maf = _reference(monkeypatch, JMAF(**kw), maf=True)
        assert FC.should_fuse_maf(MAF(**kw), _Batch(d=d)) == ref_maf, kw


def test_the_switch_turns_the_predicates_off(monkeypatch):
    """``ASPIRE_TPU_FUSED=0`` (any value but "1"), read at every call: the
    port's ``should_fuse``, ``should_fuse_maf`` and ``kernel_supports``
    refuse where the JAX predicates do; ``kernel_supports(..., forced=
    True)`` (``fused_chain=True``) takes the chain all the same."""
    coupling = dict(dims=4, n_layers=3, n_hidden=(64, 64, 64),
                    transformer="rqs", num_bins=8)
    for value, on in (("1", True), ("0", False), ("off", False)):
        monkeypatch.setenv("ASPIRE_TPU_FUSED", value)
        ref = _reference(monkeypatch, JCoupling(**coupling))
        ref_maf = _reference(monkeypatch, JMAF(**coupling), maf=True)
        assert ref == ref_maf == on
        assert FC.should_fuse(Coupling(**coupling), _Batch()) == on
        assert FC.should_fuse_maf(MAF(**coupling), _Batch()) == on
        cfg = FM.ChainConfig(Coupling(**coupling), "tpcn", 20)
        assert FM.kernel_supports(cfg, 1) == on
        assert FM.kernel_supports(cfg, 1, forced=True)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_fused_chain_spec_follows_the_switch_as_jax(monkeypatch, switch):
    """The whole-chain dispatch under the switch: with ``fused_chain``
    "auto" the chain kernel only where the switch is on, with True always,
    with False never, exactly where the JAX package's ``_fused_chain_spec``
    (on a TPU backend, as named here) chooses its kernel."""
    monkeypatch.setenv("ASPIRE_TPU_FUSED", switch)
    kw = dict(dims=4, flow_backend="nsf", architecture="nsf-tpu",
              n_hidden=(16, 16, 16), seed=1)
    p, jp = GaussianMixtureProblem(4), JMixture(4)
    jasp = JAspire(log_likelihood=jp.log_likelihood, log_prior=jp.log_prior,
                   parameters=jp.parameters, **kw)
    tasp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  parameters=p.parameters, device="cpu", **kw)
    jasp.init_flow()
    tasp.init_flow()
    x = np.random.default_rng(4).normal(size=(1024, 4)).astype(np.float32)
    jasp.flow.data_transform.fit(jnp.asarray(x))
    tasp.flow.data_transform.fit(torch.as_tensor(x))
    js = jasp.init_sampler("smc", preconditioning="none")
    ts = tasp.init_sampler("smc", preconditioning="none")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for mode in ("auto", True, False):
        jspec = js._fused_chain_spec(dict(fused_chain=mode), 1024, False,
                                     False, None, dtype=jnp.float32)
        tspec = ts._fused_chain_spec(dict(fused_chain=mode), 1024,
                                     torch.float32)
        assert (tspec is None) == (jspec is None), (switch, mode)
        assert (tspec is None) == (mode is False
                                   or (mode == "auto" and switch == "0"))


def test_min_rows_read_at_import_as_jax():
    """``ASPIRE_TPU_FUSED_MIN_N`` sets the row threshold at import, in the
    port as in the JAX package."""
    code = ("import aspire_tpu_torch.ops.fused_coupling as FC; "
            "import aspire_tpu.ops.fused_coupling as J; "
            "print(FC.MIN_FUSED_N, J._MIN_FUSED_N)")
    env = dict(os.environ, ASPIRE_TPU_FUSED_MIN_N="1000",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         check=True, capture_output=True, text=True)
    assert out.stdout.split()[-2:] == ["1000", "1000"]
    assert FC.MIN_FUSED_N == JFC._MIN_FUSED_N
