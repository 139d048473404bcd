"""The flow kernels' last shape corners against the JAX package, on the CPU.

The corners are the flows the JAX package's kernels take and the port's
older forms left no room for in a block (ROADMAP B9 item 1); the port
takes them now, B1/B3 with one resident part, B2's wide chain at the
levels of its block (``FM.chain_wide_plan``), B4 in its chunked form
(``FC.maf_stream_layout``):

- **Admission**: ``should_fuse``, ``should_fuse_maf`` and
  ``kernel_supports`` against the JAX predicates (its chain spec's rule:
  ``should_fuse`` and a tile dividing n) on every corner named, and on a
  seeded sample of ``tools/shape_scan.py``'s grid. The JAX predicates ask
  for a TPU backend, which the test names for them.
- **The packed passes at a corner per kernel**: the port's packing read as
  its kernels read it (``coupling_packed_plain``, ``maf_packed_plain``)
  against the JAX Pallas kernels in interpret mode, float32, at the JAX
  package's own bound (rtol 1e-3, atol 1e-4).
- **The chain** at d = 26 with 3 x (64, 64) and 32 bins (the wide chain
  with its state in global memory): the port's (its plain version, the
  kernel's on a CPU tensor) against the JAX package's ``fused_mh_chain``
  in interpret mode on injected noise, at the parity bounds of
  ``tests/test_torch_chain.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu.flows.architectures import MAF as JMAF
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu.ops import fused_coupling as JFC
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch.flows.architectures import MAF, Coupling
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)

_SCAN = Path(__file__).resolve().parent.parent / "tools" / "shape_scan.py"
_spec = importlib.util.spec_from_file_location("shape_scan", _SCAN)
shape_scan = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shape_scan)

N = 8192

#: (d, hidden, bins, layers): coupling flows the older forms refused
COUPLING_CORNERS = [
    (32, (128, 128), 20, 6),    # config 5's flow at 20 bins (B2)
    (32, (128, 128), 32, 6),    # and at 32 (B2)
    (32, (512,), 8, 4),         # (B2)
    (26, (64, 64), 32, 3),      # (B2)
    (25, (1024, 1024), 24, 1),  # (B1/B3 and B2)
    (26, (1024, 1024), 24, 1),
    (29, (1024, 1024), 20, 1),
    (30, (1024, 1024), 20, 1),
    (29, (16,), 28, 2),         # the narrowest at each level of B2's block
    (27, (384,), 32, 1),
    (30, (768,), 32, 1),
    (32, (1024,), 32, 1),
]
#: (d, hidden, bins, layers): RQS MAFs the older forms refused
MAF_CORNERS = [
    (4, (256, 256), 20, 4),     # W3 by k-steps
    (15, (512,), 8, 4),
    (4, (192, 192), 32, 2),
    (6, (192,), 28, 2),
    (31, (768,), 2, 1),         # W1 streamed too
    (21, (1024,), 20, 1),
    (32, (1024,), 8, 1),
]


class _Batch:
    """What the port's predicates read of a batch."""

    def __init__(self, n=N, d=4):
        self.is_cuda, self.shape, self.dtype = True, (n, d), torch.float32

    def dim(self):
        return 2


def _jax_takes(monkeypatch, jarch, maf: bool, n: int = N) -> bool:
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x = jax.ShapeDtypeStruct((n, jarch.dims), jnp.float32)
    return (JFC.should_fuse_maf if maf else JFC.should_fuse)(jarch, x)


def _assert_mirrors(monkeypatch, transformer, d, hidden, bins, layers):
    """The port's three predicates against the JAX ones for the flow, as a
    coupling flow (B1/B3; B2 with the chain spec's tile rule) and, RQS, as
    a MAF (B4). Returns what the reference takes."""
    kw = dict(dims=d, n_layers=layers, n_hidden=hidden,
              transformer=transformer, num_bins=bins)
    ref = _jax_takes(monkeypatch, JCoupling(**kw), False)
    arch = Coupling(**kw)
    assert FC.should_fuse(arch, _Batch(d=d)) == ref, kw
    chain = ref and N % FM.TILE == 0
    assert FM.kernel_supports(FM.ChainConfig(arch, "tpcn", 20), 1) == chain, kw
    ref_maf = None
    if transformer == "rqs":
        ref_maf = _jax_takes(monkeypatch, JMAF(**kw), True)
        assert FC.should_fuse_maf(MAF(**kw), _Batch(d=d)) == ref_maf, kw
    return ref, ref_maf


@pytest.mark.parametrize("d,hidden,bins,layers", COUPLING_CORNERS)
def test_coupling_corners_mirror_the_reference(monkeypatch, d, hidden, bins,
                                               layers):
    """Every coupling corner: the reference takes it, and so do B1/B3 and
    B2 (the chain's block at its level)."""
    ref, _ = _assert_mirrors(monkeypatch, "rqs", d, hidden, bins, layers)
    assert ref
    arch = Coupling(dims=d, n_layers=layers, n_hidden=hidden,
                    transformer="rqs", num_bins=bins)
    assert FM.chain_shared_bytes(arch, FM.consts_layout(d)[-1]) <= (
        FC.MAX_SHARED_BYTES)


@pytest.mark.parametrize("d,hidden,bins,layers", MAF_CORNERS)
def test_maf_corners_mirror_the_reference(monkeypatch, d, hidden, bins,
                                          layers):
    """Every MAF corner: the reference takes it, and so does B4, in its
    chunked form (level 1: W3 by k-steps, level 2: W1 streamed too)."""
    kw = dict(dims=d, n_layers=layers, n_hidden=hidden, transformer="rqs",
              num_bins=bins)
    assert _jax_takes(monkeypatch, JMAF(**kw), True)
    arch = MAF(**kw)
    assert FC.should_fuse_maf(arch, _Batch(d=d))
    layout = FC.maf_stream_layout(arch)
    assert layout["level"] >= 1 and layout["warps"] >= 1
    assert FC.maf_shared_bytes(arch) <= FC.MAX_SHARED_BYTES


def test_predicates_mirror_the_reference_on_the_scan_grid(monkeypatch):
    """A seeded sample of ``tools/shape_scan.py``'s grid (d 2-32, 1-3
    hidden layers of its widths, its bins or affine, 1-12 layers): the
    port's predicates are the JAX ones on every flow, the chain's by the
    chain spec's rule; the sample holds flows the reference takes and
    flows it refuses."""
    flows = list(shape_scan.grid())
    rng = np.random.default_rng(27)
    taken = refused = 0
    for i in rng.choice(len(flows), size=240, replace=False):
        transformer, d, hidden, bins, layers = flows[i]
        ref, _ = _assert_mirrors(monkeypatch, transformer, d, hidden,
                                 bins or 8, layers)
        taken, refused = taken + ref, refused + (not ref)
    assert taken > 50 and refused > 10


def test_scan_counts_no_refusal():
    """The scan's own counts over a thinned grid: the reference's flows
    counted, none refused by B1/B3, B2 or B4."""
    counts = shape_scan.scan(show=0, dims=(2, 15, 26, 32),
                             widths=(64, 256, 1024))
    assert counts["coupling_flows"] > 0 and counts["rqs_mafs"] > 0
    assert counts["b1_b3_refused"] == counts["b2_refused"] == 0
    assert counts["b4_refused"] == 0


def _pair(jcls, tcls, **kw):
    jarch = jcls(dtype="float32", **kw)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(1), p.shape,
                                               p.dtype), params)
    return jarch, params, tcls(dtype="float32", **kw), flow_params_from_jax(
        params, dtype="float32")


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_one_resident_part_packing_matches_jax_pallas_interpret(mode):
    """B1/B3's corner (d = 25, one layer of (1024, 1024), 24 bins: the wide
    form with one resident part): the port's packing read as the kernel
    reads it, against the JAX Pallas coupling kernel in interpret mode."""
    jarch, params, tarch, tparams = _pair(
        JCoupling, Coupling, dims=25, n_layers=1, n_hidden=(1024, 1024),
        transformer="rqs", num_bins=24)
    assert FC.mma_shape(tarch)["one_res"]
    x = np.random.default_rng(25).normal(size=(256, 25)).astype(np.float32)
    yj, ldj = JFC._pallas_apply(jarch, mode, JFC.prepare_params(jarch, params),
                                jnp.asarray(x), interpret=True)
    yt, ldt = FC.coupling_packed_plain(
        tarch, mode, FC.prepare_mma_params(tarch, tparams), torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


def test_chunked_maf_packing_matches_jax_pallas_interpret():
    """B4's corner (maf-rqs at d = 4, 4 x (256, 256), 20 bins: the chunked
    form, W3 by k-steps): the port's packing read as the kernel reads it,
    against the JAX Pallas MAF kernel in interpret mode."""
    jarch, params, tarch, tparams = _pair(
        JMAF, MAF, dims=4, n_layers=4, n_hidden=(256, 256),
        transformer="rqs", num_bins=20)
    assert FC.maf_stream_layout(tarch)["level"] == 1
    x = (1.5 * np.random.default_rng(4).normal(size=(256, 4))).astype(
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


def test_wide_chain_corner_matches_jax_fused_chain_injected_noise():
    """The mutation chain (tpCN on the mixture, three steps, 512
    particles) of the coupling flow at d = 26 with 3 x (64, 64) and 32
    bins: the port's against the JAX package's ``fused_mh_chain`` in
    interpret mode, the same uniforms injected."""
    d, n, steps, nu = 26, 512, 3, 5.0
    jarch, jparams, tarch, tparams = _pair(
        JCoupling, Coupling, dims=d, n_layers=3, n_hidden=(64, 64),
        transformer="rqs", num_bins=32)
    assert FM.chain_wide_plan(tarch)["level"] == 1
    gm, go = int(nu + d) // 2, int(nu + d) % 2
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    jcfg = JFM.ChainConfig(jarch, "tpcn", steps, nu=nu,
                           target_acceptance=0.234, adaptation_rate=0.1,
                           gamma_m=gm, gamma_odd=go)
    noise = np.clip(rng.uniform(size=(steps, jcfg.noise_rows, n)), 1e-4,
                    1 - 1e-4).astype(np.float32)
    jprob = JMixture(d)

    def target_td(xt):
        return jprob.log_prior_td(xt), jprob.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(x0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(x0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=FM.TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, "tpcn", steps, nu=nu, gamma_m=gm,
                          gamma_odd=go)
    assert FM.kernel_supports(tcfg, 1)
    refs = [torch.as_tensor(np.array(a)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((n // FM.TILE,), 0.5), *refs,
        GaussianMixtureProblem(d).kernel_target(),
        noise=torch.as_tensor(noise))
    zj, lqj, lpij, llj, naccj, sj, _ = [np.asarray(a) for a in out_j]
    zt, lqt, lpit, llt, nacct, st, _ = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < n * steps
    np.testing.assert_allclose(zt, zj, atol=2e-4, rtol=0)
    for t, j in ((lqt, lqj), (lpit, lpij), (llt, llj)):
        np.testing.assert_allclose(t, j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
