"""The JAX package's validation rows in the port, on the CPU.

``benchmarks/validate.py`` runs Rosenbrock at d = 2 (on its prior box, so
a logit + affine data transform) and Neal's funnel at d = 5 (affine) with
the nsf-tpu flow. Held here against the JAX package: the two problems,
``get_problem``, their in-kernel target ids, the whole chain on each (the
port's plain version beside the JAX package's fused chain in Pallas
interpret mode, on the same injected noise), the tensor-core packing at
d = 2 and d = 5 (halves padded to (d + 1) / 2 dims with zero padding
slots) read back as the kernels read it, the kernel configuration tables
against ``csrc/common.cuh``, and ``chip_smoke.py``'s copies of the
quadrature truths and its ``combined_log_z``. The chains' flows are cut
to 2 layers of (16, 16) hidden units so the tests stay quick;
``tests/test_torch_validate_slice.py`` runs the rows end to end.
"""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu import transforms as JT
from aspire_tpu.flows.architectures import nsf as jnsf
from aspire_tpu.flows.architectures import nsf_tpu as jnsf_tpu
from aspire_tpu.models import targets as JTG
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.ops.fused_coupling import _pallas_apply, prepare_params
from aspire_tpu.samplers import kernels as JK
from aspire_tpu.samplers.base import combine_replicates as jcombine
from aspire_tpu_torch import Samples
from aspire_tpu_torch.flows.architectures import nsf, nsf_tpu
from aspire_tpu_torch.models import (
    FunnelProblem,
    get_problem,
    target_densities,
)
from aspire_tpu_torch.models.targets import FUNNEL, ROSENBROCK
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

torch.set_num_threads(1)

ROWS = {"rosenbrock": 2, "funnel": 5}
CSRC = Path(__file__).resolve().parent.parent / "aspire_tpu_torch" / "csrc"


def _points(name: str, n: int = 300) -> np.ndarray:
    """The problem's initial draws and a wider spread: Rosenbrock's past
    its box on some points, the funnel's v from -20 to 12."""
    d = ROWS[name]
    rng = np.random.default_rng(11)
    x = get_problem(name, dims=d).draw_initial_samples(rng, n)
    wide = rng.normal(scale=4.0, size=x.shape)
    if name == "funnel":
        wide[:, 0] = np.linspace(-20.0, 12.0, n)
    else:
        wide[::7] *= 2.5
    return np.concatenate([x, wide])


@pytest.mark.parametrize("name", sorted(ROWS))
def test_problems_match_jax_f64(name):
    """The same fields, defaults and bounds, the same initial draws from the
    same generator bit for bit (Rosenbrock's clip to the box less 0.1
    included), and the likelihood and prior equal in float64 inside and
    outside Rosenbrock's box."""
    d = ROWS[name]
    jp, tp = JTG.get_problem(name, dims=d), get_problem(name, dims=d)
    assert vars(type(tp)()) == vars(type(jp)())  # the same defaults
    assert tp.parameters == jp.parameters
    assert tp.prior_bounds == jp.prior_bounds
    assert tp.true_log_evidence is None and jp.true_log_evidence is None
    draws = tp.draw_initial_samples(np.random.default_rng(7), 500)
    np.testing.assert_array_equal(
        draws, jp.draw_initial_samples(np.random.default_rng(7), 500))
    if name == "rosenbrock":
        assert draws.min() >= tp.lower + 0.1 and draws.max() <= tp.upper - 0.1
    x = _points(name)
    view = types.SimpleNamespace(x=torch.as_tensor(x))
    jview = types.SimpleNamespace(x=jnp.asarray(x))
    lp_t, lp_j = tp.log_prior(view).numpy(), np.asarray(jp.log_prior(jview))
    if name == "rosenbrock":
        outside = np.any(np.abs(x) > 5.0, axis=1)
        assert outside.any() and (~outside).any()
        np.testing.assert_array_equal(np.isinf(lp_t), outside)
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(tp.log_likelihood(view).numpy(),
                               np.asarray(jp.log_likelihood(jview)),
                               rtol=1e-12, atol=1e-10)


def test_funnel_neck_is_neg_inf_in_float32():
    """At v = -100, exp(-v) overflows float32: the likelihood is -inf in
    the port's problem, in its in-kernel target (also where the rest is 0,
    0 * inf = NaN -> -inf) and in the JAX package's float32 path."""
    x = np.array([[-100.0, 0.5, -1.0, 2.0, 0.1],
                  [-100.0, 0.0, 0.0, 0.0, 0.0]], dtype=np.float32)
    tp, jp = FunnelProblem(dims=5), JTG.FunnelProblem(dims=5)
    ll_t = tp.log_likelihood(Samples(torch.as_tensor(x)))
    ll_j = np.asarray(jp.log_likelihood(types.SimpleNamespace(
        x=jnp.asarray(x, dtype=jnp.float32))))
    assert ll_t[0] == -np.inf and ll_j[0] == -np.inf
    _, ll_k = target_densities(FUNNEL, tp.kernel_target()[1],
                               torch.as_tensor(x))
    assert bool((ll_k == -np.inf).all())


def test_get_problem_matches_jax():
    for name in ("rosenbrock", "Funnel", "gaussian", "gaussian_mixture",
                 "hierarchical"):
        assert (type(get_problem(name)).__name__
                == type(JTG.get_problem(name)).__name__)
    assert get_problem("funnel", dims=5, scale=2.0).scale == 2.0
    with pytest.raises(ValueError) as port:
        get_problem("banana")
    with pytest.raises(ValueError) as ref:
        JTG.get_problem("banana")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_kernel_target_matches_jax_td(name, dtype):
    """``target_densities`` for ids 4 and 5, the plain version of the chain
    kernel's targets, against the JAX problems' ``log_*_td`` (their fused
    chain's targets): float64 to 1e-10, float32 (constants as the kernel
    gets them) to 1e-5 relative; the constants kept per device, so a
    device ladder captures no host copy."""
    d = ROWS[name]
    jp, tp = JTG.get_problem(name, dims=d), get_problem(name, dims=d)
    target_id, consts = tp.kernel_target()
    assert target_id == {"rosenbrock": ROSENBROCK, "funnel": FUNNEL}[name]
    assert consts.dtype == torch.float32 and consts.shape == (2,)
    assert tp.kernel_target()[1] is consts
    x = _points(name)
    lpi, ll = target_densities(target_id, consts.to(dtype),
                               torch.as_tensor(x, dtype=dtype))
    xt = jnp.asarray(x.T)
    tol = (dict(rtol=1e-12, atol=1e-10) if dtype == torch.float64 else
           dict(rtol=1e-5, atol=1e-4))
    np.testing.assert_allclose(lpi.double().numpy(),
                               np.asarray(jp.log_prior_td(xt))[0], **tol)
    np.testing.assert_allclose(ll.double().numpy(),
                               np.asarray(jp.log_likelihood_td(xt))[0],
                               **tol)


N, STEPS, TILE = 512, 3, 256


def _jax_transform(name, x):
    """The JAX package's data transform for the row, as its ``Aspire``
    makes it, fitted on x in float32, and the port's from it."""
    d = ROWS[name]
    p = JTG.get_problem(name, dims=d)
    jt = JT.FlowTransform(parameters=p.parameters,
                          prior_bounds=p.prior_bounds,
                          bounded_transform="logit", dtype="float32")
    jt.fit(jnp.asarray(x))
    return jt, transform_from_jax(jt, dtype="float32")


@pytest.mark.parametrize("name", sorted(ROWS))
def test_chain_matches_jax_fused_chain(name):
    """The port's chain (plain version) and the JAX package's fused chain
    kernel in interpret mode on each row's target at its d: Rosenbrock at
    d = 2 with its logit + affine program, the funnel at d = 5 with its
    affine one (nu + d = 7 and 10: gamma_m 3, gamma_odd 1 and 5, 0), a
    2-layer (16, 16) 8-bin flow, two tiles, three tpCN steps, the same
    injected noise; the JAX package's own parity bounds (as
    ``tests/test_torch_chain.py``)."""
    d = ROWS[name]
    jarch = jnsf(dims=d, n_layers=2, n_hidden=(16, 16), num_bins=8)
    jparams = jarch.init(jax.random.key(0))
    jparams = jax.tree.map(
        lambda p: (p + 0.1 * jax.random.normal(jax.random.key(7), p.shape,
                                               p.dtype)).astype(jnp.float32),
        jparams)
    tarch = nsf(dims=d, n_layers=2, n_hidden=(16, 16), num_bins=8)
    tparams = flow_params_from_jax(jparams, dtype="float32")
    nu, k2 = 5.0, 5 + d
    rng = np.random.default_rng(3)
    x0 = get_problem(name, dims=d).draw_initial_samples(rng, N).astype(
        np.float32)
    jt, tt = _jax_transform(name, x0)
    jcfg = JFM.ChainConfig(jarch, "tpcn", STEPS, nu=nu,
                           target_acceptance=0.234, adaptation_rate=0.1,
                           gamma_m=k2 // 2, gamma_odd=k2 % 2,
                           dt_prog=JFM.canonicalize_transform(jt, d))
    noise = np.clip(rng.uniform(size=(STEPS, jcfg.noise_rows, N)),
                    1e-4, 1 - 1e-4).astype(np.float32)
    jp = JTG.get_problem(name, dims=d)

    def target_td(xt):
        return jp.log_prior_td(xt), jp.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(x0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(x0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, "tpcn", STEPS, nu=nu, gamma_m=k2 // 2,
                          gamma_odd=k2 % 2)
    assert tcfg.noise_rows == jcfg.noise_rows == d + k2 // 2 + k2 % 2 + 1
    dt = FM.canonicalize_transform(tt, d)
    assert [op for op, _ in dt.ops] == (
        ["logit", "affine"] if name == "rosenbrock" else ["affine"])
    refs = [torch.as_tensor(np.array(a, dtype=np.float32)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(x0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs,
        get_problem(name, dims=d).kernel_target(), data_transform=dt,
        noise=torch.as_tensor(noise))
    (zj, lqj, lpij, llj, naccj, sj, statsj) = [np.asarray(a) for a in out_j]
    (zt, lqt, lpit, llt, nacct, st, statst) = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < N * STEPS
    np.testing.assert_allclose(zt, zj, atol=3e-4, rtol=0)
    for t, j in ((lqt, lqj), (lpit, lpij), (llt, llj)):
        np.testing.assert_allclose(t, j, atol=3e-3, rtol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    tau_j, mix_j = JFM.combine_tile_stats(jnp.asarray(statsj), d, TILE)
    tau_t, mix_t = FM.combine_tile_stats(torch.as_tensor(statst), d, TILE)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-4)
    np.testing.assert_allclose(float(mix_t), float(mix_j), rtol=1e-4)


def _perturbed(d: int, dtype: str):
    """nsf-tpu at d in both packages, its weights perturbed by 0.1."""
    jarch = jnsf_tpu(dims=d, dtype=dtype)
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype),
        jarch.init(jax.random.key(0)))
    return jarch, params, nsf_tpu(d), flow_params_from_jax(params,
                                                          dtype=dtype)


@pytest.mark.parametrize("d,mode", [(2, "forward"), (5, "forward"),
                                    (5, "inverse")])
def test_packing_reads_back_like_jax(d, mode):
    """The packed layout at d = 2 (one dim a half) and d = 5 (halves padded
    to 3 dims; the output layer by dims) read back in float64 as the
    kernels read it, against the JAX package's prepare_params and Pallas
    coupling kernel in interpret mode at its f32 kernel bound (its kernel
    computes in float32), and against the plain pass to 1e-10: every
    weight is where the kernels read it. The padding slots' weights are
    zero: W1's column for the conditioning slot of even layers, W3's and
    b3's group for the active slot of odd layers."""
    xs = np.random.default_rng(4).normal(size=(256, d)) * 1.5
    jarch, params, tarch, tparams = _perturbed(d, "float64")
    yj, ldj = _pallas_apply(jarch, mode, prepare_params(jarch, params),
                            jnp.asarray(xs), interpret=True)
    packed = FC.prepare_mma_params(tarch, tparams)
    assert packed.numel() == 3 * FC.mma_layout(tarch)[0]
    yt, ldt = FC.coupling_packed_plain(tarch, mode, packed,
                                       torch.as_tensor(xs))
    tol = dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **tol)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), **tol)
    plain = tarch.forward_plain if mode == "forward" else tarch.inverse_plain
    for a, b in zip((yt, ldt), plain(tparams, torch.as_tensor(xs))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    size, w1, b1, w2, b2, w3, b3, row, stage, res, chunk = FC.mma_layout(
        tarch)
    half, g = FC.mma_half(tarch), FC.mma_group(tarch)
    assert half == (d + 1) // 2 and (res, chunk) == (0, 0)
    assert not FC.mma_wide(tarch)
    assert row == half * g + 4 and stage == 32 * row
    layers = packed.reshape(tarch.n_layers, size)
    if d == 5:
        for layer in range(tarch.n_layers):
            w1_l = layers[layer, w1:b1].reshape(64, half)
            w3_l = layers[layer, w3:b3]
            b3_l = layers[layer, b3:b3 + half * g].reshape(half, g)
            if layer % 2 == 0:
                assert bool((w1_l[:, -1] == 0).all())
                assert bool((w1_l[:, :-1] != 0).any())
            else:
                assert bool((b3_l[-1] == 0).all())
                dense = torch.zeros(64, half * g, dtype=packed.dtype)
                rows, cols = FC._mma_fragment_indices(tarch, "cpu")[1]
                dense[rows, cols] = w3_l.reshape(-1, 32, 2)
                assert bool((dense[:, -g:] == 0).all())
                assert bool((dense[:, :-g] != 0).any())


def _table(macro: str) -> list[tuple]:
    """The rows ``X(...)`` of ``macro`` in csrc/common.cuh, each value
    read (the hidden widths, in parentheses, as a tuple)."""
    from aspire_tpu_torch.ops import _build

    return _build.config_rows(macro)


def test_config_tables_mirror_common_cuh():
    """``KERNEL_CONFIGS`` is ``ASPIRE_COUPLING_CONFIGS`` and
    ``CHAIN_CONFIGS`` is ``ASPIRE_CHAIN_CONFIGS`` with the targets its
    TARGETS column compiles (chain.cu ``kLastTarget``): ids 1-3 at
    d = 4 and d = 32, 1-5 at the validation rows' d = 2 and d = 5."""
    coupling = {}
    for cid, d, hidden, k, rqs in _table("ASPIRE_COUPLING_CONFIGS"):
        key = ("rqs" if rqs else "affine", d, hidden, k if rqs else None)
        coupling[key] = cid
    assert coupling == FC.KERNEL_CONFIGS
    chain = {cid: tuple(range(1, (3, 5)[targets] + 1))
             for cid, *_, targets in _table("ASPIRE_CHAIN_CONFIGS")}
    assert chain == FM.CHAIN_CONFIGS
    last = re.search(r"kLastTarget\[2\] = \{(\w+), (\w+)\}",
                     (CSRC / "chain.cu").read_text()).groups()
    assert last == ("kHierarchical", "kFunnel")
    for d, cid in ((2, 3), (5, 4)):
        arch = nsf_tpu(d)
        assert FC.config_id(arch) == cid
        cfg = FM.ChainConfig(arch, "tpcn", 20)
        assert FM.kernel_supports(cfg, ROSENBROCK)
        assert FM.kernel_supports(cfg, FUNNEL)
        assert FC.coupling_shared_bytes(arch) <= FC.MAX_SHARED_BYTES
        assert FM.chain_shared_bytes(
            arch, FM.consts_layout(d)[-1]) <= FC.MAX_SHARED_BYTES
        # Both fit the 2d + 2 target floats of the constant block.
        assert FM.consts_layout(d)[3] - FM.consts_layout(d)[2] >= 2
    # At d = 4 the prebuilt chain compiles ids 1-3; Rosenbrock (4) and the
    # funnel (5) are taken too, on the shape's instance built at first use.
    cfg4 = FM.ChainConfig(nsf_tpu(4), "tpcn", 20)
    assert FM.kernel_supports(cfg4, 2) and FM.kernel_supports(cfg4, 4)
    assert 4 not in FM.CHAIN_CONFIGS[FC.config_id(nsf_tpu(4))]
    assert not FM.kernel_supports(cfg4, 6)


def test_quadrature_copies_equal_validate():
    """``chip_smoke.py``'s copies of the truths equal
    ``benchmarks/validate.py::analytic_log_z`` (-5.8041 and -16.2932 in
    ``benchmarks/RESULTS.md``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "validate", Path(__file__).resolve().parent.parent / "benchmarks"
        / "validate.py")
    validate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(validate)
    rosen = validate.analytic_log_z(JTG.RosenbrockProblem(dims=2))
    funnel = validate.analytic_log_z(JTG.FunnelProblem(dims=5))
    assert abs(chip_smoke.rosenbrock_truth() - rosen) < 1e-9
    assert abs(chip_smoke.funnel_truth() - funnel) < 1e-9
    assert round(rosen, 4) == -5.8041 and round(funnel, 4) == -16.2932


@pytest.mark.parametrize("logzs,errs", [
    ([-16.30, -16.28, -16.31], [0.01, 0.012, 0.011]),
    ([-16.1, -16.5, -16.3], [0.01, 0.01, 0.01]),
])
def test_combine_replicates_copy_matches_jax(logzs, errs):
    """``chip_smoke.combined_log_z`` (the port's ``combine_replicates``,
    which took the place of the script's copy) is the reference's
    arithmetic, in both its branches (a spread within the single-run
    errors, and beyond)."""
    result = types.SimpleNamespace()
    jcombine(result, logzs, errs, "test")
    assert chip_smoke.combined_log_z(logzs, errs, "test") == pytest.approx(
        (result.log_evidence, result.log_evidence_error), rel=1e-12)
