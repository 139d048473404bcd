"""The whole-chain kernel's transform programs against the JAX package.

The port's ``canonicalize_transform`` and ``td_apply`` against the JAX
package's and against the transforms' own maps; ``chain_plain`` with a
bounded data transform and a preconditioning program against the JAX
package's fused chain in Pallas interpret mode on the same injected noise;
the dispatch of ``_fused_chain_spec`` against the JAX package's; and the
bounded slice (``Aspire(prior_bounds=...)``) end to end on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu import transforms as JT
from aspire_tpu.flows.architectures import nsf as jnsf
from aspire_tpu.models import GaussianProblem as JGaussian
from aspire_tpu.ops import fused_mutation as JFM
from aspire_tpu.samplers import kernels as JK
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch import transforms as TT
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.flows.architectures import nsf
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

import jax

torch.set_num_threads(1)

D = 4
NAMES = [f"x_{i}" for i in range(D)]
BOUNDS = {"x_0": [-3.0, 4.0], "x_1": [-5.0, 5.0], "x_2": [0.0, 2 * np.pi],
          "x_3": [-2.5, 6.0]}
KINDS = ["identity", "affine", "logit", "probit", "periodic", "composite",
         "composite_probit", "flow"]


def _x(n=200, seed=0, inside=True):
    """Points inside BOUNDS (or up to a width past them on dim 2, the
    periodic one in the composites)."""
    rng = np.random.default_rng(seed)
    lo = np.array([BOUNDS[p][0] for p in NAMES])
    hi = np.array([BOUNDS[p][1] for p in NAMES])
    u = rng.uniform(0.02, 0.98, size=(n, D))
    x = lo + u * (hi - lo)
    if not inside:
        x[:, 2] += rng.integers(-1, 2, size=n) * 2 * np.pi
    return x


def _pair(kind, dtype="float64"):
    """The same transform in both packages (unfitted)."""
    lo = [BOUNDS[p][0] for p in NAMES]
    hi = [BOUNDS[p][1] for p in NAMES]
    if kind == "identity":
        return JT.IdentityTransform(), TT.IdentityTransform(dtype=dtype)
    if kind == "affine":
        return (JT.AffineTransform(dtype=dtype),
                TT.AffineTransform(dtype=dtype))
    if kind in ("logit", "probit"):
        j, t = ((JT.LogitTransform, TT.LogitTransform) if kind == "logit"
                else (JT.ProbitTransform, TT.ProbitTransform))
        return j(lo, hi, dtype=dtype), t(lo, hi, dtype=dtype)
    if kind == "periodic":
        return (JT.PeriodicTransform(lo, hi, dtype=dtype),
                TT.PeriodicTransform(lo, hi, dtype=dtype))
    kw = dict(parameters=NAMES, prior_bounds=BOUNDS, dtype=dtype)
    if kind == "flow":
        return (JT.FlowTransform(bounded_transform="logit", **kw),
                TT.FlowTransform(bounded_transform="logit", **kw))
    kw.update(periodic_parameters=["x_2"], bounded_transform=(
        "probit" if kind == "composite_probit" else "logit"))
    return JT.CompositeTransform(**kw), TT.CompositeTransform(**kw)


def _fitted(kind, x, dtype="float64"):
    jt, tt = _pair(kind, dtype)
    if kind in ("affine", "composite", "composite_probit", "flow"):
        jt.fit(jnp.asarray(x))
        tt.fit(torch.as_tensor(x))
    return jt, tt


def _jparams(prog):
    return [np.asarray(p, dtype=np.float64).reshape(-1) for p in prog.params]


@pytest.mark.parametrize("kind", KINDS)
def test_canonicalize_matches_jax(kind):
    """The same op list, and parameters equal in float64 (both float32)."""
    jt, tt = _fitted(kind, _x())
    jprog = JFM.canonicalize_transform(jt, D)
    tprog = FM.canonicalize_transform(tt, D)
    assert tprog.ops == jprog.ops
    assert tprog.n_params_per_op == tuple(jprog.n_params_per_op)
    assert len(tprog.params) == len(jprog.params)
    for t, j in zip(tprog.params, _jparams(jprog)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.double().numpy(), j)


def test_canonicalize_refuses_what_jax_refuses():
    """An unfitted affine map inside a composite does not lower in either
    package; an unfitted affine map alone is the identity in both."""
    jt, tt = _pair("composite")
    assert JFM.canonicalize_transform(jt, D) is None
    assert FM.canonicalize_transform(tt, D) is None
    jt, tt = _pair("affine")
    assert JFM.canonicalize_transform(jt, D).ops == ()
    assert FM.canonicalize_transform(tt, D).ops == ()
    assert FM.canonicalize_transform(object(), D) is None


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_td_apply_matches_jax_and_the_transforms_f64(kind, inverse):
    """Float64 points: the port's program on the JAX package's float32
    parameters against the JAX ``td_apply``, the points to 1e-10 and the
    log-Jacobian to 1e-6 (both packages take the log of a float32 width or
    std in float32, and XLA's and torch's float32 log differ in the last
    bit); the port's program in float64 against the transform's own
    ``forward``/``inverse``, both to 1e-10."""
    x = _x(inside=not inverse)
    jt, tt = _fitted(kind, x)
    if inverse:
        x = np.array(jt.forward(jnp.asarray(_x()))[0])
    jprog = JFM.canonicalize_transform(jt, D)
    tprog = FM.canonicalize_transform(tt, D)
    yj, lj = JFM.td_apply(jprog, jprog.params, jnp.asarray(x).T, inverse)
    yt, lt = FM.td_apply(tprog, tprog.params, torch.as_tensor(x), inverse)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj).T, atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj)[0], atol=1e-6,
                               rtol=0)
    prog64 = FM.canonicalize_transform(tt, D, dtype=torch.float64)
    y64, l64 = FM.td_apply(prog64, prog64.params, torch.as_tensor(x),
                           inverse)
    ref = tt.inverse if inverse else tt.forward
    yr, lr = ref(torch.as_tensor(x))
    np.testing.assert_allclose(y64.numpy(), yr.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(l64.numpy(), np.broadcast_to(
        lr.numpy(), l64.shape), atol=1e-10, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_td_apply_round_trip_f32(kind):
    """Float32, at the JAX package's own bounds
    (``tests/test_fused_mutation.py::test_td_apply_matches_transforms``):
    forward against the transform 2e-5 (log-Jacobian 2e-4), then the
    program's inverse of that against the transform's 2e-4."""
    x = _x().astype(np.float32)
    _, tt = _fitted(kind, x, dtype="float32")
    prog = FM.canonicalize_transform(tt, D)
    xt = torch.as_tensor(x)
    y_ref, lj_ref = tt.forward(xt)
    y, lj = FM.td_apply(prog, prog.params, xt, inverse=False)
    torch.testing.assert_close(y, y_ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lj, lj_ref.expand_as(lj), rtol=2e-4,
                               atol=2e-4)
    back, lj_inv = FM.td_apply(prog, prog.params, y, inverse=True)
    back_ref, lj_inv_ref = tt.inverse(y_ref)
    torch.testing.assert_close(back, back_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lj_inv, lj_inv_ref.expand_as(lj_inv),
                               rtol=2e-4, atol=2e-4)


def test_program_block_lays_out_what_the_kernel_reads():
    """The lowered composite (``Prog<D>``): per dimension the op codes
    (periodic on dim 2, logit elsewhere), the bounds and widths, the
    affine mean and std; then the ops present, eps and the log-widths of
    the bounded dims summed. An op out of the kernel's order raises."""
    _, tt = _fitted("composite", _x(), dtype="float32")
    prog = FM.canonicalize_transform(tt, D)
    block = FM.program_block(prog, D, "cpu")
    assert block.shape == (FM.program_floats(D),) == (8 * D + 3,)
    code, p_lo, p_w, b_lo, b_w, b_inv, mean, std = block[:8 * D].reshape(8, D)
    assert code.tolist() == [2, 2, 1, 2]
    lo = torch.tensor([BOUNDS[p][0] for p in NAMES])
    hi = torch.tensor([BOUNDS[p][1] for p in NAMES])
    assert p_lo[2] == lo[2] and p_w[2] == hi[2] - lo[2]
    bounded = [0, 1, 3]
    assert torch.equal(b_lo[bounded], lo[bounded])
    assert torch.equal(b_w[bounded], hi[bounded] - lo[bounded])
    assert torch.equal(b_inv, 1.0 / b_w)
    assert torch.equal(mean, tt._affine_transform._mean)
    assert torch.equal(std, tt._affine_transform._std)
    flags, eps, log_w = block[8 * D:].tolist()
    assert flags == 1 + 2 + 8 and eps == pytest.approx(1e-6)
    assert log_w == pytest.approx(float(torch.log(hi - lo)[bounded].sum()),
                                  rel=1e-6)
    assert FM.program_block(None, D, "cpu")[8 * D] == 0
    backwards = FM.TDProgram(prog.ops[::-1], prog.params,
                             prog.n_params_per_op[::-1])
    with pytest.raises(ValueError):
        FM.program_block(backwards, D, "cpu")


@pytest.mark.parametrize("dt,pc,level", [
    ("identity", None, 0), ("affine", None, 1), ("flow", None, 2),
    ("logit", None, 2), ("periodic", None, 2), ("identity", "affine", 2),
    ("affine", "periodic", 2)])
def test_program_level_picks_the_kernel_instance(dt, pc, level):
    """The kernel instance the wrapper launches (``program_level``): the
    one without programs for no data transform or an affine one alone
    under no preconditioning, the one with programs for anything else."""
    def program(kind):
        return (None if kind is None else FM.canonicalize_transform(
            _fitted(kind, _x(), dtype="float32")[1], D))

    assert FM.program_level(program(dt), program(pc)) == level
    assert FM.program_level(None, None) == 0


# -- chain_plain against the JAX package's fused chain ----------------------

N, STEPS, TILE = 512, 3, 256


def _flow():
    jarch = jnsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=4)
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(7), p.shape,
                                               p.dtype),
        jarch.init(jax.random.key(0)))
    tarch = nsf(dims=D, n_layers=2, n_hidden=(16, 16), num_bins=4)
    return jarch, params, tarch, flow_params_from_jax(params,
                                                      dtype="float32")


def _chain_transforms(program, x):
    """The data transform and preconditioning (JAX, port; fitted on x) of
    ``chip_smoke.bounded_programs``'s ``program``, with bounds at 1.5 times
    x's extent."""
    lo, hi = x.min(0), x.max(0)
    bounds = {p: [float(0.5 * (a + b) - 0.75 * (b - a)),
                  float(0.5 * (a + b) + 0.75 * (b - a))]
              for p, a, b in zip(NAMES, lo, hi)}
    kw = dict(parameters=NAMES, prior_bounds=bounds, dtype="float32")
    periodic = NAMES[:1] if program == "periodic" else []
    bounded = "probit" if program == "probit" else "logit"
    out = []
    for T in (JT, TT):
        dt = T.CompositeTransform(periodic_parameters=periodic,
                                  bounded_transform=bounded, **kw)
        dt.fit(jnp.asarray(x) if T is JT else torch.as_tensor(x))
        pc = None
        if program in ("periodic", "affine_pc"):
            pc = T.CompositeTransform(
                periodic_parameters=periodic, bounded_to_unbounded=False,
                affine_transform=program == "affine_pc", **kw)
        out.append((dt, pc))
    return out


@pytest.mark.parametrize("program", ["logit", "probit", "periodic",
                                     "affine_pc"])
def test_chain_with_programs_matches_jax_fused_chain(program):
    """Two tiles, three tpCN steps on the Gaussian target, the programs of
    each of ``chip_smoke.PROGRAMS``: the plain chain (the wrapper on a CPU
    tensor) against the JAX package's fused chain in interpret mode, on the
    same start points (in the preconditioned space), reference and
    uniforms, at its own bounds: acceptance counts exact, z 3e-4, the
    densities 3e-3."""
    jarch, jparams, tarch, tparams = _flow()
    nu = 5.0
    k2 = int(round(nu + D))
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(N, D)) * 1.5 + 2.0).astype(np.float32)
    (jdt, jpc), (tdt, tpc) = _chain_transforms(program, x)
    z0 = np.array(jpc.fit(jnp.asarray(x))) if jpc is not None else x
    if tpc is not None:
        tpc.fit(torch.as_tensor(x))
    jcfg = JFM.ChainConfig(
        jarch, "tpcn", STEPS, nu=nu, target_acceptance=0.234,
        adaptation_rate=0.1, dt_prog=JFM.canonicalize_transform(jdt, D),
        pc_prog=(JFM.canonicalize_transform(jpc, D) if jpc is not None
                 else None),
        gamma_m=k2 // 2, gamma_odd=k2 % 2)
    noise = np.clip(rng.uniform(size=(STEPS, jcfg.noise_rows, N)),
                    1e-4, 1 - 1e-4).astype(np.float32)
    jprob, tprob = JGaussian(D), GaussianProblem(D)

    def target_td(xt):
        return jprob.log_prior_td(xt), jprob.log_likelihood_td(xt)

    gref = JK.fit_gaussian_reference(jnp.asarray(z0))
    out_j = JFM.fused_mh_chain(
        jcfg, jparams, jnp.asarray(z0), 0.7, seed=jnp.zeros(2, jnp.int32),
        step0=0.5, ref_mean=gref.mean, ref_chol=gref.chol,
        ref_ichol=gref.inv_chol, noise=jnp.asarray(noise), tile=TILE,
        interpret=True, target_td=target_td)
    tcfg = FM.ChainConfig(tarch, "tpcn", STEPS, nu=nu, gamma_m=k2 // 2,
                          gamma_odd=k2 % 2)
    refs = [torch.as_tensor(np.array(a)) for a in gref]
    out_t = FM.fused_mh_chain(
        tcfg, tparams, torch.as_tensor(z0), 0.7, None,
        torch.full((N // TILE,), 0.5), *refs, tprob.kernel_target(),
        data_transform=FM.canonicalize_transform(tdt, D),
        precond=(FM.canonicalize_transform(tpc, D) if tpc is not None
                 else None),
        noise=torch.as_tensor(noise))
    zj, lqj, lpij, llj, naccj, sj, _ = [np.asarray(a) for a in out_j]
    zt, lqt, lpit, llt, nacct, st, _ = [a.numpy() for a in out_t]
    np.testing.assert_array_equal(nacct, naccj)
    assert 0 < nacct.sum() < N * STEPS
    np.testing.assert_allclose(zt, zj, atol=3e-4, rtol=0)
    for t, j in ((lqt, lqj), (lpit, lpij), (llt, llj)):
        np.testing.assert_allclose(t, j, atol=3e-3, rtol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5)


# -- dispatch ---------------------------------------------------------------

PRECONDITIONING = {
    "none": dict(preconditioning="none"),
    "default": {},
    "affine": dict(preconditioning="standard",
                   preconditioning_kwargs=dict(affine_transform=True)),
    "bounded": dict(preconditioning="standard",
                    preconditioning_kwargs=dict(bounded_to_unbounded=True)),
}


@pytest.mark.parametrize("precond", list(PRECONDITIONING))
@pytest.mark.parametrize("data", ["unbounded", "logit", "probit", "periodic",
                                  "unfitted"])
def test_fused_chain_spec_decides_as_jax(data, precond):
    """The whole-chain kernel is chosen exactly where the JAX package
    chooses its own (forced, as off the TPU): for every data transform and
    preconditioning that lower to programs, and for no run whose data
    transform does not (an unfitted affine map)."""
    kw = dict(dims=D, parameters=NAMES, flow_backend="nsf",
              architecture="nsf-tpu", n_hidden=(16, 16), seed=1)
    if data != "unbounded":
        kw["prior_bounds"] = BOUNDS
        kw["bounded_transform"] = "probit" if data == "probit" else "logit"
    if data == "periodic":
        kw["periodic_parameters"] = ["x_2"]
    p = GaussianProblem(D)
    jp = JGaussian(D)
    jasp = JAspire(log_likelihood=jp.log_likelihood,
                   log_prior=jp.log_prior, **kw)
    tasp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  device="cpu", **kw)
    jasp.init_flow()
    tasp.init_flow()
    x = _x(1024, seed=4).astype(np.float32)
    if data != "unfitted":
        jasp.flow.data_transform.fit(jnp.asarray(x))
        tasp.flow.data_transform.fit(torch.as_tensor(x))
    js = jasp.init_sampler("smc", **PRECONDITIONING[precond])
    ts = tasp.init_sampler("smc", **PRECONDITIONING[precond])
    assert (js.preconditioning_transform is None) == (
        ts.preconditioning_transform is None)
    js.fit_preconditioning_transform(jnp.asarray(x))
    ts.fit_preconditioning_transform(torch.as_tensor(x))
    jspec = js._fused_chain_spec(dict(fused_chain=True), 1024, False, False,
                                 js.preconditioning_transform,
                                 dtype=jnp.float32)
    tspec = ts._fused_chain_spec({}, 1024, torch.float32)
    assert (tspec is None) == (jspec is None)
    assert (tspec is None) == (data == "unfitted")


# -- the bounded slice end to end -------------------------------------------

SLICE_N, SLICE_STEPS = 1024, 5
FLOW_KW = dict(flow_backend="nsf", architecture="nsf-tpu", n_hidden=(16, 16))


@pytest.fixture(scope="module")
def bounded_fit():
    p = JGaussian(dims=D)
    init = JSamples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=D, prior_bounds=p.prior_bounds, seed=1, **FLOW_KW)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    return asp


def test_bounded_slice_matches_jax_and_truth(bounded_fit):
    """``Aspire(prior_bounds=...)`` on the bounded Gaussian, the JAX
    package's fitted flow and logit data transform carried across: every
    mutation on the whole-chain kernel (its data transform a logit and an
    affine program), and log Z close to the JAX package's and to
    -4 ln 20."""
    jflow = bounded_fit.flow
    p = GaussianProblem(dims=D)
    flow = Flow(dims=D, architecture="nsf-tpu", n_hidden=(16, 16),
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    prog = FM.canonicalize_transform(flow.data_transform, D)
    assert prog.ops == (("logit", True), ("affine", False))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=D, flow=flow, prior_bounds=p.prior_bounds, seed=1,
                 device="cpu", **FLOW_KW)
    post = asp.sample_posterior(sampler="smc", n_samples=SLICE_N,
                                sampler_kwargs=dict(n_steps=SLICE_STEPS))
    assert set(asp.sampler.history.mutation_route) == {"fused_kernel"}
    assert post.x.shape == (SLICE_N, D) and bool(torch.isfinite(post.x).all())
    err = post.log_evidence_error
    assert abs(post.log_evidence - p.true_log_evidence) < max(5 * err, 0.1)
    jpost = bounded_fit.sample_posterior(
        sampler="smc", n_samples=SLICE_N,
        sampler_kwargs=dict(n_steps=SLICE_STEPS))
    jerr = float(jpost.log_evidence_error)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < 5 * np.hypot(
        err, jerr)


def test_periodic_slice_takes_the_chain_kernel_with_preconditioning():
    """A periodic parameter gives a default preconditioning (a masked
    periodic wrap): the run takes the host ladder, every mutation on the
    whole-chain kernel with that program, and log Z holds the truth."""
    p = GaussianProblem(dims=D)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=D, prior_bounds=p.prior_bounds,
                 periodic_parameters=p.parameters[:1], seed=1, device="cpu",
                 **FLOW_KW)
    asp.fit(init, n_epochs=10, batch_size=256, learning_rate=3e-3)
    post = asp.sample_posterior(sampler="smc", n_samples=SLICE_N,
                                sampler_kwargs=dict(n_steps=SLICE_STEPS))
    sampler = asp.sampler
    assert sampler.ladder is None
    assert FM.canonicalize_transform(sampler.preconditioning_transform,
                                     D).ops == (("periodic", True),)
    assert set(sampler.history.mutation_route) == {"fused_kernel"}
    assert abs(post.log_evidence - p.true_log_evidence) < max(
        5 * post.log_evidence_error, 0.1)
