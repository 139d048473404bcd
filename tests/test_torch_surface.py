"""Public members of ``aspire_tpu_torch`` that the JAX package's users call,
against the JAX package (float64): the weighted samples' evidence and its
error, rejection sampling from a numpy seed, the samples' printed
summaries, ``configure_logger`` (and the examples' import lines with the
package name swapped), the transforms' public members, and the public
leftovers (the sampler registry, ``determine_beta``, ``logit``/``sigmoid``,
``apply_preconditioning``, the base ``Problem``, the keyword helpers).

The two-sided surface walk: every public module-level and class-level name
of every module of the JAX package (read with ``ast``) is in the port's
module of the same path, save those in ``NOT_PORTED``, each of which the
port really lacks."""

import ast
import importlib
import logging
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aspire_tpu_torch
from aspire_tpu import samples as JS
from aspire_tpu import transforms as JT
from aspire_tpu.ops import special as JSP
from aspire_tpu.samplers import SAMPLER_REGISTRY as JREGISTRY
from aspire_tpu.samplers.base import Sampler as JSampler
from aspire_tpu.samplers.smc import SMCSampler as JSMCSampler
from aspire_tpu.utils import configure_logger as jconfigure_logger
from aspire_tpu.utils import get_parameter_names as jget_parameter_names
from aspire_tpu.utils import (
    split_kwargs_by_signature as jsplit_kwargs_by_signature,
)
from aspire_tpu_torch import samples as TS
from aspire_tpu_torch import transforms as TT
from aspire_tpu_torch.models.targets import Problem
from aspire_tpu_torch.ops import special as TSP
from aspire_tpu_torch.samplers import SAMPLER_REGISTRY
from aspire_tpu_torch.samplers.base import Sampler
from aspire_tpu_torch.samplers.smc import BetaScheduleError, SMCSampler
from aspire_tpu_torch.utils import (
    get_parameter_names,
    split_kwargs_by_signature,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _dens(n=400, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.normal(-3.0 + shift, 2.0, n),
            rng.normal(-1.0, 0.5, n), rng.normal(-2.0, 1.0, n))


def _pair(n=400, seed=0, shift=0.0):
    x, ll, lp, lq = _dens(n, seed, shift)
    return (JS.Samples(x=jnp.asarray(x), log_likelihood=jnp.asarray(ll),
                       log_prior=jnp.asarray(lp), log_q=jnp.asarray(lq)),
            TS.Samples(x=x, log_likelihood=ll, log_prior=lp, log_q=lq))


# -- C13: the samples -------------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, -60.0])
def test_evidence_and_its_error_match_jax(shift):
    """``evidence`` and ``evidence_error`` as the JAX package sets them in
    ``compute_weights`` (also far below 1, where the error's max-shifted
    form keeps it from underflowing)."""
    js, ts = _pair(shift=shift)
    for name in ("evidence", "evidence_error", "log_evidence",
                 "log_evidence_error"):
        want, got = float(getattr(js, name)), float(getattr(ts, name))
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), name
    assert float(ts.evidence_error) > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_rejection_sample_keeps_the_jax_rows_for_a_numpy_seed(seed):
    js, ts = _pair(seed=seed)
    want = js.rejection_sample(rng=np.random.default_rng(seed))
    got = ts.rejection_sample(rng=np.random.default_rng(seed))
    assert 0 < len(got) < len(ts)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.log_likelihood.numpy(),
                                  np.asarray(want.log_likelihood))
    assert got.log_q is None and isinstance(got, TS.Samples)


def test_rejection_sample_draws_on_the_samples_device():
    _, ts = _pair()
    gen = torch.Generator().manual_seed(5)
    a = ts.rejection_sample(generator=gen)
    b = ts.rejection_sample(generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.x, b.x) and 0 < len(a) < len(ts)
    assert a.x.device == ts.x.device and a.log_q is None


def test_printed_summaries_match_jax():
    """``BaseSamples``, ``Samples`` (weighted, and with an evidence but no
    weights) and ``SMCSamples``, letter for letter."""
    js, ts = _pair()
    assert str(ts) == str(js)
    x = np.random.default_rng(1).normal(size=(10, 2))
    assert str(TS.BaseSamples(x=x)) == str(JS.BaseSamples(x=jnp.asarray(x)))
    for kw in ({}, {"log_evidence": -1.234}, {"log_evidence": -1.234,
                                              "log_evidence_error": 0.0567}):
        assert str(TS.Samples(x=x, **kw)) == str(
            JS.Samples(x=jnp.asarray(x), **kw))
        smc_kw = {k: v for k, v in kw.items() if k == "log_evidence"}
        assert str(TS.SMCSamples(x=x, beta=0.5, **smc_kw)) == str(
            JS.SMCSamples(x=jnp.asarray(x), beta=0.5, **smc_kw))


def test_sample_posterior_logs_the_summary(caplog):
    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, seed=1, device="cpu", flow_backend="nsf",
                 n_hidden=(8, 8), n_layers=2)
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 256)),
            n_epochs=1, batch_size=128)
    with caplog.at_level(logging.INFO, logger="aspire_tpu_torch"):
        post = asp.sample_posterior(n_samples=64)
    assert "Sampled 64 samples from the posterior" in caplog.text
    assert f"Sample summary:\n{post}" in caplog.text


# -- C14: the logger ---------------------------------------------------------


def _configured(configure, name, tmp_path, **kw):
    """What ``configure`` sets up; every logger it touched restored after
    (the JAX package's ecosystem rule also reaches ``aspire_tpu_torch``)."""
    logger = logging.getLogger(name)
    eco = logging.getLogger(f"{name}_plugin")
    eco.propagate = False
    eco.setLevel(logging.NOTSET)
    touched = {n: (logging.getLogger(n).level, logging.getLogger(n).propagate)
               for n in list(logging.root.manager.loggerDict)
               if n.startswith(f"{name}_")}
    saved = (list(logger.handlers), logger.level)
    try:
        out = configure("debug", log_file=str(tmp_path / f"{name}.log"),
                        **kw)
        handlers = [(type(h).__name__, h.level) for h in
                    out.handlers[len(saved[0]):]]
        return (out is logger, out.level, handlers,
                (eco.propagate, eco.level))
    finally:
        for h in logger.handlers[len(saved[0]):]:
            h.close()
        logger.handlers[:] = saved[0]
        logger.setLevel(saved[1])
        for n, (level, propagate) in touched.items():
            logging.getLogger(n).setLevel(level)
            logging.getLogger(n).propagate = propagate


@pytest.mark.parametrize("include_ecosystem", [True, False])
def test_configure_logger_matches_jax(tmp_path, include_ecosystem):
    """The package logger at the level, a stdout stream handler and a file
    handler at it, and (with ``include_ecosystem``) the ``<package>_*``
    loggers set to propagate at the level."""
    want = _configured(jconfigure_logger, "aspire_tpu", tmp_path,
                       include_ecosystem=include_ecosystem)
    got = _configured(aspire_tpu_torch.configure_logger, "aspire_tpu_torch",
                      tmp_path, include_ecosystem=include_ecosystem)
    assert got == want
    assert got[2] == [("StreamHandler", logging.DEBUG),
                      ("FileHandler", logging.DEBUG)]
    assert got[3] == ((True, logging.DEBUG) if include_ecosystem
                      else (False, logging.NOTSET))
    assert "configure_logger" in aspire_tpu_torch.__all__


@pytest.mark.parametrize("example", sorted(
    p.name for p in (ROOT / "examples").glob("*.py")))
def test_example_imports_run_on_the_port(example):
    """Each example's import lines of the JAX package, with the package
    name swapped for the port's, execute."""
    lines = [line for line in (ROOT / "examples" / example).read_text(
        ).splitlines() if re.match(r"(from|import) aspire_tpu\b", line)]
    assert lines
    code = "\n".join(re.sub(r"\baspire_tpu\b", "aspire_tpu_torch", line)
                     for line in lines)
    exec(compile(code, example, "exec"), {})


# -- C15: the transforms -----------------------------------------------------


PARAMS = ["a", "b", "c", "d"]
BOUNDS = {"a": [-2.0, 3.0], "b": [0.0, 1.0], "c": [-np.inf, np.inf],
          "d": [0.0, 2 * np.pi]}


@pytest.mark.parametrize("bounded", [True, False])
def test_composite_members_match_jax(bounded):
    kw = dict(parameters=PARAMS, prior_bounds=BOUNDS, periodic_parameters=[
        "d"], bounded_to_unbounded=bounded, dtype="float64")
    jt, tt = JT.CompositeTransform(**kw), TT.CompositeTransform(**kw)
    assert tt.prior_bounds == jt.prior_bounds
    for name in ("periodic_mask", "bounded_mask"):
        got = getattr(tt, name)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jt, name)))


def test_class_members_match_jax():
    for name in ("PeriodicTransform", "BoundedTransform", "ProbitTransform",
                 "LogitTransform", "AffineTransform"):
        jc, tc = getattr(JT, name), getattr(TT, name)
        assert (tc.name, tc.requires_prior_bounds) == (
            jc.name, jc.requires_prior_bounds), name


def test_interval_check_and_affine_jacobian_match_jax():
    for jt, tt in ((JT.LogitTransform([-2.0], [3.0], dtype="float64"),
                    TT.LogitTransform([-2.0], [3.0], dtype="float64")),
                   (JT.ProbitTransform([0.0], [1.0], dtype="float64"),
                    TT.ProbitTransform([0.0], [1.0], dtype="float64"))):
        tt.interval_check(torch.tensor([0.0]), torch.tensor([1.0]))
        for t, arr in ((jt, jnp.asarray), (tt, torch.tensor)):
            with pytest.raises(ValueError, match="too small"):
                t.interval_check(arr([1.0, 2.0]), arr([1.5, 2.0]))
    x = np.random.default_rng(2).normal([1.0, -3.0], [0.5, 4.0], (300, 2))
    ja, ta = JT.AffineTransform(dtype="float64"), TT.AffineTransform(
        dtype="float64")
    ja.fit(jnp.asarray(x))
    ta.fit(torch.as_tensor(x))
    assert float(ta.log_abs_det_jacobian) == pytest.approx(
        float(ja.log_abs_det_jacobian), rel=1e-13)
    assert torch.equal(ta.forward(torch.as_tensor(x))[1],
                       ta.log_abs_det_jacobian.expand(300))


# -- the public leftovers ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(JREGISTRY))
def test_get_sampler_class_is_the_registry(name):
    """Every key of the JAX package's registry, by ``Aspire``'s method: the
    port's class of the same name."""
    asp = aspire_tpu_torch.Aspire(log_likelihood=None, log_prior=None,
                                  dims=2, device="cpu")
    cls = asp.get_sampler_class(name.upper())
    assert cls is SAMPLER_REGISTRY[name]
    assert cls.__name__ == JREGISTRY[name].__name__
    assert sorted(SAMPLER_REGISTRY) == sorted(JREGISTRY)


def _schedule_sampler(cls, **kw):
    """The JAX package's ``test_smc_schedule`` stand-in: only what the beta
    schedule reads."""
    s = cls.__new__(cls)
    s.adaptive = kw.pop("adaptive", True)
    s.adaptive_min_beta_step = kw.pop("adaptive_min_beta_step", False)
    s._adaptive_target_efficiency = False
    s.target_efficiency_rate = 1.0
    s.target_efficiency = kw.pop("target_efficiency", 0.5)
    return s


#: (sampler settings, delta's scale, beta, determine_beta's keywords)
SCHEDULES = {
    "bisection": ({}, 3.0, 0.1, dict(beta_step=0.1, min_beta_step=1e-6)),
    "floor rescaled": ({"adaptive_min_beta_step": True}, 3.0, 0.2,
                       dict(beta_step=0.1, min_beta_step=0.01)),
    "clamp": ({}, 0.01, 0.0, dict(beta_step=0.1, min_beta_step=1e-6,
                                  max_beta_step=0.25)),
    "fixed step": ({"adaptive": False}, 1.0, 0.3,
                   dict(beta_step=0.25, min_beta_step=1e-6)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_determine_beta_matches_jax(case):
    settings, scale, beta, kw = SCHEDULES[case]
    delta = np.random.default_rng(7).normal(0.0, scale, 5000)
    want = _schedule_sampler(JSMCSampler, **settings).determine_beta(
        jnp.asarray(delta), beta, **kw)
    got = _schedule_sampler(SMCSampler, **settings).determine_beta(
        torch.as_tensor(delta), beta, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_determine_beta_stall_raises():
    delta = torch.zeros(1000, dtype=torch.float64)
    delta[0] = 1e10
    with pytest.raises(BetaScheduleError):
        _schedule_sampler(SMCSampler).determine_beta(
            delta, 0.5, beta_step=0.1, min_beta_step=0.0)


@pytest.mark.parametrize("eps", [None, 1e-6])
def test_logit_and_sigmoid_match_jax(eps):
    x = np.concatenate([[0.0, 1.0], np.random.default_rng(8).uniform(
        size=100)])
    want = np.asarray(JSP.logit(jnp.asarray(x), eps=eps))
    got = TSP.logit(torch.as_tensor(x), eps=eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    z = np.random.default_rng(9).normal(0.0, 5.0, 100)
    np.testing.assert_allclose(TSP.sigmoid(torch.as_tensor(z)).numpy(),
                               np.asarray(JSP.sigmoid(jnp.asarray(z))),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("with_transform", [False, True])
def test_apply_preconditioning_matches_jax(with_transform):
    x = np.random.default_rng(10).uniform(-1.0, 3.0, (200, 4))
    kw = dict(parameters=PARAMS, prior_bounds={**BOUNDS, "c": [-1.0, 4.0]},
              periodic_parameters=["d"], bounded_to_unbounded=True,
              affine_transform=True, dtype="float64")
    jt = JT.CompositeTransform(**kw) if with_transform else None
    tt = TT.CompositeTransform(**kw) if with_transform else None
    if with_transform:
        jt.fit(jnp.asarray(x))
        tt.fit(torch.as_tensor(x))
    want = JSampler.apply_preconditioning(
        types.SimpleNamespace(preconditioning_transform=jt), x)
    got = Sampler.apply_preconditioning(
        types.SimpleNamespace(preconditioning_transform=tt),
        torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["log_likelihood", "log_prior",
                                    "draw_initial_samples"])
def test_base_problem_methods_raise(method):
    args = ((np.random.default_rng(0), 4) if method == "draw_initial_samples"
            else (None,))
    with pytest.raises(NotImplementedError):
        getattr(Problem(dims=2), method)(*args)


def _routed(a, b=1, *, c=2):
    return a, b, c


def _routed_any(a, **kwargs):
    return a, kwargs


@pytest.mark.parametrize("fn", [_routed, _routed_any])
def test_split_kwargs_by_signature_matches_jax(fn):
    kwargs = dict(b=3, c=4, d=5)
    assert split_kwargs_by_signature(fn, kwargs) == \
        jsplit_kwargs_by_signature(fn, kwargs)


@pytest.mark.parametrize("parameters", [None, ["a", "b"], ["a"]])
def test_get_parameter_names_matches_jax(parameters):
    try:
        want = jget_parameter_names(2, parameters)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            get_parameter_names(2, parameters)
    else:
        assert get_parameter_names(2, parameters) == want


# -- the two-sided surface ---------------------------------------------------


JAX_ROOT = ROOT / "aspire_tpu"
_TD = {f"models.targets:{cls}.{m}" for cls in (
    "Problem", "GaussianProblem", "GaussianMixtureProblem",
    "RosenbrockProblem", "FunnelProblem", "HierarchicalProblem")
       for m in ("log_likelihood_td", "log_prior_td")}
_PYTREE = {f"transforms:{name}" for name in (
    "BaseTransform.new_instance", "BaseTransform.pytree_aux",
    "BaseTransform.pytree_children", "PeriodicTransform.pytree_children",
    "BoundedTransform.pytree_aux", "BoundedTransform.pytree_children",
    "AffineTransform.pytree_children", "CompositeTransform.new_instance",
    "CompositeTransform.pytree_aux", "CompositeTransform.pytree_children",
    "FlowPreconditioningTransform.pytree_aux",
    "FlowPreconditioningTransform.pytree_children")}
#: JAX package names the port does not have, by ``module:qualified name``
#: (a whole module by its name), with the reason
NOT_PORTED = {
    **{k: "JAX plumbing: the target TD programs, which target ids and user "
          "CUDA sources replace (ROADMAP, Not to port)" for k in _TD},
    **{k: "JAX plumbing: the pytree protocol (ROADMAP, Not to port)"
       for k in _PYTREE},
    "flows.base:Flow.next_key": "JAX plumbing: PRNG key splitting; the "
                                "flow's torch.Generator replaces it",
    "flows.train:TrainConfig.epochs_per_dispatch":
        "JAX plumbing: dispatch chunking (ROADMAP, Not to port)",
    "samplers.base:Sampler.next_key": "JAX plumbing: PRNG key splitting",
    "samplers.base:Sampler.key_impl_name": "JAX plumbing: PRNG impls",
    "samplers.base:Sampler.backend_str": "JAX plumbing: the XLA backend",
    "samplers.base:Sampler.target_is_jittable":
        "JAX plumbing: target_is_capturable replaces it",
    "samplers.base:Sampler.flow_draw_fn": "JAX plumbing: a jitted draw",
    "samplers.smc:SMCSampler.flow_state": "JAX plumbing: traced flow state",
    "samplers.smc:SMCSampler.flow_log_prob_params":
        "JAX plumbing: traced flow state",
    "samplers.smc:SMCSampler.make_tempered_log_prob":
        "JAX plumbing: a jitted closure",
    "samplers.kernels:ChainState.key": "JAX plumbing: a PRNG key",
    "samplers.kernels:EVAL_BASE": "JAX plumbing: traced evaluation counts",
    "samplers.kernels:eval_counter_init":
        "JAX plumbing: traced evaluation counts",
    "samplers.kernels:eval_counter_add":
        "JAX plumbing: traced evaluation counts",
    "samplers.kernels:eval_counter_total":
        "JAX plumbing: traced evaluation counts",
    "utils:asarray": "JAX plumbing: jnp array coercion",
    "utils:default_dtype": "JAX plumbing: the x64 flag",
    "ops.fused_coupling:prepare_params":
        "JAX plumbing: the Pallas kernel's weight stacking",
    "samples:Array": "JAX plumbing: the jax.Array alias",
}


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def public_surface(path: Path) -> dict:
    """``{name: None or the class's public member names}`` of the public
    functions, classes and assigned names at a module's top level."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            members = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(b.name)
                members.update(_assigned(b))
            out[node.name] = {m for m in members if not m.startswith("_")}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        else:
            out.update(dict.fromkeys(_assigned(node)))
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _module_key(path: Path) -> str:
    parts = path.relative_to(JAX_ROOT).with_suffix("").parts
    return ".".join(p for p in parts if p != "__init__")


def _port_module(key: str):
    try:
        return importlib.import_module(
            ".".join(filter(None, ("aspire_tpu_torch", key))))
    except ModuleNotFoundError:
        return None


def _has(obj, name: str) -> bool:
    return hasattr(obj, name) or name in getattr(
        obj, "__dataclass_fields__", {})


def missing_in_port(key: str, path: Path) -> set:
    """The public names of the JAX module at ``path`` that the port's
    module of the same path lacks (``key`` alone for a missing module)."""
    module = _port_module(key)
    if module is None:
        return {key}
    missing = set()
    for name, members in public_surface(path).items():
        if not _has(module, name):
            missing.add(f"{key}:{name}")
            continue
        missing.update(f"{key}:{name}.{m}" for m in members or ()
                       if not _has(getattr(module, name), m))
    return missing


JAX_MODULES = {_module_key(p): p for p in sorted(JAX_ROOT.rglob("*.py"))}


@pytest.mark.parametrize("key", sorted(JAX_MODULES))
def test_every_public_name_is_ported(key):
    missing = missing_in_port(key, JAX_MODULES[key])
    assert missing <= set(NOT_PORTED), sorted(missing - set(NOT_PORTED))


def test_not_ported_names_are_absent():
    """Each ``NOT_PORTED`` entry is a public JAX name the port still lacks:
    the dict shrinks as names are ported."""
    missing = set().union(*(missing_in_port(k, p)
                            for k, p in JAX_MODULES.items()))
    assert set(NOT_PORTED) == missing, sorted(set(NOT_PORTED) ^ missing)
