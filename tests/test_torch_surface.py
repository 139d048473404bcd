"""Public members of ``aspire_tpu_torch`` that the JAX package's users call,
against the JAX package (float64): the weighted samples' evidence and its
error, rejection sampling from a numpy seed, the samples' printed
summaries, ``configure_logger`` (and the examples' import lines with the
package name swapped), and the transforms' public members."""

import logging
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aspire_tpu_torch
from aspire_tpu import samples as JS
from aspire_tpu import transforms as JT
from aspire_tpu.utils import configure_logger as jconfigure_logger
from aspire_tpu_torch import samples as TS
from aspire_tpu_torch import transforms as TT

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
