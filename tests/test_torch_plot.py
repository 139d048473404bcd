"""The port's plots and profiler on matplotlib's Agg backend: every plot of
the histories, the samples and ``plot.py``, drawn from the same data as
the JAX package's and holding the same points, and ``Profiler`` /
``device_trace``."""

import json

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aspire_tpu import history as jhistory  # noqa: E402
from aspire_tpu import plot as jplot  # noqa: E402
from aspire_tpu import samples as jsamples  # noqa: E402
from aspire_tpu_torch import Aspire, Samples  # noqa: E402
from aspire_tpu_torch import history as thistory  # noqa: E402
from aspire_tpu_torch import plot as tplot  # noqa: E402
from aspire_tpu_torch import samples as tsamples  # noqa: E402
from aspire_tpu_torch.models import GaussianProblem  # noqa: E402
from aspire_tpu_torch.profiling import Profiler, device_trace  # noqa: E402

torch.set_num_threads(1)

NAMES = ["a", "b"]


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def run():
    """A small SMC run on the CPU with its sample history."""
    p = GaussianProblem(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, parameters=NAMES, n_hidden=(8, 8), n_layers=2,
                 seed=0, device="cpu")
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            n_epochs=2, batch_size=128)
    post, hist = asp.sample_posterior(sampler="smc", n_samples=256,
                                      return_history=True,
                                      store_sample_history=True,
                                      sampler_kwargs=dict(n_steps=2))
    return post, hist


def _jax_history(hist):
    """The JAX package's history holding the same numbers and snapshots."""
    out = jhistory.SMCHistory(**{
        f: list(getattr(hist, f)) for f in jhistory.SMCHistory.
        __dataclass_fields__ if f != "sample_history"})
    out.sample_history = [jsamples.SMCSamples(
        x=s.x, log_likelihood=s.log_likelihood, log_prior=s.log_prior,
        log_q=s.log_q, beta=s.beta, parameters=s.parameters).to_numpy()
        for s in hist.sample_history]
    return out


def _points(fig):
    """Every line's and scatter's data in a figure, in drawing order."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        out += [np.asarray(c.get_offsets()) for c in ax.collections
                if hasattr(c, "get_offsets")]
    return out


def _same_points(a, b):
    pa, pb = _points(a), _points(b)
    assert len(pa) == len(pb) > 0
    for u, v in zip(pa, pb):
        np.testing.assert_allclose(u, v, rtol=1e-12)


def test_history_plots_match_jax(run):
    _, hist = run
    jh = _jax_history(hist)
    for name in ("plot_beta", "plot_log_norm_ratio", "plot_ess",
                 "plot_ess_target", "plot_eff_target",
                 "plot_mcmc_acceptance", "plot_mcmc_autocorr",
                 "plot_lineage_fraction", "plot"):
        _same_points(getattr(hist, name)(), getattr(jh, name)())
        plt.close("all")
    fig = hist.plot()
    assert len(fig.axes) == 6
    fig, ax = plt.subplots()
    assert hist.plot_beta(ax=ax) is None and len(ax.get_lines()) == 1
    flow = thistory.FlowHistory(training_loss=[3.0, 2.0],
                                validation_loss=[3.5, 2.5])
    _same_points(flow.plot_loss(), jhistory.FlowHistory(
        training_loss=[3.0, 2.0], validation_loss=[3.5, 2.5]).plot_loss())


@pytest.mark.parametrize("x_axis", ["log_p_t", "log_likelihood"])
def test_sample_history_plots_match_jax(run, x_axis):
    _, hist = run
    jh = _jax_history(hist)
    assert len(hist.sample_history) >= 2
    kw = dict(n_samples=64, x_axis=x_axis,
              iterations=[0, len(hist.sample_history) - 1])
    _same_points(hist.plot_sample_history(**kw),
                 jh.plot_sample_history(**kw))
    _same_points(hist.plot_quantile_bands(parameters=["b"]),
                 jh.plot_quantile_bands(parameters=["b"]))
    fig, axes = plt.subplots(2, 1)
    assert hist.plot_sample_history(ax=axes) is None
    with pytest.raises(ValueError, match="Unsupported x_axis"):
        hist.plot_sample_history(x_axis="beta")
    with pytest.raises(ValueError, match="quantile_interval"):
        hist.plot_quantile_bands(quantile_interval=(0.6, 0.9))
    with pytest.raises(ValueError, match="No sample history"):
        thistory.SMCHistory().plot_sample_history()


def test_corner_and_comparison_plots(run):
    post, _ = run
    fig = post.plot_corner()
    assert len(fig.axes) == 4
    x = post.x.numpy()
    _same_points(tplot.corner_plot(x, labels=NAMES, bins=10),
                 jplot.corner_plot(x, labels=NAMES, bins=10))
    smc = tsamples.SMCSamples(x=x, beta=1.0, parameters=NAMES)
    fig = tplot.plot_comparison(post, smc, parameters=["a"],
                                labels=["weighted", "smc"])
    assert len(fig.legends) == 1
    with pytest.raises(ValueError, match="same length"):
        tplot.plot_comparison(post, smc, per_samples_kwargs=[{}])
    hist = run[1]
    fig = tplot.plot_history_comparison(hist, hist)
    assert len(fig.axes) == 6
    with pytest.raises(ValueError, match="mixed types"):
        tplot.plot_history_comparison(hist, thistory.FlowHistory())


def _pt(pkg):
    rng = np.random.default_rng(1)
    return pkg.PTMCMCSamples(
        x=rng.normal(size=(3 * 5 * 4, 2)), chain_shape=(3, 5, 4),
        betas=np.array([1.0, 0.4, 0.0]), parameters=NAMES,
        move_acceptance=np.array([0.3, 0.5, 0.7]),
        swap_acceptance=np.array([0.1, 0.6]))


def test_pt_plots_match_jax():
    t, j = _pt(tsamples), _pt(jsamples)
    _same_points(t.plot_chain(1, n_walkers=2), j.plot_chain(1, n_walkers=2))
    fig = t.plot_ladder()
    _same_points(fig, j.plot_ladder())
    assert fig.axes[0].get_legend() is not None  # the pair below the floor
    t.swap_acceptance = None
    with pytest.raises(ValueError, match="acceptance"):
        t.plot_ladder()


def test_profiler_phases_and_counters():
    prof = Profiler()
    for _ in range(3):
        with prof.phase("mutate"):
            torch.ones(8).sum()
    prof.add("particle_steps", 300.0)
    summary = prof.summary()
    assert summary["mutate"]["count"] == 3
    assert summary["mutate"]["mean_s"] == pytest.approx(
        summary["mutate"]["total_s"] / 3)
    assert summary["counters"] == {"particle_steps": 300.0}
    assert prof.rate("particle_steps", "mutate") == pytest.approx(
        300.0 / summary["mutate"]["total_s"])
    assert prof.rate("particle_steps", "absent") == 0.0
    prof.log_summary()


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert any("cumsum" in n for n in names)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
