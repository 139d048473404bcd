"""The device ladder of ``aspire_tpu_torch`` on the CPU: against the host
ladder, against the JAX package's device ladder, its selection rule and
errors, and the pieces the CUDA graph needs (B2's tensor arguments,
targets that make no tensor from host data, the launch counters).

On the CPU the ladder's rung runs eagerly, the plain version of the graph
the card replays; the run draws from the sampler's generator in the host
ladder's order, so both ladders give the same run for one seed.
"""

import logging

import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu.models import GaussianMixtureProblem as JMixture
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.models import (
    GaussianMixtureProblem,
    GaussianProblem,
    HierarchicalProblem,
)
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.ops import prng as PR
from aspire_tpu_torch.ops import resampling as RS
from aspire_tpu_torch.ops import staged_coupling as SC
from aspire_tpu_torch.samplers import smc as TSMC
from aspire_tpu_torch.samplers.smc import BetaScheduleError, PCNSMC
from aspire_tpu_torch.transforms import AffineTransform
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

import chip_smoke

torch.set_num_threads(1)

N, STEPS = 512, 4
SMALL = dict(n_hidden=(16, 16), n_layers=2)
FLOWS = {
    "nsf": dict(flow_backend="nsf", architecture="nsf-tpu", **SMALL),
    "maf-rqs": dict(flow_backend="maf-rqs", **SMALL),
}
HISTORY = ("beta", "ess", "ess_target", "eff_target", "log_norm_ratio",
           "log_norm_ratio_var", "mcmc_acceptance", "mcmc_autocorr",
           "lineage_fraction")


def _problem():
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    return p, init


@pytest.fixture(scope="module")
def fitted():
    """A small nsf-tpu-shaped and maf-rqs flow, each fitted for 3 epochs."""
    p, init = _problem()
    out = {}
    for name, kw in FLOWS.items():
        asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                     dims=4, seed=1, device="cpu", **kw)
        asp.fit(init, n_epochs=3, batch_size=256, learning_rate=3e-3)
        out[name] = asp
    return p, out


def _run(asp, **kw):
    kw.setdefault("store_sample_history", False)
    post, hist = asp.sample_posterior(
        sampler="smc", n_samples=kw.pop("n", N), return_history=True,
        sampler_kwargs=dict(n_steps=STEPS, **kw.pop("chain", {})), **kw)
    return post, hist, asp.sampler


@pytest.mark.parametrize("flow,chain,route", [
    ("nsf", {}, "fused_kernel"),
    ("nsf", {"fused_chain": False}, "split"),
    ("maf-rqs", {}, "split"),
])
def test_device_ladder_repeats_the_host_ladder(fitted, flow, chain, route):
    """One seed, both ladders: the same rungs, history, particles and
    evaluation count (float32 values, rtol 1e-6)."""
    _, asps = fitted
    host, hh, hs = _run(asps[flow], chain=chain, device_ladder=False)
    dev, dh, ds = _run(asps[flow], chain=chain, device_ladder=True)
    assert hs.ladder is None and ds.ladder is not None
    assert dh.mutation_route == hh.mutation_route == [route] * len(hh.beta)
    assert dh.nonfinite_target == hh.nonfinite_target
    assert dh.beta[-1] == 1.0 and len(dh.beta) == len(hh.beta) > 1
    for name in HISTORY:
        np.testing.assert_allclose(getattr(dh, name), getattr(hh, name),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(dev.x.numpy(), host.x.numpy(), rtol=1e-6)
    assert ds.n_likelihood_evaluations == hs.n_likelihood_evaluations
    assert dev.log_evidence == pytest.approx(host.log_evidence, rel=1e-6)


@pytest.fixture(scope="module")
def jax_fit():
    p = JMixture(dims=4)
    init = JSamples(p.draw_initial_samples(np.random.default_rng(42), 2000))
    asp = JAspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=4, seed=1, **FLOWS["nsf"])
    asp.fit(init, n_epochs=5, batch_size=256, learning_rate=3e-3)
    return asp


def test_device_ladder_matches_the_jax_ladder(jax_fit):
    """Both packages' device ladders on one converted flow; their random
    streams differ, so with the JAX package's own bounds
    (``tests/test_integration.py:511-535``)."""
    p = GaussianMixtureProblem(dims=4)
    jflow = jax_fit.flow
    flow = Flow(dims=4, architecture="nsf-tpu", device="cpu",
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"), **SMALL)
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow=flow, seed=1, device="cpu", **FLOWS["nsf"])
    post, hist, sampler = _run(asp, n=1024, device_ladder=True)
    jpost, jhist = jax_fit.sample_posterior(
        sampler="smc", n_samples=1024, preconditioning="none",
        device_ladder=True, return_history=True,
        sampler_kwargs=dict(n_steps=STEPS))
    assert sampler.ladder is not None
    for h in (hist, jhist):
        assert h.beta[-1] == 1.0
        assert len(h.ess) == len(h.beta) == len(h.log_norm_ratio)
    truth = p.true_log_evidence()
    assert post.log_evidence == pytest.approx(truth, abs=0.5)
    assert post.log_evidence == pytest.approx(float(jpost.log_evidence),
                                              abs=0.5)


class _Chose(Exception):
    pass


def _numpy_target(problem):
    def log_likelihood(samples):
        return problem.log_likelihood(samples).numpy()
    return log_likelihood


@pytest.mark.parametrize("capturable", [True, False])
@pytest.mark.parametrize("n", [N, 10_240])
@pytest.mark.parametrize("store", [None, True, False])
@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("adaptive", [True, False])
def test_selection_rule(fitted, monkeypatch, adaptive, preconditioned, store,
                        n, capturable):
    """``device_ladder=None`` takes the device ladder iff the schedule is
    adaptive, there is no preconditioning, no sample history (by default
    kept at n <= 10 000) and a target that can be captured
    (``aspire_tpu/samplers/smc.py:2318-2323``)."""
    p, asps = fitted
    flow = asps["nsf"].flow
    ll = p.log_likelihood if capturable else _numpy_target(p)
    transform = AffineTransform(device="cpu") if preconditioned else None
    sampler = PCNSMC(log_likelihood=ll, log_prior=p.log_prior, dims=4,
                     prior_flow=flow, preconditioning_transform=transform,
                     device="cpu", rng=0)
    small = sampler.draw_initial_samples(256)
    monkeypatch.setattr(sampler, "draw_initial_samples", lambda _: small)

    def chose(what):
        def raise_(*args, **kwargs):
            raise _Chose(what)
        return raise_

    monkeypatch.setattr(sampler, "_run_device_ladder", chose("device"))
    monkeypatch.setattr(TSMC, "iteration_stats", chose("host"))
    with pytest.raises(_Chose) as chosen:
        sampler.sample(n, adaptive=adaptive, n_steps=None if adaptive else 4,
                       store_sample_history=store)
    history = store if store is not None else n <= 10_000
    want = adaptive and not preconditioned and not history and capturable
    assert chosen.value.args[0] == ("device" if want else "host")
    assert sampler.target_is_capturable() is capturable


@pytest.mark.parametrize("case", ["fixed", "preconditioning", "target",
                                  "gamma"])
def test_forced_device_ladder_refuses_what_it_cannot_run(fitted, case):
    """``device_ladder=True`` raises where the ladder cannot run (the JAX
    package's ``test_device_ladder_rejects_unsupported_configs``), and for
    a split tpCN chain whose Gamma variate is drawn by rejection."""
    p, asps = fitted
    flow = asps["nsf"].flow
    kw = dict(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
              dims=4, prior_flow=flow, device="cpu", rng=0)
    run = dict(device_ladder=True, store_sample_history=False)
    match = {"fixed": "adaptive", "preconditioning": "preconditioning",
             "target": "capture", "gamma": "Gamma"}[case]
    if case == "fixed":
        run.update(adaptive=False, n_steps=4)
    elif case == "preconditioning":
        kw["preconditioning_transform"] = AffineTransform(device="cpu")
    elif case == "target":
        kw["log_likelihood"] = _numpy_target(p)
    else:
        run["sampler_kwargs"] = dict(n_steps=2, nu=4.5, fused_chain=False)
    with pytest.raises(ValueError, match=match):
        PCNSMC(**kw).sample(256, **run)


def test_full_buffer_continues_on_the_host_ladder(fitted, caplog):
    """A run that fills ``device_ladder_max_iters`` below beta = 1 warns and
    finishes on the host ladder."""
    _, asps = fitted
    with caplog.at_level(logging.WARNING, logger="aspire_tpu_torch"):
        post, hist, sampler = _run(asps["nsf"], device_ladder=True,
                                   device_ladder_max_iters=1)
    assert "1-iteration buffer" in caplog.text
    assert hist.beta[-1] == 1.0 and len(hist.beta) > 1
    assert len(hist.mutation_route) == len(hist.beta) == len(hist.ess)
    assert sampler.ladder.state["it"].item() == 1
    assert np.isfinite(post.log_evidence)


@pytest.mark.parametrize("min_beta_step,cap", [(0.01, 2), (None, 3)])
def test_max_n_steps_is_a_cumulative_cap(fitted, min_beta_step, cap):
    """``max_n_steps`` caps the rungs of the device ladder and no host
    ladder follows. With a small step floor the cap stops it below
    beta = 1, and the final samples take the last segment to 1; with the
    default floor (``1 / max_n_steps``, adapted each rung) it ends at 1
    within the cap. Both as on the host ladder."""
    _, asps = fitted
    runs = [_run(asps["nsf"], device_ladder=ladder, max_n_steps=cap,
                 min_beta_step=min_beta_step, n_final_samples=256)
            for ladder in (True, False)]
    (dev, dh, ds), (host, hh, _) = runs
    assert ds.ladder is not None
    assert len(dh.beta) == len(hh.beta) <= cap
    np.testing.assert_allclose(dh.beta, hh.beta, rtol=1e-5)
    if min_beta_step is not None:
        assert len(dh.beta) == cap and dh.beta[-1] < 1.0
        assert len(dh.log_norm_ratio) == len(hh.log_norm_ratio) == cap + 1
    else:
        assert dh.beta[-1] == 1.0
    assert dev.x.shape == host.x.shape == (256, 4)


def test_a_stalled_ladder_raises_after_its_history(fitted):
    """A bisection that cannot move beta (tolerance 1, ESS below target at
    beta = 1) stalls the first rung: its diagnostics are in the history,
    then ``BetaScheduleError``."""
    _, asps = fitted
    with pytest.raises(BetaScheduleError, match="stalled"):
        _run(asps["nsf"], device_ladder=True, beta_tolerance=1.0,
             target_efficiency=0.99)
    hist = asps["nsf"].sampler.history
    assert hist.beta == [0.0] and len(hist.ess) == 1


def test_device_ladder_records_sample_history(fitted):
    """``store_sample_history=True`` with the device ladder: the initial
    population and one host snapshot per rung, the last the result."""
    _, asps = fitted
    post, hist, sampler = _run(asps["nsf"], device_ladder=True,
                               store_sample_history=True)
    snaps = hist.sample_history
    assert sampler.ladder is not None
    assert len(snaps) == len(hist.beta) + 1
    for snap, beta in zip(snaps[1:], hist.beta):
        assert isinstance(snap.x, np.ndarray) and snap.x.shape == (N, 4)
        assert snap.beta == pytest.approx(beta)
        assert np.isfinite(snap.log_likelihood).all()
    np.testing.assert_array_equal(snaps[-1].x, post.x.numpy())


def test_chain_plain_takes_tensor_arguments():
    """``beta`` and ``seed`` as tensors (as the device ladder passes them)
    give the Python-number call bit for bit, through the wrapper too."""
    cfg, params, z0, beta, step0, refs, target, dt, _ = (
        chip_smoke.chain_setup(torch.device("cpu"), 512, 3))
    seed = (0x12345678, 0x9ABCDEF0)
    numbers = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                             data_transform=dt, seed=seed)
    tensors = FM.chain_plain(cfg, params, z0, torch.tensor(beta), step0,
                             *refs, target, data_transform=dt,
                             seed=torch.tensor(seed, dtype=torch.int64))
    wrapper = FM.fused_mh_chain(cfg, params, z0, torch.tensor([beta]),
                                torch.tensor(seed), step0, *refs, target,
                                data_transform=dt)
    for a, b, c in zip(numbers, tensors, wrapper):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("problem", [GaussianProblem(4),
                                     GaussianMixtureProblem(4),
                                     HierarchicalProblem(8)],
                         ids=["gaussian", "mixture", "hierarchical"])
def test_targets_make_no_tensor_from_host_data(problem, monkeypatch):
    """After one call on a device, a target's densities make no tensor from
    host data (a pageable host-to-device copy cannot be captured)."""
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(5, problem.dims)), dtype=torch.float32)
    view = Samples(x)
    want = (problem.log_likelihood(view), problem.log_prior(view))

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host data")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    got = (problem.log_likelihood(view), problem.log_prior(view))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device_ladder", [False, True])
def test_kernel_target_is_built_once_per_run(fitted, monkeypatch,
                                             device_ladder):
    p, asps = fitted
    calls = []
    build = p.kernel_target

    def counted(device="cpu"):
        calls.append(device)
        return build(device)

    monkeypatch.setattr(p, "kernel_target", counted)
    _, hist, _ = _run(asps["nsf"], device_ladder=device_ladder)
    assert set(hist.mutation_route) == {"fused_kernel"}
    assert len(hist.beta) > 1 and len(calls) == 1


def test_every_kernel_counter_is_seen_by_the_graph():
    """A CUDA graph adds its captured launches to every wrapper's counter:
    all of them are in ``LaunchCounter.made``, and ``add_launches`` adds
    per counter."""
    counters = [FC.launches, FC.maf_launches, FM.launches,
                SC.interleaved_launches, SC.q_launches, SC.packed_launches,
                PR.launches]
    assert all(any(c is m for m in _build.LaunchCounter.made)
               for c in counters)
    before = _build.launch_counts()
    step = tuple(range(1, len(before) + 1))
    _build.add_launches(step)
    _build.add_launches(step)
    after = _build.launch_counts()
    assert after == tuple(b + 2 * s for b, s in zip(before, step))
    _build.add_launches(tuple(-2 * s for s in step))
    assert _build.launch_counts() == before


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_rowwise_cumsum_is_the_running_sum(n):
    """The fixed-order scan the card's resampling sums its CDF with (rows,
    then the rows' totals) is the running sum, however n falls on the
    rows."""
    w = torch.as_tensor(np.random.default_rng(n).random(n))
    got = RS.rowwise_cumsum(w)
    assert got.shape == (n,)
    torch.testing.assert_close(got, torch.cumsum(w, 0), rtol=1e-12,
                               atol=0)
