"""Sharded SMC and data-parallel flow training on gloo ranks (float64, the
CPU) against the one-process run, and the mesh's errors against the JAX
package's.

A sharded run makes the one-process run's draws (each at the whole
population's shape, the rank keeping its rows) and its sums (each over the
gathered whole), so it is held to the one-process run bit for bit: the
betas, log Z, the returned population on every rank and the generator's
state after the run. That is stricter than the JAX package's own sharded
tests (betas rel 1e-5, log Z abs 1e-3), whose GSPMD reductions may sum in
another order. A JAX sharded run is held to its own unsharded run by
``tests/test_parallel.py``; the two unsharded runs are held together by
the earlier slices' tests.

Each rank count (2 and 4) is one job of ``spawn`` processes for the module
that runs every case and saves its results; each test reads one. The rank
function sits here at the top level; JAX is imported by the tests only.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import pytest
import torch

from aspire_tpu_torch.parallel import mesh as M

RANKS = (2, 4)
N = 256
STEPS = 4
FLOW = dict(flow_backend="nsf", n_hidden=(8, 8), n_layers=2)
#: (sampler, resampling_impl, sampler_kwargs) of each sharded case
CASES = {
    "tpcn-auto": ("smc", "auto", {}),
    "tpcn-ring": ("smc", "ring", {}),
    "tpcn-alltoall": ("smc", "alltoall", {}),
    "waste_free-ring": ("smc", "ring", {"waste_free": True}),
    "waste_free-alltoall": ("smc", "alltoall", {"waste_free": True}),
    # 20 walkers spread over the 256 rows: the subset crosses the ranks
    "windowed_tau": ("smc", "auto", {"windowed_tau": True,
                                      "tau_walkers": 20}),
    "flow_moves": ("smc", "auto", {"flow_moves": 5}),
    "mala": ("mala_smc", "auto", {}),
}
#: the final draw's size, which no mesh of 2 or 4 ranks tiles
N_FINAL = 101
#: the data-parallel fit: 520 rows (52 validation, 468 training), global
#: batches of 52, 3 epochs; every count divides by 2 and 4
DP_ROWS, DP_FIT = 520, dict(n_epochs=3, batch_size=52, learning_rate=3e-3)


def fitted_aspire():
    """The 2-d mixture's Aspire on the CPU in float64, a small nsf fitted
    at seed 1: each rank fits its own, the same bits."""
    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, seed=1, device="cpu", dtype="float64", **FLOW)
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            n_epochs=2, batch_size=128, learning_rate=3e-3)
    return asp


def run_case(asp, case: str, mesh=None, **extra) -> dict:
    sampler, impl, kwargs = CASES[case]
    on_mesh = ({} if mesh is None else dict(mesh=mesh,
                                           resampling_impl=impl))
    post, hist = asp.sample_posterior(
        sampler=sampler, n_samples=N, return_history=True,
        device_ladder=False, sampler_kwargs=dict(n_steps=STEPS, **kwargs),
        **on_mesh, **extra)
    s = asp.sampler
    return {"beta": list(hist.beta), "log_z": post.log_evidence,
            "log_z_err": post.log_evidence_error, "x": post.x.clone(),
            "log_l": post.log_likelihood.clone(),
            "generator": s.generator.get_state().clone(),
            "evals": s.n_likelihood_evaluations, "tau": list(
                hist.mcmc_autocorr), "history": len(hist.sample_history),
            "routes": sorted(set(hist.mutation_route))}


def dp_data():
    return np.random.default_rng(3).normal(2.0, 0.5, size=(DP_ROWS, 2))


def dp_flow():
    from aspire_tpu_torch.flows import Flow

    return Flow(dims=2, architecture="nsf", n_hidden=(8, 8), n_layers=2,
                seed=3, dtype="float64", device="cpu")


def _outcome(fn) -> tuple:
    """``(type name, message)`` of what ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - recorded for the test
        return type(err).__name__, str(err)
    return None


def _summary(out) -> dict:
    """What a call returned, for comparing ranks and runs: a run's
    population, log Z, betas and generator, or a fit's parameters."""
    if isinstance(out, dict):
        return out
    if isinstance(out, tuple):  # (samples, history)
        out, hist = out
        return {"x": out.x.clone(), "log_z": out.log_evidence,
                "beta": list(hist.beta)}
    return {"x": out.x.clone(), "log_z": getattr(out, "log_evidence", None)}


def _slice_ii_calls(asp, mesh, folder: str) -> dict:
    """Each call a mesh of more than one rank refused before the second
    multi-device slice, run: its summary and the generator's state, or
    what it raised. ``mesh`` None: the same calls in one process."""
    from aspire_tpu_torch.flows import FlowMatching
    from aspire_tpu_torch.flows.train import param_leaves
    from aspire_tpu_torch.parallel import particle_sharding

    kw = dict(sampler_kwargs=dict(n_steps=STEPS))
    on_mesh = {} if mesh is None else dict(mesh=mesh)
    states = []

    def smc(**sample):
        sampler = asp.init_sampler("smc", **on_mesh)
        post = sampler.sample(N, **kw, **sample)
        out = {"x": post.x.clone(), "log_z": post.log_evidence,
               "beta": list(sampler.history.beta),
               "generator": sampler.generator.get_state().clone()}
        if "store_sample_history" in sample:  # else its defaults differ
            out["history"] = len(sampler.history.sample_history)
        return out

    def facade(sampler, **sample):
        post = asp.sample_posterior(sampler=sampler, n_samples=N,
                                    **on_mesh, **sample)
        return {**_summary(post),
                "generator": asp.sampler.generator.get_state().clone()}

    def cnf_fit():
        flow = FlowMatching(dims=2, device="cpu", dtype="float64",
                            n_hidden=(8, 8), seed=3)
        flow.fit(dp_data(), sharding=None if mesh is None
                 else particle_sharding(mesh), n_epochs=1)
        return {"params": [t.detach().clone()
                           for t in param_leaves(flow.params)]}

    def checkpointed():
        out = smc(checkpoint_callback=states.append)
        return {**out, "iterations": [s["iteration"] for s in states]}

    calls = {
        "device_ladder": lambda: smc(device_ladder=True),
        "checkpoint_every": lambda: smc(
            checkpoint_every=1, checkpoint_file_path=f"{folder}/ck.h5"),
        "checkpoint_callback": checkpointed,
        "store_sample_history": lambda: smc(store_sample_history=True),
        "resume_from": lambda: smc(resume_from=states[1]),
        "emcee_smc": lambda: facade("emcee_smc", **kw),
        "nuts_smc": lambda: facade("nuts_smc", **kw),
        "ptmcmc": lambda: facade("ptmcmc", n_steps=2, n_temperatures=2),
        "minipcn": lambda: facade("minipcn", n_steps=2),
        "emcee": lambda: facade("emcee", n_steps=2),
        "cnf_fit": cnf_fit,
    }
    out = {}
    for name, fn in calls.items():
        try:
            out[name] = fn()
        except Exception as err:  # noqa: BLE001 - recorded for the test
            out[name] = (type(err).__name__, str(err))
    return out


def _rank_job(rank: int, size: int, folder: str) -> None:
    """One rank: every sharded case, and on two ranks the errors, the
    facade's routing and the data-parallel fit; saved to
    ``folder/out{rank}.pt``."""
    torch.set_num_threads(1)
    M.initialize_distributed(num_processes=size, process_id=rank,
                             backend="gloo",
                             init_method=f"file://{folder}/rdv")
    mesh = M.make_mesh(device="cpu")
    asp = fitted_aspire()
    out = {case: run_case(asp, case, mesh) for case in CASES}
    if size == 2:
        # The final draw: N_FINAL does not tile the mesh, so it takes the
        # gather, with the JAX package's debug line.
        lines = []
        handler = logging.Handler(logging.DEBUG)
        handler.emit = lambda record: lines.append(record.getMessage())
        log = logging.getLogger("aspire_tpu_torch")
        level = log.level
        log.setLevel(logging.DEBUG)
        log.addHandler(handler)
        try:
            out["final"] = run_case(asp, "tpcn-ring", mesh,
                                    n_final_samples=N_FINAL)
        finally:
            log.removeHandler(handler)
            log.setLevel(level)
        out["final"]["log"] = [m for m in lines if "does not tile" in m]
        out["routing"] = (asp.sampler.mesh is mesh,
                          asp.sampler.resampling_impl, str(
                              asp.sampler.device))
        out["slice_ii"] = _slice_ii_calls(asp, mesh, folder)
        out["waste_free_tiling"] = _outcome(lambda: asp.init_sampler(
            "smc", mesh=mesh).sample(N, sampler_kwargs=dict(
                n_steps=N, waste_free=True)))
        # A rank whose flow differs: every rank raises.
        leaf = asp.flow.params["layers"][0]["layers"][0]["w"]
        if rank == 1:
            leaf.data[0, 0] += 1e-3
        out["flow_differs"] = _outcome(lambda: run_case(asp, "tpcn-auto",
                                                        mesh))
        from aspire_tpu_torch.parallel import particle_sharding

        flow = dp_flow()
        history = flow.fit(dp_data(), sharding=particle_sharding(mesh),
                           **DP_FIT)
        out["dp_fit"] = ([t.detach().clone() for t in _leaves(flow)],
                         history.training_loss, history.validation_loss)
    torch.save(out, f"{folder}/out{rank}.pt")


def _leaves(flow):
    from aspire_tpu_torch.flows.train import param_leaves

    return param_leaves(flow.params)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The same runs in one process, no mesh."""
    asp = fitted_aspire()
    out = {case: run_case(asp, case) for case in CASES}
    out["final"] = run_case(asp, "tpcn-auto", n_final_samples=N_FINAL)
    flow = dp_flow()
    history = flow.fit(dp_data(), **DP_FIT)
    out["dp_fit"] = ([t.detach().clone() for t in _leaves(flow)],
                     history.training_loss, history.validation_loss)
    out["slice_ii"] = _slice_ii_calls(
        fitted_aspire(), None, str(tmp_path_factory.mktemp("slice_ii")))
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for size in RANKS:
        folder = tmp_path_factory.mktemp(f"mesh_smc{size}")
        M.spawn_ranks(_rank_job, size, (size, str(folder)), timeout=600)
        out[size] = [torch.load(folder / f"out{r}.pt", weights_only=False)
                     for r in range(size)]
    return out


def _same_run(got: dict, want: dict) -> None:
    assert got["beta"] == want["beta"]
    assert abs(got["log_z"] - want["log_z"]) <= 1e-10
    assert got["log_z_err"] == want["log_z_err"]
    assert torch.equal(got["x"], want["x"])
    assert torch.equal(got["log_l"], want["log_l"])
    assert got["evals"] == want["evals"]
    assert got["tau"] == want["tau"]


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_run_equals_one_process(jobs, one_process, case, size):
    """betas, log Z (abs 1e-10; in practice the same bits), the population
    and the evaluation count of the sharded run on every rank are the
    one-process run's; every mutation took the split chain; no sample
    history by default on a mesh of more than one rank."""
    for r in jobs[size]:
        _same_run(r[case], one_process[case])
        assert r[case]["routes"] == ["split"] and r[case]["history"] == 0


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_generators_stay_in_lockstep(jobs, one_process, case, size):
    """After the run every rank's generator is in the one-process run's
    state: no draw was made at a rank's own shape."""
    for r in jobs[size]:
        assert torch.equal(r[case]["generator"],
                           one_process[case]["generator"])


def test_final_draw_that_does_not_tile_takes_the_gather(jobs, one_process):
    """``n_final_samples`` = 101 on two ranks with ``resampling_impl=
    "ring"``: the final draw takes the gather, with the JAX package's debug
    line, and every rank returns the one-process run's 101 rows."""
    for r in jobs[2]:
        assert r["final"]["x"].shape == (N_FINAL, 2)
        _same_run(r["final"], one_process["final"])
        assert r["final"]["log"] == [
            f"n_final_samples ({N_FINAL}) does not tile the 2-device mesh; "
            "the final draw uses the GSPMD gather instead of "
            "resampling_impl='ring'."]


def test_facade_routes_the_mesh_to_the_sampler(jobs):
    """``sample_posterior(mesh=..., resampling_impl=...)`` reaches the SMC
    sampler's constructor (the JAX package's ``tests/test_parallel.py``
    routing test); the sampler's device is the mesh's."""
    assert [r["routing"] for r in jobs[2]] == [(True, "ring", "cpu")] * 2


REFUSED = ("device_ladder", "checkpoint_every", "checkpoint_callback",
           "store_sample_history", "resume_from", "emcee_smc", "nuts_smc",
           "ptmcmc", "minipcn", "emcee", "cnf_fit")


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", REFUSED)
def test_mesh_of_two_refuses_what_waits_for_slice_ii(jobs, one_process,
                                                    name):
    """Each call a mesh of two ranks refused until the second multi-device
    slice (``NotImplementedError``) now runs on two ranks: the same result
    on every rank, and the one-process call's (its population, log Z,
    betas and generator state bit for bit; the CNF's parameters within
    rtol 1e-8); the checkpoints came a rung, the resume from the second
    rung's state, the history a rung and the initial draw."""
    got = [r["slice_ii"][name] for r in jobs[2]]
    want = one_process["slice_ii"][name]
    assert isinstance(got[0], dict), got[0]
    assert _equal(got[0], got[1])
    if name == "cnf_fit":
        for a, b in zip(got[0]["params"], want["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                       atol=1e-10)
        return
    assert _equal(got[0], want), (got[0], want)
    if name == "checkpoint_callback":
        rungs = len(want["beta"])
        assert got[0]["iterations"] == [*range(1, rungs + 1), rungs]
    if name == "store_sample_history":
        assert got[0]["history"] == len(want["beta"]) + 1


def test_waste_free_ancestors_must_tile_the_mesh(jobs):
    """M = n / k ancestors that do not tile the mesh: the JAX package's
    ``ValueError`` (its words, its numbers aside) on every rank, beside
    the JAX package's on its 8-device mesh."""
    import jax

    from aspire_tpu.flows import Flow
    from aspire_tpu.models import GaussianProblem
    from aspire_tpu.parallel.mesh import make_mesh
    from aspire_tpu.samplers import PCNSMC

    p = GaussianProblem(dims=2)
    flow = Flow(dims=2, architecture="maf", key=0, n_layers=2)
    flow.fit(p.draw_initial_samples(np.random.default_rng(7), 400),
             n_epochs=2, batch_size=256)
    sampler = PCNSMC(log_likelihood=p.log_likelihood,
                     log_prior=p.log_prior, dims=2, prior_flow=flow,
                     parameters=p.parameters, rng=jax.random.key(5),
                     mesh=make_mesh(8))
    with pytest.raises(ValueError) as want:
        sampler.sample(256, sampler_kwargs={"n_steps": 64,
                                            "waste_free": True})
    got = [r["waste_free_tiling"] for r in jobs[2]]
    assert got[0] == got[1] and got[0][0] == "ValueError"
    assert got[0][1] == ("waste_free SMC on a mesh shards the M = n/k "
                         "ancestor population: M (1) must be divisible by "
                         "the mesh size (2).")
    assert re.sub(r"\d+", "#", got[0][1]) == re.sub(r"\d+", "#",
                                                     str(want.value))


def test_a_rank_whose_flow_differs_raises(jobs):
    """Rank 1's flow differs in one weight: both ranks raise ``ValueError``
    naming rank 1, before any collective of the run."""
    got = [r["flow_differs"] for r in jobs[2]]
    assert got[0] == got[1]
    assert got[0][0] == "ValueError" and "ranks [1]" in got[0][1]


def test_dp_fit_parameters_are_the_same_on_every_rank(jobs):
    (a, *_), (b, *_) = (r["dp_fit"] for r in jobs[2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dp_fit_matches_the_one_process_fit(jobs, one_process):
    """Two ranks' data-parallel fit (each rank its half of every global
    batch, the gradients averaged) against the one-process fit on the same
    data and seed: the parameters and both loss histories within rtol 1e-8,
    atol 1e-10 after 3 epochs; the loss falls."""
    params, train, val = jobs[2][0]["dp_fit"]
    want_params, want_train, want_val = one_process["dp_fit"]
    for got, want in zip(params, want_params):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_allclose(train, want_train, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(val, want_val, rtol=1e-8, atol=1e-10)
    assert train[-1] < train[0]
