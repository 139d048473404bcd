"""The samplers whose moves span the population, on a mesh of gloo ranks
(float64, the CPU), against the one-process run: ``emcee_smc`` (the stretch
move's halves span the ranks: a gather a half-move), ``nuts_smc`` (its
loops end on the whole population's flags), parallel tempering with its
walkers sharded, the standalone tpCN and stretch samplers (every rank runs
the whole ensemble) and the CNF's data-parallel fit; PT's multi-process
rules beside the JAX package's words.

Every run on a mesh is held to the one-process run bit for bit, the
generator's state included (the CNF's fit, whose gradients are averaged
over the ranks, within rtol 1e-8). Each rank count (2 and 4) is one job of
``spawn`` processes for the module; each test reads the saved results.
The rank function sits here at the top level; JAX is imported by the tests
only.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from aspire_tpu_torch.parallel import mesh as M

RANKS = (2, 4)
N = 128
FLOW = dict(flow_backend="nsf", n_hidden=(8, 8), n_layers=2)
#: SMC cases: (sampler, device_ladder, sampler_kwargs)
SMC = {
    "emcee_smc-host": ("emcee_smc", False, dict(n_steps=4)),
    "emcee_smc-device": ("emcee_smc", True, dict(n_steps=4)),
    "nuts_smc": ("nuts_smc", False, dict(n_steps=2, max_depth=3)),
}
#: parallel tempering: walkers a rung (they tile 2 and 4 ranks), rungs,
#: moves and a swap every other move
PT = dict(n_samples=32, n_temperatures=3, n_steps=6, swap_every=2)
#: the standalone samplers, on two ranks
STANDALONE = {"minipcn": dict(n_samples=64, n_steps=5),
              "emcee": dict(n_samples=64, n_steps=5)}
#: the CNF's data-parallel fit: 208 rows (20 validation, 188 training,
#: 184 of them in global batches of 8 a rank), one epoch
CNF_ROWS, CNF_FIT = 208, dict(n_epochs=1, batch_size=8, learning_rate=3e-3)


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


def smc_case(asp, case: str, mesh=None) -> dict:
    sampler, ladder, kwargs = SMC[case]
    on_mesh = {} if mesh is None else dict(mesh=mesh)
    post, hist = asp.sample_posterior(
        sampler=sampler, n_samples=N, return_history=True,
        device_ladder=ladder, target_efficiency=0.8,
        sampler_kwargs=kwargs, **on_mesh)
    s = asp.sampler
    return {"beta": list(hist.beta), "log_z": post.log_evidence,
            "x": post.x.clone(), "log_l": post.log_likelihood.clone(),
            "generator": s.generator.get_state().clone(),
            "evals": s.n_likelihood_evaluations,
            "acc": list(hist.mcmc_acceptance)}


def mcmc_run(asp, sampler: str, mesh=None, **kwargs) -> dict:
    on_mesh = {} if mesh is None else dict(mesh=mesh)
    post = asp.sample_posterior(sampler=sampler, **kwargs, **on_mesh)
    out = {"x": post.x.clone(), "log_l": post.log_likelihood.clone(),
           "generator": asp.sampler.generator.get_state().clone(),
           "evals": asp.sampler.n_likelihood_evaluations}
    for name in ("move_acceptance", "swap_acceptance", "acceptance_rate"):
        if hasattr(post, name):
            out[name] = np.asarray(getattr(post, name))
    return out


def cnf_fit(mesh=None) -> tuple:
    from aspire_tpu_torch.flows import FlowMatching
    from aspire_tpu_torch.flows.train import param_leaves
    from aspire_tpu_torch.parallel import particle_sharding

    data = np.random.default_rng(3).normal(2.0, 0.5, size=(CNF_ROWS, 2))
    flow = FlowMatching(dims=2, n_hidden=(8, 8), n_steps=4, seed=3,
                        dtype="float64", device="cpu")
    history = flow.fit(data, sharding=None if mesh is None
                       else particle_sharding(mesh), **CNF_FIT)
    return ([t.detach().clone() for t in param_leaves(flow.params)],
            history.training_loss, history.validation_loss,
            flow.generator.get_state().clone())


def _logged(fn) -> tuple:
    """``(what fn raised or None, the warnings it logged)``."""
    lines = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger("aspire_tpu_torch")
    log.addHandler(handler)
    try:
        fn()
        raised = None
    except Exception as err:  # noqa: BLE001 - recorded for the test
        raised = (type(err).__name__, str(err))
    finally:
        log.removeHandler(handler)
    return raised, lines


def _rank_job(rank: int, size: int, folder: str) -> None:
    """One rank: the SMC cases, PT and the CNF's fit; on two ranks the
    standalone samplers and PT's multi-process rules. Saved to
    ``folder/out{rank}.pt``."""
    torch.set_num_threads(1)
    M.initialize_distributed(num_processes=size, process_id=rank,
                             backend="gloo",
                             init_method=f"file://{folder}/rdv")
    mesh = M.make_mesh(device="cpu")
    asp = fitted_aspire()
    out, counts = {}, {}

    def counted(name, fn):
        M.reset_collective_counts()
        out[name] = fn()
        counts[name] = dict(M.collective_counts)

    for case in SMC:
        counted(case, lambda: smc_case(asp, case, mesh))
    counted("ptmcmc", lambda: mcmc_run(asp, "ptmcmc", mesh, **PT))
    out["cnf"] = cnf_fit(mesh)
    if size == 2:
        for name, kwargs in STANDALONE.items():
            counted(name, lambda: mcmc_run(asp, name, mesh, **kwargs))
        out["pt_resume"] = _logged(lambda: mcmc_run(
            asp, "ptmcmc", mesh, resume_from=f"{folder}/none.h5", **PT))
        out["pt_state"] = _logged(lambda: mcmc_run(
            asp, "ptmcmc", mesh, checkpoint_file_path=f"{folder}/pt.h5",
            state_checkpoint_every=1, **PT))
    out["counts"] = counts
    torch.save(out, f"{folder}/out{rank}.pt")


@pytest.fixture(scope="module")
def one_process():
    asp = fitted_aspire()
    out = {case: smc_case(asp, case) for case in SMC}
    out["ptmcmc"] = mcmc_run(asp, "ptmcmc", **PT)
    for name, kwargs in STANDALONE.items():
        out[name] = mcmc_run(asp, name, **kwargs)
    out["cnf"] = cnf_fit()
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for size in RANKS:
        folder = tmp_path_factory.mktemp(f"mesh_samplers{size}")
        M.spawn_ranks(_rank_job, size, (size, str(folder)), timeout=600)
        out[size] = [torch.load(folder / f"out{r}.pt", weights_only=False)
                     for r in range(size)]
    return out


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), key
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("case", SMC)
def test_population_moves_on_a_mesh_equal_one_process(jobs, one_process,
                                                      case, size):
    """``emcee_smc`` on both ladders and ``nuts_smc`` (host ladder) on 2 and
    4 ranks: on every rank the one-process run's betas, log Z, population,
    evaluations, acceptances and generator state; the stretch move's
    gathers and NUTS's integer all-reduces counted."""
    for r in jobs[size]:
        _same(r[case], one_process[case])
        counts = r["counts"][case]
        assert counts.get("all_gather_rows", 0) > 0
        if case == "nuts_smc":
            assert counts.get("all_reduce", 0) > 0


@pytest.mark.parametrize("size", RANKS)
def test_pt_walker_sharded_equals_one_process(jobs, one_process, size):
    """Parallel tempering with its walkers sharded over 2 and 4 ranks: on
    every rank the one-process chain, densities, move and swap
    acceptances, evaluations and generator state; a gather of the walkers
    a half-move and the counts all-reduced (the walkers were sharded)."""
    for r in jobs[size]:
        _same(r["ptmcmc"], one_process["ptmcmc"])
        counts = r["counts"]["ptmcmc"]
        moves = PT["n_steps"]
        assert counts.get("all_gather_rows", 0) >= 2 * moves
        assert counts.get("all_reduce", 0) >= moves


@pytest.mark.parametrize("name", STANDALONE)
def test_standalone_sampler_on_two_ranks_is_the_one_process_run(
        jobs, one_process, name):
    """``minipcn`` (tpCN) and ``emcee`` on two ranks: every rank runs the
    whole ensemble, the one-process run bit for bit, with no collective."""
    for r in jobs[2]:
        _same(r[name], one_process[name])
        assert r["counts"][name] == {}


def _jax_pt(monkeypatch, **sample) -> tuple:
    """The JAX package's PT on two processes (its process count set to 2)
    at a tiny size: what it raised and the warnings it logged."""
    import jax

    from aspire_tpu.samplers.mcmc import ParallelTemperedSampler as JPT

    monkeypatch.setattr(jax, "process_count", lambda: 2)

    def ll(x):
        return -0.5 * (x.x ** 2).sum(-1)

    sampler = JPT(ll, ll, 2, prior_flow=None, dtype="float64", rng=1)
    x0 = np.random.default_rng(0).normal(size=(2 * 8, 2))
    lines = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger("aspire_tpu")
    log.addHandler(handler)
    try:
        sampler.sample(8, n_steps=2, betas=np.array([1.0, 0.0]),
                       _init_x=x0, **sample)
        raised = None
    except ValueError as err:
        raised = ("ValueError", str(err))
    finally:
        log.removeHandler(handler)
    return raised, lines


def test_pt_resume_on_two_processes_raises_the_jax_error(jobs, monkeypatch,
                                                         tmp_path):
    """PT's ``resume_from`` on two processes: the JAX package's
    ``ValueError``, in its words, on every rank."""
    want, _ = _jax_pt(monkeypatch, resume_from=str(tmp_path / "none.h5"))
    for r in jobs[2]:
        assert r["pt_resume"][0] == want


def test_pt_midrun_state_on_two_processes_warns_as_jax(jobs, monkeypatch,
                                                       tmp_path):
    """Mid-run PT states on two processes: skipped with the JAX package's
    warning on every rank, the run finishing (its chain the one-process
    run's: PT's draws do not depend on the states)."""
    pytest.importorskip("h5py")
    _, want = _jax_pt(monkeypatch, checkpoint_file_path=str(
        tmp_path / "pt.h5"), state_checkpoint_every=1)
    midrun = [m for m in want if "Mid-run" in m]
    assert len(midrun) == 1
    for r in jobs[2]:
        raised, lines = r["pt_state"]
        assert raised is None
        assert [m for m in lines if "Mid-run" in m] == midrun


@pytest.mark.parametrize("size", RANKS)
def test_cnf_data_parallel_fit_matches_one_process(jobs, one_process, size):
    """The CNF's fit over 2 and 4 ranks (its loss drawn at the global
    batch's shape, each rank keeping its rows): the parameters the same
    bits on every rank, and within rtol 1e-8 of the one-process fit with
    both loss histories; the flow's generator in the one-process fit's
    state."""
    first = jobs[size][0]["cnf"]
    for r in jobs[size][1:]:
        assert all(torch.equal(a, b) for a, b in zip(first[0], r["cnf"][0]))
    params, train, val, gen = first
    want_params, want_train, want_val, want_gen = one_process["cnf"]
    for got, want in zip(params, want_params):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_allclose(train, want_train, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(val, want_val, rtol=1e-8, atol=1e-10)
    assert torch.equal(gen, want_gen)
