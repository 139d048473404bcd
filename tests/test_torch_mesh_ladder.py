"""The device ladder on a mesh of gloo ranks (float64, the CPU) against the
one-process device-ladder run, the all-to-all's overflow decided on the
device, and log Z beside the JAX package's device ladder on its 8-device
CPU mesh.

The rung on a mesh gathers the densities for the statistics, draws the
global index on every rank, moves the rows by ``resampling_impl`` and runs
the split chain over the mesh, so it is held to the one-process device
ladder bit for bit: the betas, log Z, the returned population on every rank
and the generator's state. On the CPU (and over gloo on the card) the rung
runs eagerly (``DeviceLadder.mode == "eager"``); its capture over NCCL is
held on the card (``tests/test_torch_mesh_gpu.py``, ``chip_smoke.py``).

Each rank count (2 and 4) is one job of ``spawn`` processes for the module
that runs every case and saves its results; each test reads one. The rank
function sits here at the top level; JAX is imported by the tests only.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from aspire_tpu_torch.parallel import mesh as M

RANKS = (2, 4)
N = 128
STEPS = 4
IMPLS = ("auto", "ring", "alltoall")
FLOW = dict(flow_backend="nsf", n_hidden=(8, 8), n_layers=2)
#: (sampler, sampler_kwargs) of each device-ladder case, each run under
#: every resampling_impl
SAMPLERS = {
    "tpcn": ("smc", {}),
    "rwmh": ("rwmh_smc", {}),
    "mala": ("mala_smc", {}),
    "waste_free": ("smc", {"waste_free": True}),
    # 20 walkers spread over the 128 rows: the subset crosses the ranks
    "windowed_tau": ("smc", {"windowed_tau": True, "tau_walkers": 20}),
    "flow_moves": ("smc", {"flow_moves": 3}),
}
CASES = [(s, impl) for s in SAMPLERS for impl in IMPLS]
#: a high target efficiency, for a ladder of several rungs at this size
TARGET_EFF = 0.9
#: the overflow check: the all-to-all's bucket, below a rank's rows
CAP = 8


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


def run_case(asp, case: tuple, mesh=None) -> dict:
    """One device-ladder run of ``case`` (sampler, impl), on ``mesh`` with
    that ``resampling_impl``; its betas, log Z, population, generator
    state, evaluations, tau, routes and the ladder's mode."""
    name, impl = case
    sampler, kwargs = SAMPLERS[name]
    on_mesh = {} if mesh is None else dict(mesh=mesh, resampling_impl=impl)
    post, hist = asp.sample_posterior(
        sampler=sampler, n_samples=N, return_history=True,
        device_ladder=True, target_efficiency=TARGET_EFF,
        sampler_kwargs=dict(n_steps=STEPS, **kwargs), **on_mesh)
    s = asp.sampler
    return {"beta": list(hist.beta), "log_z": post.log_evidence,
            "log_z_err": post.log_evidence_error, "x": post.x.clone(),
            "log_l": post.log_likelihood.clone(),
            "generator": s.generator.get_state().clone(),
            "evals": s.n_likelihood_evaluations,
            "tau": list(hist.mcmc_autocorr),
            "acc": list(hist.mcmc_acceptance),
            "routes": sorted(set(hist.mutation_route)),
            "mode": s.ladder.mode, "particle_steps": s.particle_steps}


def overflow_check(mesh) -> dict:
    """The all-to-all inside a rung (``on_device=True``) at a bucket of CAP
    rows: an index of one row (all weight on it) overflows and the
    device-side flag selects the ring's rows; an index that takes each
    destination's rows evenly from every source does not, and the buckets'
    rows stand. Both against ``x[idx]`` of the whole population."""
    from aspire_tpu_torch.ops import resampling as R

    n = 16 * mesh.size
    x = torch.arange(2 * n, dtype=torch.float64).reshape(n, 2)
    j = torch.arange(n)
    out = {}
    for name, idx in (
            ("one_row", R.systematic_resample(None, torch.where(
                j == 3, 50.0, -50.0).double(), u=0.5)),
            # row j from rank j % S: n / S^2 <= CAP rows a pair
            ("spread", (j % mesh.size) * 16 + j // mesh.size)):
        rows, flag = R.alltoall_move(idx, mesh.local_rows(x), mesh, cap=CAP,
                                     on_device=True)
        out[name] = (bool(torch.equal(M.all_gather_rows(rows, mesh),
                                      x[idx])), flag.clone())
    return out


def _rank_job(rank: int, size: int, folder: str) -> None:
    """One rank: every case on the device ladder and the overflow check,
    saved to ``folder/out{rank}.pt``."""
    torch.set_num_threads(1)
    M.initialize_distributed(num_processes=size, process_id=rank,
                             backend="gloo",
                             init_method=f"file://{folder}/rdv")
    mesh = M.make_mesh(device="cpu")
    asp = fitted_aspire()
    out = {case: run_case(asp, case, mesh) for case in CASES}
    out["overflow"] = overflow_check(mesh)
    torch.save(out, f"{folder}/out{rank}.pt")


@pytest.fixture(scope="module")
def one_process():
    """Each sampler's device-ladder run in one process, no mesh."""
    asp = fitted_aspire()
    return {name: run_case(asp, (name, "auto")) for name in SAMPLERS}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for size in RANKS:
        folder = tmp_path_factory.mktemp(f"mesh_ladder{size}")
        M.spawn_ranks(_rank_job, size, (size, str(folder)), timeout=600)
        out[size] = [torch.load(folder / f"out{r}.pt", weights_only=False)
                     for r in range(size)]
    return out


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_mesh_device_ladder_equals_one_process(jobs, one_process, case,
                                               size):
    """On every rank: the one-process device ladder's betas, log Z (the
    same bits), population, evaluations, taus, acceptances and particle
    steps, and the generator's state after the run; the split route; the
    rung eager on the CPU."""
    want = one_process[case[0]]
    for r in jobs[size]:
        got = r[case]
        assert got["beta"] == want["beta"]
        assert got["log_z"] == want["log_z"]
        assert got["log_z_err"] == want["log_z_err"]
        assert torch.equal(got["x"], want["x"])
        assert torch.equal(got["log_l"], want["log_l"])
        assert torch.equal(got["generator"], want["generator"])
        for key in ("evals", "tau", "acc", "particle_steps"):
            assert got[key] == want[key], key
        assert got["routes"] == ["split"] and got["mode"] == "eager"


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("index", ["one_row", "spread"])
def test_rung_overflow_selected_on_the_device(jobs, size, index):
    """``alltoall_move(..., cap=CAP, on_device=True)``: a 0-d flag on the
    device, set where a (source, destination) pair passes the bucket
    (one row's index) and not where none does (a spread index); the rows
    are ``x[idx]`` either way, on every rank."""
    for r in jobs[size]:
        equal, flag = r["overflow"][index]
        assert equal
        assert flag.dim() == 0 and flag.dtype == torch.bool
        assert bool(flag) == (index == "one_row")


@pytest.fixture(scope="module")
def jax_ring_log_z():
    """The JAX package's device ladder on its 8-device CPU mesh with
    ``resampling_impl="ring"``: the 2-d mixture, a small nsf flow fitted to
    the same draws, 256 particles (the JAX package's ladder on the mesh),
    tpCN at 4 steps; log Z and its error."""
    import jax

    from aspire_tpu.flows import Flow
    from aspire_tpu.models import GaussianMixtureProblem
    from aspire_tpu.parallel.mesh import make_mesh
    from aspire_tpu.samplers import PCNSMC

    p = GaussianMixtureProblem(dims=2)
    flow = Flow(dims=2, architecture="nsf", key=1, n_layers=2,
                n_hidden=(8, 8))
    flow.fit(p.draw_initial_samples(np.random.default_rng(0), 512),
             n_epochs=2, batch_size=128)
    sampler = PCNSMC(log_likelihood=p.log_likelihood,
                     log_prior=p.log_prior, dims=2, prior_flow=flow,
                     parameters=p.parameters, rng=jax.random.key(5),
                     mesh=make_mesh(8), resampling_impl="ring")
    post = sampler.sample(256, device_ladder=True,
                          sampler_kwargs={"n_steps": STEPS})
    return float(post.log_evidence), float(post.log_evidence_error)


def test_ring_log_z_beside_the_jax_device_ladder(jobs, jax_ring_log_z):
    """The port's mesh device ladder (tpCN, ring) on 4 ranks and the JAX
    package's on its 8-device mesh agree on log Z within max(5 combined
    sigma, 0.15): the two packages' draws differ, their estimates must
    not."""
    got = jobs[4][0][("tpcn", "ring")]
    want, want_err = jax_ring_log_z
    tol = max(5 * math.hypot(got["log_z_err"], want_err), 0.15)
    assert abs(got["log_z"] - want) < tol
