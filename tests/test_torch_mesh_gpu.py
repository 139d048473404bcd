"""The mesh on the card: every kernel wrapper on its tensors' card (C18),
the device ladder's rung captured with its NCCL collectives at world size
1, and a checkpoint and resume on that mesh.

Marked ``gpu``: they skip without a CUDA device (the two-card check with
fewer than two cards) and run on the H100 with ``python -m pytest
--noconftest tests/test_torch_mesh_gpu.py`` (that machine has no JAX,
which ``tests/conftest.py`` imports).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.parallel import mesh as M

pytestmark = pytest.mark.gpu

N = 8192


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the graph exist "
                    "only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group in this process and its mesh."""
    M.initialize_distributed(num_processes=1, process_id=0, backend="nccl",
                             init_method=f"file://{tmp_path}/rdv")
    try:
        yield M.make_mesh()
    finally:
        import torch.distributed as dist

        # A plain teardown, with the test's captured ladders alive: the
        # mesh releases their graphs first (ROADMAP C19).
        dist.destroy_process_group()


def _aspire(device):
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow_backend="nsf", architecture="nsf-tpu", seed=1,
                 device=device)
    asp.fit(init, n_epochs=2, batch_size=256, learning_rate=3e-3)
    return asp


RUN = dict(device_ladder=True, sampler_kwargs=dict(
    n_steps=chip_smoke.CHAIN_STEPS, fused_chain=False))


def _run(asp, mesh=None, impl="auto", **sample):
    sampler = asp.init_sampler("smc", mesh=mesh, resampling_impl=impl)
    post = sampler.sample(N, **RUN, **sample)
    return sampler, {"x": post.x.cpu(), "log_z": post.log_evidence,
                     "beta": list(sampler.history.beta),
                     "generator": sampler.generator.get_state().cpu()}


def _same(a: dict, b: dict) -> bool:
    return (a["log_z"] == b["log_z"] and a["beta"] == b["beta"]
            and torch.equal(a["x"], b["x"])
            and torch.equal(a["generator"], b["generator"]))


def test_every_wrapper_launches_on_its_tensors_card(cuda):
    """C18 (``chip_smoke.two_card_check``): each kernel on ``cuda:1``
    tensors while ``cuda:0`` is current gives the bits of the same call on
    ``cuda:0``, one launch each."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from aspire_tpu_torch.ops import _build

    _build.build()
    _build.load_library()
    out = chip_smoke.two_card_check()
    assert all(v["same_bits"] for v in out.values())


def test_captured_rung_with_nccl_collectives(nccl_mesh):
    """The device ladder on a one-rank NCCL mesh, for each resampling
    impl: its rung captured, with its collectives in the graph (counted at
    each replay), the one-process device ladder's bits, 22 B1 a rung, the
    initial draw's B3 and no B2."""
    asp = _aspire(nccl_mesh.device)
    _run(asp)
    _, want = _run(asp)
    for impl in chip_smoke.MESH_IMPLS:
        _run(asp, nccl_mesh, impl)  # its capture
        chip_smoke.reset_launch_counts()
        M.reset_collective_counts()
        sampler, got = _run(asp, nccl_mesh, impl)
        rungs = len(sampler.history.beta)
        assert sampler.ladder.mode == "captured"
        assert sampler.ladder.graph is not None
        counts = chip_smoke.launch_counts()
        assert (counts["coupling"], counts["chain"]) == (
            (chip_smoke.CHAIN_STEPS + 2) * rungs + 1, 0)
        assert M.collective_counts["all_gather_rows"] >= rungs
        assert _same(got, want), impl


def test_checkpoint_and_resume_on_a_one_rank_nccl_mesh(nccl_mesh):
    """A checkpoint a rung (in memory) on the one-rank NCCL mesh's device
    ladder changes nothing of the run; resumed from rung 3's state the run
    gives the bits of the one-process run resumed from its own."""
    asp = _aspire(nccl_mesh.device)
    states, one = [], []
    _, plain = _run(asp, nccl_mesh)
    _, run = _run(asp, nccl_mesh, checkpoint_callback=states.append)
    _, single = _run(asp, checkpoint_callback=one.append)
    assert _same(run, plain) and _same(run, single)
    assert [s["iteration"] for s in states] == [s["iteration"] for s in one]
    _, resumed = _run(asp, nccl_mesh, resume_from=states[2])
    _, want = _run(asp, resume_from=one[2])
    assert _same(resumed, want)
