"""Checkpoint and resume of the device ladder on the card
(``chip_smoke.checkpoint_checks`` at n = 8192).

Marked ``gpu``: it skips without a CUDA device (the ladder's graph exists
only there) and runs on the H100 with ``python -m pytest --noconftest
tests/test_torch_checkpoint_gpu.py`` (that machine has no JAX, which
``tests/conftest.py`` imports).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianMixtureProblem

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("chain,need", [
    ({}, {"chain": 1}),
    ({"fused_chain": False}, {"coupling": chip_smoke.CHAIN_STEPS + 2}),
], ids=["fused_kernel", "split"])
def test_device_ladder_checkpoints_and_resumes_in_memory(cuda, chain, need):
    """Every rung's state handed over between replays changes nothing of
    the run (the same bits, launches and replays, one captured graph); the
    middle state's bytes resume on both ladders into one population with
    the state's history as the prefix; the last state skips the loop."""
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow_backend="nsf", architecture="nsf-tpu", seed=1,
                 device=cuda)
    asp.fit(init, n_epochs=2, batch_size=256, learning_rate=3e-3)
    run = dict(sampler="smc", n_samples=8192, store_sample_history=False,
               sampler_kwargs=dict(n_steps=chip_smoke.CHAIN_STEPS, **chain))
    out = chip_smoke.checkpoint_checks(asp, run, need)
    assert out["same_bits"] and out["one_ladder"]
    assert out["replays"] == [out["rungs"], out["rungs"]]
    assert out["resume"]["ladders_same_bits"]
    assert not any(out["resume_last"]["launches"].values())
