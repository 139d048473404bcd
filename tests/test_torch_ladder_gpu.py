"""The device ladder's CUDA graph on the card (``chip_smoke.py``'s checks
at a smaller size).

Marked ``gpu``: they skip without a CUDA device (a graph exists only
there) and run on the H100 with ``python -m pytest --noconftest
tests/test_torch_ladder_gpu.py`` (that machine has no JAX, which
``tests/conftest.py`` and ``tests/test_torch_ladder.py`` import).
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


def _fitted(device):
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow_backend="nsf", architecture="nsf-tpu", seed=1,
                 device=device)
    asp.fit(init, n_epochs=2, batch_size=256, learning_rate=3e-3)
    return asp


def test_graph_replay_matches_the_eager_rung(cuda):
    """One replay of a captured rung against the eager body from the same
    state and generator state: the same random numbers and every state
    tensor the same bits (``chip_smoke.replay_check``); the kernels one
    replay runs on the card, as the profiler reads them, are the launches
    its capture counted."""
    chip_smoke._KERNEL_MS_LATER.clear()
    out = chip_smoke.phase_device_ladder_check(cuda, 8192)["replay_vs_eager"]
    assert out["random_numbers_equal"] and out["differ"] == []
    assert out["differ_between_eager_runs"] == []
    chip_smoke.read_kernel_ms()
    assert out["replay_kernels"] == out["captured_launches"]
    assert out["replay_kernels"]["chain"] == 1


def test_a_seed_repeats_the_run_on_the_card(cuda):
    """Two runs of one seed give one population on either ladder (the
    resampling's CDF sums in a fixed order), and the graph's run is the
    host ladder's."""
    asp = _fitted(cuda)
    run = dict(sampler="smc", n_samples=8192, store_sample_history=False,
               sampler_kwargs=dict(n_steps=4))
    xs = {ladder: [asp.sample_posterior(**run, device_ladder=ladder).x
                   for _ in range(2)] for ladder in (None, False)}
    for a, b in xs.values():
        assert torch.equal(a, b)
    assert torch.equal(xs[None][0], xs[False][0])


def test_the_ladder_cache_keeps_one_ladder(cuda):
    """A run with the cached ladder's key replays it; a run with another
    key replaces it, so one graph and its memory pool are kept."""
    asp = _fitted(cuda)
    run = dict(sampler="smc", store_sample_history=False,
               sampler_kwargs=dict(n_steps=4))
    asp.sample_posterior(n_samples=4096, **run)
    first = asp.sampler.ladder
    asp.sample_posterior(n_samples=4096, **run)
    assert asp.sampler.ladder is first and first.replays > 0
    asp.sample_posterior(n_samples=8192, **run)
    assert asp.sampler.ladder is not first
    assert [v[1] for v in asp.ladder_cache.values()] == [asp.sampler.ladder]


def test_a_target_that_reads_back_takes_the_host_ladder(cuda):
    out = chip_smoke.phase_uncapturable_target(cuda, 8192)
    assert out["auto"] == "host" and out["forced"] == "ValueError"


@pytest.mark.parametrize("fused_chain", ["auto", False])
def test_refitted_data_transform_recaptures(cuda, fused_chain):
    """The bounded run's ladder reads its data transform, through B2's
    program or (``fused_chain=False``) the flow's density: a second run
    with the same transform replays the cached ladder, a run after the
    transform is refitted (new mean and std tensors) captures a new one,
    which gives a freshly made ladder's population and the host ladder's,
    on both routes (the flow's data transform computes in the flow's
    float32, so the split route's densities are the same bits on both
    ladders)."""
    _, asp = chip_smoke.bounded_aspire(cuda)
    run = dict(sampler="smc", n_samples=8192, store_sample_history=False,
               sampler_kwargs=dict(n_steps=5, fused_chain=fused_chain))

    def device_run():
        post = asp.sample_posterior(**run)
        (_, ladder), = asp.ladder_cache.values()
        return post, ladder

    _, first = device_run()
    _, again = device_run()
    assert again is first
    x = asp.flow.data_transform.inverse(
        torch.randn((4000, 4), device=cuda))[0]
    asp.flow.data_transform.fit(x)
    post, refit = device_run()
    assert refit is not first
    asp.ladder_cache.clear()
    fresh, _ = device_run()
    assert torch.equal(post.x, fresh.x)
    host = asp.sample_posterior(**run, device_ladder=False)
    assert torch.equal(post.x, host.x)


def test_bounded_split_chain_is_captured(cuda):
    """A bounded run on the split chain (``fused_chain=False``, or any MAF
    flow) takes the device ladder: its data transform's masked dims index
    by device tensors, so the rung's graph captures (indexing by a numpy
    mask copied it to the card at every call, which no graph can
    capture)."""
    p, asp = chip_smoke.bounded_aspire(cuda)
    post = asp.sample_posterior(
        sampler="smc", n_samples=8192, store_sample_history=False,
        sampler_kwargs=dict(n_steps=5, fused_chain=False))
    assert asp.sampler.ladder is not None
    assert asp.sampler.ladder.graph is not None
    assert set(asp.sampler.history.mutation_route) == {"split"}
    chip_smoke.check_result(post, 8192, p.true_log_evidence)
