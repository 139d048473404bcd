"""The JAX package's validation rows end to end in the port, on the CPU.

Rosenbrock at d = 2 and Neal's funnel at d = 5 (``benchmarks/validate.py``'s
rows, as ``tests/test_torch_validate.py`` holds their pieces): each row's
SMC on the JAX package's fitted flow and data transform carried across
(``flow_params_from_jax``, ``transform_from_jax``), against the JAX
package's SMC on the same flow; and both ladders of a bounded split-route
run giving one run bit for bit. Flows are nsf-tpu cut to 2 layers of
(16, 16) hidden units, fitted for 5 epochs, so the tests stay quick.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu import Aspire as JAspire
from aspire_tpu import Samples as JSamples
from aspire_tpu.models import targets as JTG
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.flows import Flow
from aspire_tpu_torch.models import RosenbrockProblem, get_problem
from aspire_tpu_torch.transforms import FlowTransform
from aspire_tpu_torch.utils import flow_params_from_jax, transform_from_jax

torch.set_num_threads(1)

ROWS = {"rosenbrock": 2, "funnel": 5}
SLICE_N, SLICE_STEPS = 2048, 8
SLICE_FLOW = dict(flow_backend="nsf", architecture="nsf-tpu",
                  n_hidden=(16, 16), n_layers=2)


@pytest.fixture(scope="module")
def jax_fits():
    out = {}
    for name, d in ROWS.items():
        p = JTG.get_problem(name, dims=d)
        init = JSamples(p.draw_initial_samples(np.random.default_rng(0),
                                               4096))
        asp = JAspire(log_likelihood=p.log_likelihood,
                      log_prior=p.log_prior, dims=d,
                      prior_bounds=p.prior_bounds, seed=1, **SLICE_FLOW)
        asp.fit(init, n_epochs=5, batch_size=256)
        out[name] = asp
    return out


def _port(jax_fits, name: str, seed: int = 1):
    """The port's ``Aspire`` on the JAX package's fitted flow of the row."""
    d = ROWS[name]
    p = get_problem(name, dims=d)
    jflow = jax_fits[name].flow
    flow = Flow(dims=d, architecture="nsf-tpu", n_layers=2, n_hidden=(16, 16),
                data_transform=transform_from_jax(jflow.data_transform,
                                                  dtype="float32"),
                device="cpu")
    flow.params = flow_params_from_jax(jflow.params, dtype="float32")
    return Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=d, flow=flow, prior_bounds=p.prior_bounds, seed=seed,
                  device="cpu", **SLICE_FLOW)


def _smc(asp, n: int):
    return asp.sample_posterior(sampler="smc", n_samples=n,
                                sampler_kwargs=dict(n_steps=SLICE_STEPS),
                                store_sample_history=False)


def test_rosenbrock_slice_log_evidence_matches_jax(jax_fits):
    """Rosenbrock's SMC: every mutation on the whole-chain route with its
    logit + affine program, finite samples of the expected shape, and the
    port's log Z within max(5 combined sigma, 0.15) of the JAX package's on
    the same flow."""
    asp = _port(jax_fits, "rosenbrock")
    post = _smc(asp, SLICE_N)
    assert set(asp.sampler.history.mutation_route) == {"fused_kernel"}
    assert post.x.shape == (SLICE_N, 2) and bool(torch.isfinite(post.x).all())
    jpost = _smc(jax_fits["rosenbrock"], SLICE_N)
    err, jerr = post.log_evidence_error, float(jpost.log_evidence_error)
    assert np.isfinite(post.log_evidence) and np.isfinite(err)
    assert abs(post.log_evidence - float(jpost.log_evidence)) < max(
        5 * np.hypot(err, jerr), 0.15)


def test_funnel_slice_replicates_match_jax(jax_fits):
    """The funnel's SMC, three runs a package (seeds 1-3) on the same flow,
    combined as the reference gates the funnel (``combine_replicates``,
    through ``chip_smoke.combined_log_z``):
    one run's error understates its spread on this flow (about 0.05
    against 0.25-0.3 between seeds, in both packages), so single runs are
    not compared. Every port mutation on the whole-chain route, finite
    samples; the two combined log Z within max(5 combined sigma, 0.15)."""
    n = SLICE_N // 2
    port, ref = [], []
    for seed in (1, 2, 3):
        asp = _port(jax_fits, "funnel", seed)
        post = _smc(asp, n)
        assert set(asp.sampler.history.mutation_route) == {"fused_kernel"}
        assert post.x.shape == (n, 5) and bool(torch.isfinite(post.x).all())
        port.append((post.log_evidence, post.log_evidence_error))
        jasp = jax_fits["funnel"]
        jasp.seed = seed
        jpost = _smc(jasp, n)
        ref.append((float(jpost.log_evidence),
                    float(jpost.log_evidence_error)))
    (lz, err), (jlz, jerr) = (chip_smoke.combined_log_z(*zip(*runs),
                                                        "funnel")
                              for runs in (port, ref))
    assert np.isfinite(lz) and np.isfinite(err)
    assert abs(lz - jlz) < max(5 * np.hypot(err, jerr), 0.15)


def test_bounded_split_route_ladders_agree_bit_for_bit():
    """Rosenbrock on its box, the split route (``fused_chain=False``): the
    flow's data transform takes the flow's float32 (the prior bounds came
    in float64), so its density is float32 on both ladders and the device
    ladder, whose state holds float32, repeats the host ladder bit for
    bit, as on the whole-chain route."""
    p = RosenbrockProblem(dims=2)
    init = Samples(p.draw_initial_samples(np.random.default_rng(0), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, prior_bounds=p.prior_bounds, seed=1, device="cpu",
                 **SLICE_FLOW)
    asp.fit(init, n_epochs=3, batch_size=256, learning_rate=3e-3)
    assert isinstance(asp.flow.data_transform, FlowTransform)
    assert asp.flow.data_transform.dtype == torch.float32
    assert asp.flow.log_prob(torch.zeros(3, 2)).dtype == torch.float32
    runs = {}
    for ladder in (False, True):
        runs[ladder] = asp.sample_posterior(
            sampler="smc", n_samples=512, return_history=True,
            store_sample_history=False, device_ladder=ladder,
            sampler_kwargs=dict(n_steps=4, fused_chain=False))
    (host, hh), (dev, dh) = runs[False], runs[True]
    assert set(dh.mutation_route) == set(hh.mutation_route) == {"split"}
    assert len(hh.beta) > 1 and asp.sampler.ladder is not None
    for name in ("beta", "ess", "log_norm_ratio", "mcmc_acceptance",
                 "mcmc_autocorr"):
        assert getattr(dh, name) == getattr(hh, name), name
    assert torch.equal(dev.x, host.x)
    assert dev.log_evidence == host.log_evidence
