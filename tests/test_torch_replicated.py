"""``Flow.reinitialize`` and ``Aspire.replicated_evidence`` of the port
against the JAX package, at a small size (two layers, width 8, n = 256):
a re-initialised flow is a new flow at that seed, bit for bit; the
replicate tier equals that many solo reinitialize -> fit -> sample
pipelines bit for bit (SMC by its log Z, PT by its stepping stone), its
combination equals the JAX package's ``combine_replicates``, it raises
where the JAX package raises and it leaves a run file's fitted flow as it
was."""

import types

import h5py
import jax
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu.flows.base import Flow as JFlow
from aspire_tpu.flows.matching import FlowMatching as JFlowMatching
from aspire_tpu.samplers.base import combine_replicates as jcombine
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.flows.base import Flow
from aspire_tpu_torch.flows.matching import FlowMatching
from aspire_tpu_torch.flows.train import param_leaves
from aspire_tpu_torch.models import GaussianMixtureProblem
from aspire_tpu_torch.samplers.base import combine_replicates
from aspire_tpu_torch.utils import flow_matching_from_jax, flow_params_from_jax

torch.set_num_threads(1)

SMALL = dict(n_layers=2, n_hidden=(8, 8))
#: each flow kind of the port (``seed`` and keywords to its constructor)
#: and of the JAX package (``key``), at float64 for the density check
FLOWS = {
    "coupling": (lambda **kw: Flow(dims=3, architecture="nsf", **SMALL,
                                   device="cpu", **kw),
                 lambda key: JFlow(dims=3, architecture="nsf", key=key,
                                   dtype="float64", **SMALL)),
    "maf": (lambda **kw: Flow(dims=3, architecture="maf", **SMALL,
                              device="cpu", **kw),
            lambda key: JFlow(dims=3, architecture="maf", key=key,
                              dtype="float64", **SMALL)),
    "cnf": (lambda **kw: FlowMatching(dims=3, n_hidden=(8, 8), n_steps=4,
                                      device="cpu", **kw),
            lambda key: JFlowMatching(dims=3, n_hidden=(8, 8), n_steps=4,
                                      key=key, dtype="float64")),
}
FIT = dict(n_epochs=2, batch_size=128)
RUNS = {"smc": dict(sampler="smc", n_samples=256,
                    sampler_kwargs=dict(n_steps=4)),
        "ptmcmc": dict(sampler="ptmcmc", n_samples=64, n_steps=6,
                       n_temperatures=3)}


def _same_flow(a, b) -> None:
    """Bit-equal parameters and generator state."""
    la, lb = param_leaves(a.params), param_leaves(b.params)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_reinitialize_is_a_new_flow_at_that_seed(kind):
    """An ``int``: the parameters and generator state of ``Flow(seed=s)``,
    on the same object, in new tensors."""
    make, _ = FLOWS[kind]
    flow = make(seed=0)
    flow.fit(np.random.default_rng(0).normal(size=(64, 3)), n_epochs=1,
             batch_size=32)
    old = param_leaves(flow.params)
    same = flow
    flow.reinitialize(7)
    assert flow is same
    _same_flow(flow, make(seed=7))
    assert not any(a is b for a, b in zip(old, param_leaves(flow.params)))


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_reinitialize_without_a_seed_takes_it_from_the_generator(kind):
    make, _ = FLOWS[kind]
    flow = make(seed=3)
    draw = torch.Generator().set_state(flow.generator.get_state())
    seed = int(torch.randint(0, 2**63 - 1, (), generator=draw))
    before = param_leaves(flow.params)
    flow.reinitialize()
    _same_flow(flow, make(seed=seed))
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, param_leaves(flow.params)))


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_reinitialized_jax_flow_has_the_same_density(kind):
    """The JAX flow re-initialised at a seed, its weights carried across by
    the converters: the two densities agree in float64."""
    make, jmake = FLOWS[kind]
    jflow = jmake(0)
    jflow.reinitialize(11)
    if kind == "cnf":
        flow = flow_matching_from_jax(jflow, dtype="float64")
    else:
        flow = make(dtype="float64")
        flow.params = flow_params_from_jax(jflow.params, dtype="float64")
    x = np.random.default_rng(2).normal(size=(50, 3))
    np.testing.assert_allclose(flow.log_prob(x).numpy(),
                               np.asarray(jflow.log_prob(x)), rtol=0,
                               atol=1e-10)


def _problem():
    p = GaussianMixtureProblem(dims=2)
    return p, Samples(p.draw_initial_samples(np.random.default_rng(0), 512))


def _aspire(p, seed=3):
    return Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                  dims=2, seed=seed, device="cpu", flow_backend="nsf",
                  **SMALL)


#: (call, exception, message) of each refused call, on an unfitted Aspire
REFUSALS = {
    "one replicate": (lambda a: a.replicated_evidence(1), ValueError,
                      ">= 2"),
    "no prior fit": (lambda a: a.replicated_evidence(2), ValueError,
                     "prior fit"),
    "nested tier": (lambda a: a.replicated_evidence(2, n_replicates=2),
                    TypeError, None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_replicated_evidence_refuses_as_jax(case):
    call, exc, match = REFUSALS[case]
    p = GaussianMixtureProblem(dims=2)
    jasp = JAspire(log_likelihood=lambda s: None, log_prior=lambda s: None,
                   dims=2)
    with pytest.raises(exc, match=match):
        call(jasp)
    with pytest.raises(exc, match=match):
        call(_aspire(p))


@pytest.mark.parametrize("sampler", sorted(RUNS))
def test_replicates_equal_solo_pipelines(sampler):
    """Replicate r is the pipeline ``reinitialize(seed + 101 + r)``, fit,
    sample on a flow of its own, bit for bit (PT read by its stepping
    stone); the combination is the JAX package's; ``asp.flow`` is the same
    object with replicate k's parameters."""
    p, init = _problem()
    asp = _aspire(p)
    asp.fit(init, **FIT)
    flow = asp.flow
    post = asp.replicated_evidence(3, fit_kwargs=FIT, **RUNS[sampler])
    assert asp.flow is flow
    solo = []
    for r in range(3):
        one = _aspire(p)
        one.init_flow()
        one.flow.reinitialize(3 + 101 + r)
        one.fit(init, **FIT)
        s = one.sample_posterior(**RUNS[sampler])
        solo.append((s.log_evidence_stepping_stone() if sampler == "ptmcmc"
                     else (s.log_evidence, s.log_evidence_error)))
    _same_flow(asp.flow, one.flow)
    np.testing.assert_array_equal(post.log_evidence_replicates,
                                  [lz for lz, _ in solo])
    assert np.std(post.log_evidence_replicates) > 0
    want = jcombine(types.SimpleNamespace(), [lz for lz, _ in solo],
                    [err for _, err in solo], "pipeline")
    for name in ("log_evidence", "log_evidence_error",
                 "log_evidence_error_single"):
        assert getattr(post, name) == pytest.approx(getattr(want, name),
                                                    rel=0, abs=1e-12)


@pytest.mark.parametrize("errs", [[0.05, 0.06, 0.04], [0.001, 0.002, 0.001]])
def test_combination_matches_jax(errs):
    """Both branches of the rule: replicates consistent with their errors
    and scattered beyond them."""
    logzs = [-4.41, -4.47, -4.52]
    want = jcombine(types.SimpleNamespace(), logzs, errs, "pipeline")
    got = combine_replicates(types.SimpleNamespace(), logzs, errs,
                             "pipeline")
    for name in ("log_evidence", "log_evidence_error",
                 "log_evidence_error_single"):
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=0, abs=1e-12)
    np.testing.assert_array_equal(got.log_evidence_replicates,
                                  want.log_evidence_replicates)


def test_without_refit_the_replicates_rerun_one_flow():
    p, init = _problem()
    asp = _aspire(p)
    asp.fit(init, **FIT)
    before = [t.clone() for t in param_leaves(asp.flow.params)]
    post = asp.replicated_evidence(2, refit_flow=False, **RUNS["smc"])
    assert post.log_evidence_replicates[0] == post.log_evidence_replicates[1]
    assert all(torch.equal(a, b)
               for a, b in zip(before, param_leaves(asp.flow.params)))


def test_replicated_evidence_keeps_the_checkpointed_flow(tmp_path):
    """The refits are diagnostic: within ``auto_checkpoint`` the file's
    fitted flow is unchanged byte for byte (the in-memory flow is refit),
    and the policy is back after the call."""
    p, init = _problem()
    path = str(tmp_path / "run.h5")
    asp = _aspire(p)

    def flow_bytes():
        chunks = []
        with h5py.File(path, "r") as f:
            f["flow"].visititems(
                lambda name, obj: chunks.append(np.asarray(obj[()]).tobytes())
                if isinstance(obj, h5py.Dataset) else None)
        return b"".join(chunks)

    with asp.auto_checkpoint(path):
        asp.fit(init, **FIT)
        before = flow_bytes()
        policy = asp._checkpoints
        fitted = [t.clone() for t in param_leaves(asp.flow.params)]
        post = asp.replicated_evidence(2, fit_kwargs=FIT, sampler="importance",
                                       n_samples=64)
        assert post.log_evidence_replicates.shape == (2,)
        assert asp._checkpoints is policy
        assert flow_bytes() == before
        assert not all(torch.equal(a, b) for a, b in
                       zip(fitted, param_leaves(asp.flow.params)))
